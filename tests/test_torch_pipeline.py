"""Twins of tests/test_pipeline.py, tests/test_katib.py and
tests/test_system.py::test_e2e_mnist_pipeline on the port's copies of
``core/pipeline.py``, ``core/experiment.py`` and ``tuning/katib.py``, plus
parity with the reference: the same authored ``Pipeline`` exports the same
YAML spec and the same cache keys, and the same Katib search with the same
seed proposes the same trials.  A tree of tensors is hashed by content
(``value_hash`` never falls back to ``"unhashable"`` for it)."""
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402

import numpy as np  # noqa: E402
import yaml  # noqa: E402

from repro.core import pipeline as jpipeline  # noqa: E402
from repro.tuning import katib as jkatib  # noqa: E402
from repro_torch.checkpoint.store import ArtifactStore, tree_hash  # noqa: E402
from repro_torch.clouds.profiles import get_profile  # noqa: E402
from repro_torch.core.experiment import Experiment  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.pipeline import Pipeline, StepRef, value_hash  # noqa: E402
from repro_torch.core.trainjob import SupervisedTrainJob  # noqa: E402
from repro_torch.data.mnist import Batches, make_dataset  # noqa: E402
from repro_torch.models import lenet  # noqa: E402
from repro_torch.serving.kserve import InferenceService, Predictor  # noqa: E402
from repro_torch.tuning import katib  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the e2e pipeline's LeNet is tiny, and one thread
    keeps it from waiting on threads other test workers hold."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def double(x):
    return x * 2


def add(a, b):
    return a + b


def seven():
    return 7


def test_topological_execution_and_outputs(tmp_path):
    p = Pipeline("t", ArtifactStore(str(tmp_path)))
    a = p.step(seven)
    b = p.step(double, a)
    c = p.step(add, a, b)
    out = p.run()
    assert out == {"seven": 7, "double": 14, "add": 21}


def test_dependency_order_independent_of_declaration(tmp_path):
    p = Pipeline("t2", ArtifactStore(str(tmp_path)))
    # declare consumer first via forward ref
    a = p.step(seven)
    c_ref = StepRef  # noqa: just to show refs are plain handles
    b = p.step(double, a)
    out = p.run()
    assert out["double"] == 14


def test_cycle_detection():
    p = Pipeline("cyc")
    a = p.step(double, StepRef("b", 1))
    b = p.step(double, StepRef("a", 0))
    with pytest.raises(ValueError, match="cycle"):
        p.run()


def test_step_caching_across_runs(tmp_path):
    store = ArtifactStore(str(tmp_path))

    def build():
        p = Pipeline("cached", store)
        a = p.step(seven)
        b = p.step(double, a)
        return p

    p1 = build()
    p1.run()
    assert [s.cached for s in p1.steps] == [False, False]
    p2 = build()
    out = p2.run()
    assert [s.cached for s in p2.steps] == [True, True]
    assert out["double"] == 14


def test_cache_invalidated_by_input_change(tmp_path):
    store = ArtifactStore(str(tmp_path))
    p1 = Pipeline("inv", store)
    p1.step(double, 3, name="d")
    assert p1.run()["d"] == 6
    p2 = Pipeline("inv", store)
    p2.step(double, 4, name="d")
    assert p2.run()["d"] == 8          # not the stale cached 6
    assert p2.steps[0].cached is False


def test_yaml_spec_roundtrip(tmp_path):
    p = Pipeline("spec-test", ArtifactStore(str(tmp_path)))
    a = p.step(seven)
    b = p.step(double, a)
    spec = yaml.safe_load(p.export_yaml())
    assert spec["kind"] == "Pipeline"
    assert spec["metadata"]["name"] == "spec-test"
    steps = spec["spec"]["steps"]
    assert steps[1]["dependencies"] == ["seven"]


def test_stage_timing_recorded(tmp_path):
    p = Pipeline("timed", ArtifactStore(str(tmp_path)))
    p.step(seven)
    p.run()
    names = [e["name"] for e in p.log.events]
    assert "seven" in names and "pipeline:timed" in names


def test_same_function_steps_get_numbered_names(tmp_path):
    """Two steps built from the same function must not share a name (the
    pre-fix {name: output} dict dropped the earlier output)."""
    p = Pipeline("dup", ArtifactStore(str(tmp_path)))
    a = p.step(seven)
    b = p.step(double, a)
    p.step(double, b)
    assert [s.name for s in p.steps] == ["seven", "double", "double_2"]
    out = p.run()
    assert out["double"] == 14 and out["double_2"] == 28


def test_step_name_suffix_never_collides_with_explicit_name(tmp_path):
    """Regression (fails pre-fix): the generated dedup suffix used the step
    COUNT without re-checking, so it could silently collide with an
    explicit name ('double_2' here) and drop an output."""
    p = Pipeline("collide", ArtifactStore(str(tmp_path)))
    p.step(seven, name="double_2")
    p.step(double, 3)
    p.step(double, 4)
    names = [s.name for s in p.steps]
    assert len(set(names)) == len(names), names
    out = p.run()
    assert len(out) == 3
    assert out["double_2"] == 7 and out["double"] == 6
    assert out["double_3"] == 8


def test_toposort_deterministic_insertion_order():
    from repro_torch.core.pipeline import toposort

    p = Pipeline("order")
    refs = [p.step(seven, name=f"s{i}") for i in range(5)]
    p.step(add, refs[4], refs[0], name="sink")
    # independent steps run in insertion-index order, every time
    assert p._toposort() == [0, 1, 2, 3, 4, 5]
    # diamond: children unlock in insertion order (deque FIFO)
    assert toposort([[], [0], [0], [1, 2]]) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="cycle"):
        toposort([[1], [0]])


def test_compile_lowers_to_pipeline_spec():
    p = Pipeline("c")
    a = p.step(seven)
    p.step(double, a, sim_s=0.5, pin="gcp")
    spec = p.compile()
    assert [s.name for s in spec.steps] == ["seven", "double"]
    assert spec.steps[1].deps == (0,)
    assert spec.steps[1].sim_s == 0.5 and spec.steps[1].pin == "gcp"
    d = spec.to_dict()
    assert d["spec"]["steps"][1]["dependencies"] == ["seven"]


def test_serial_and_compiled_cache_keys_agree(tmp_path):
    """The serial executor and the orchestrator share step_cache_key: a
    step cached by Pipeline.run is a hit for an orchestrator run."""
    from repro_torch.core.pipeline import step_cache_key

    store = ArtifactStore(str(tmp_path))
    p = Pipeline("shared", store)
    p.step(double, 5, name="d")
    p.run()
    spec = p.compile()
    s = spec.steps[0]
    key = step_cache_key(spec.name, s.name, s.fn, (5,), {})
    assert store.exists(key)
    assert store.load_json(key)["value"] == 10


# -- Katib (twin of tests/test_katib.py) ---------------------------------------


def quadratic(params, report):
    x, y = params["x"], params["y"]
    val = (x - 0.3) ** 2 + (y - 0.7) ** 2
    for step in range(1, 4):
        report(step, val + 1.0 / step)
    return {"loss": val}


SPACE = {"x": katib.Double(0.0, 1.0), "y": katib.Double(0.0, 1.0)}


@pytest.mark.parametrize("algo", ["grid", "random", "bayesian"])
def test_algorithms_find_reasonable_optimum(algo):
    exp = katib.tune(quadratic, SPACE, algorithm=algo, max_trials=16, seed=0)
    best = exp.best_trial()
    assert best is not None
    assert exp.objective(best) < 0.15
    assert len(exp.trials) <= 16


def test_grid_is_deterministic_lattice():
    g1 = katib.GridSearch(SPACE, 9)
    g2 = katib.GridSearch(SPACE, 9)
    exp = Experiment("e", "loss")
    pts1 = [g1.suggest(exp) for _ in range(9)]
    pts2 = [g2.suggest(exp) for _ in range(9)]
    assert pts1 == pts2
    xs = sorted({round(p["x"], 6) for p in pts1})
    assert xs == [0.0, 0.5, 1.0]


def test_random_respects_bounds_and_log_scale():
    space = {"lr": katib.Double(1e-5, 1e-1, log=True),
             "bs": katib.Integer(16, 128),
             "act": katib.Categorical(("relu", "gelu"))}
    rs = katib.RandomSearch(space, 64, seed=3)
    exp = Experiment("e", "loss")
    for _ in range(64):
        p = rs.suggest(exp)
        assert 1e-5 <= p["lr"] <= 1e-1
        assert 16 <= p["bs"] <= 128
        assert p["act"] in ("relu", "gelu")


def test_bayesian_outperforms_random_on_smooth_objective():
    wins = 0
    for seed in range(5):
        eb = katib.tune(quadratic, SPACE, algorithm="bayesian", max_trials=12,
                        seed=seed)
        er = katib.tune(quadratic, SPACE, algorithm="random", max_trials=12,
                        seed=seed)
        if eb.objective(eb.best_trial()) <= er.objective(er.best_trial()):
            wins += 1
    assert wins >= 3


def test_median_early_stopping_fires():
    def objective(params, report):
        # bad configs report terrible intermediates
        bad = params["x"] > 0.5
        for step in range(1, 6):
            report(step, 100.0 if bad else 1.0 / step)
        return {"loss": 100.0 if bad else 0.01}

    exp = katib.tune(objective, {"x": katib.Double(0, 1)}, algorithm="random",
                     max_trials=12, early_stopping=katib.MedianStop(min_trials=2),
                     seed=0)
    assert any(t.status == "early_stopped" for t in exp.trials)


def test_goal_value_stops_experiment_early():
    exp = katib.tune(quadratic, SPACE, algorithm="random", max_trials=64,
                     goal_value=0.2, seed=1)
    assert len(exp.trials) < 64


# -- parity with the reference ------------------------------------------------

def _author(mod):
    p = mod.Pipeline("parity")
    a = p.step(seven)
    b = p.step(double, a, sim_s=0.5, pin="gcp")
    p.step(add, a, b, name="sum", cache=False)
    p.step(double, b, kind="profile", payload=object())
    p.step(add, a, b, kind="deploy", payload=object())
    return p


def test_same_pipeline_exports_the_same_yaml():
    mine, theirs = _author(pipeline), _author(jpipeline)
    assert mine.export_yaml() == theirs.export_yaml()
    assert mine.compile().to_dict() == theirs.compile().to_dict()


def test_cache_keys_and_value_hashes_equal_the_reference():
    from repro_torch.core.pipeline import step_cache_key
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "n": [1, 2.5]}
    for v in (5, "x", [4, 2], tree, np.ones(3, np.float32), None):
        assert value_hash(v) == jpipeline.value_hash(v)
    assert step_cache_key("p", "s", double, (5, tree), {"k": 3}) == \
        jpipeline.step_cache_key("p", "s", double, (5, tree), {"k": 3})


def test_value_hash_keys_tensor_trees_by_content():
    t = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3, dtype=torch.bfloat16)}
    h = value_hash(t)
    assert h != "unhashable" and h == tree_hash(t)
    assert h == jpipeline.value_hash({"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                                      "b": np.ones(3, np.float32)})
    assert value_hash({"w": t["w"] + 1, "b": t["b"]}) != h
    assert value_hash(torch.ones(2, requires_grad=True)) == value_hash(torch.ones(2))


@pytest.mark.parametrize("algo", ["grid", "random", "bayesian"])
def test_katib_proposes_the_reference_trials(algo):
    space_t = {"x": katib.Double(0.0, 1.0), "lr": katib.Double(1e-4, 1e-1, log=True),
               "bs": katib.Integer(16, 128), "act": katib.Categorical(("relu", "gelu"))}
    space_j = {"x": jkatib.Double(0.0, 1.0), "lr": jkatib.Double(1e-4, 1e-1, log=True),
               "bs": jkatib.Integer(16, 128), "act": jkatib.Categorical(("relu", "gelu"))}

    def objective(params, report):
        val = (params["x"] - 0.3) ** 2 + abs(math.log10(params["lr"]) + 2) \
            + params["bs"] / 1000 + (params["act"] == "gelu") * 0.1
        for step in range(1, 4):
            report(step, val + 1.0 / step)
        return {"loss": val}

    mine = katib.tune(objective, space_t, algorithm=algo, max_trials=10, seed=3,
                      early_stopping=katib.MedianStop(min_trials=2))
    theirs = jkatib.tune(objective, space_j, algorithm=algo, max_trials=10, seed=3,
                         early_stopping=jkatib.MedianStop(min_trials=2))
    assert [t.as_dict() | {"duration_s": 0} for t in mine.trials] == \
        [t.as_dict() | {"duration_s": 0} for t in theirs.trials]
    s_mine, s_theirs = mine.summary(), theirs.summary()
    s_mine.pop("total_time_s"), s_theirs.pop("total_time_s")
    assert s_mine == s_theirs


# -- the paper's §5.3 pipeline on the port ----------------------------------

def test_e2e_mnist_pipeline(tmp_path):
    """The paper's §5.3 pipeline: tune -> train (best params) -> serve, on
    the port, on the host."""
    imgs, labels = make_dataset(192, seed=0)
    store = ArtifactStore(str(tmp_path))
    pipe = Pipeline("e2e-mnist", store)

    def tune_stage():
        def objective(params, report):
            job = SupervisedTrainJob(lr=params["lr"], n_steps=8, width=8, device="cpu")
            res = job.run(Batches(imgs, labels, 64), report=report)
            return {"loss": res["loss"]}
        exp = katib.tune(objective, {"lr": katib.Double(1e-4, 1e-2, log=True)},
                         algorithm="random", max_trials=2, store=store)
        return exp.best_trial().params

    def train_stage(best):
        job = SupervisedTrainJob(lr=best["lr"], n_steps=25, width=8, store=store,
                                 device="cpu")
        res = job.run(Batches(imgs, labels, 64), checkpoint_name="e2e-model")
        return {"loss": res["loss"], "accuracy": res["accuracy"],
                "params": res["params"]}

    def serve_stage(trained):
        params = trained["params"]

        @torch.inference_mode()
        def predict(x):
            return torch.argmax(lenet.apply(params, x), -1)

        pred = Predictor("e2e", predict, imgs[:1], device="cpu")
        svc = InferenceService(pred, get_profile("gcp"), "kserve")
        return svc.stress_test(32).summary()

    t = pipe.step(tune_stage, cache=False)
    m = pipe.step(train_stage, t, cache=False)
    pipe.step(serve_stage, m, cache=False)
    out = pipe.run()
    assert out["train_stage"]["loss"] < 2.5
    assert out["serve_stage"]["n"] == 32
    spec = pipe.export_yaml(str(tmp_path / "pipeline.yaml"))
    assert "e2e-mnist" in spec
    names = [e["name"] for e in pipe.log.events]
    assert {"tune_stage", "train_stage", "serve_stage"} <= set(names)
    assert store.exists("e2e-model") and store.exists("experiment_katib-random")
