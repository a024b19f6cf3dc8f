"""The PyTorch port's boundaries: it stands alone, it never falls back from
the card to the host, and its serving entry points answer on the CPU."""
import ast
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.clouds.profiles import get_profile  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.examples import continuous_batching  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402
from repro_torch.serving.continuous import ContinuousBatcher  # noqa: E402
from repro_torch.serving.kserve import InferenceService  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden_imports(path: Path) -> list:
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    return bad


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    assert path.is_file(), path
    assert _forbidden_imports(path) == []


def _device_defaults(path: Path) -> list:
    """(where, default) for every ``device`` parameter with a default and
    every ``--device`` command-line option of a module."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            pos = a.posonlyargs + a.args
            pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults)) + \
                [(k, d) for k, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
            found += [(f"{node.name}({k.arg}=)", ast.literal_eval(d))
                      for k, d in pairs if k.arg == "device"]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
              and node.args and isinstance(node.args[0], ast.Constant)
              and node.args[0].value == "--device"):
            found += [("--device", ast.literal_eval(kw.value))
                      for kw in node.keywords if kw.arg == "default"]
    return found


def test_port_entry_points_default_to_the_card():
    """Every device parameter and ``--device`` option of the port, the
    batcher's example and the launchers included, defaults to the card."""
    found = {str(p.relative_to(ROOT)): _device_defaults(p) for p in PORT_FILES}
    assert found["src/repro_torch/examples/continuous_batching.py"] == [("--device", "cuda")]
    assert ("--device", "cuda") in found["src/repro_torch/launch/serve.py"]
    bad = {f: [d for d in defaults if d[1] != "cuda"] for f, defaults in found.items()}
    assert {f: d for f, d in bad.items() if d} == {}


def test_isolation_check_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.models import lm\n"
                 "from repro_torch.models import lm as ok\nimport repro\n")
    assert _forbidden_imports(f) == ["jax.numpy", "repro.models", "repro"]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")


@pytest.mark.parametrize("entry", [
    lambda cfg: lm.init_params(cfg, device="cuda"),
    lambda cfg: lm.init_cache(cfg, 1, 8, device="cuda"),
    lambda cfg: serve.make_lm_predictor(cfg, device="cuda"),
    lambda cfg: transplant({"w": np.zeros(2, np.float32)}, device="cuda"),
    lambda cfg: serve.main(["--arch", "granite_3_8b", "--smoke", "--requests", "1"]),
    lambda cfg: ContinuousBatcher(cfg, lm.init_params(cfg)),
    lambda cfg: continuous_batching.main(["--smoke"]),
], ids=["init_params", "init_cache", "make_lm_predictor", "transplant", "serve_main",
        "continuous_batcher", "continuous_batching_example"])
def test_cuda_entry_points_raise_without_a_card(no_cuda, entry):
    """No silent CPU fallback: asking for the card where there is none raises."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(registry.get_smoke_config("granite_3_8b"))


def test_registry_names_the_roadmap_item_for_unported_archs():
    assert registry.list_archs() == ["granite_3_8b", "zamba2_1_2b", "xlstm_1_3b",
                                     "h2o_danube_3_4b", "minitron_4b"]
    assert registry.get_config("granite-3-8b").d_model == 4096
    assert registry.get_config("h2o-danube-3-4b").sliding_window == 4096
    assert registry.get_config("minitron_4b").mlp_act == "squared_relu"
    assert registry.get_config("zamba2-1.2b").n_layers == 38
    assert registry.get_config("xlstm_1_3b").n_heads == 4
    for arch, item in registry.PENDING.items():
        assert arch not in registry.PORTED
        with pytest.raises(KeyError, match=f"ROADMAP.md queue 1 item {item.split()[0]}"):
            registry.get_config(arch)
    assert set(registry.PENDING) | set(registry.PORTED) == set(registry.ARCH_IDS)
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("nope")


@pytest.fixture(scope="module")
def predictor():
    cfg = registry.get_smoke_config("granite_3_8b").replace(use_kernels=True)
    return serve.make_lm_predictor(cfg, gen_tokens=3, prompt_len=6, device="cpu"), cfg


def test_predictor_generates_in_vocab(predictor):
    pred, cfg = predictor
    toks = pred.predict(np.arange(12, dtype=np.int32).reshape(2, 6))
    assert toks.shape == (2, 3) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size


@pytest.mark.parametrize("strategy", ["baremetal", "k8s"])
def test_inference_service_sequential_strategies(predictor, strategy):
    pred, _ = predictor
    res = InferenceService(pred, get_profile("gcp"), strategy).stress_test(4)
    s = res.summary()
    assert s["strategy"] == strategy and s["n"] == 4 and len(res.latencies_s) == 4
    assert s["p50_s"] > 0 and s["total_s"] == pytest.approx(sum(res.latencies_s), abs=1e-3)
    # baremetal pays the model reload on every request
    extra = get_profile("gcp").model_load_s if strategy == "baremetal" else 0.0
    assert res.latencies_s[0] == pytest.approx(
        0.0025 + 0.0004 + extra + pred.service_time(1))


def test_kserve_strategy_names_its_roadmap_item(predictor):
    pred, _ = predictor
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 1.3"):
        InferenceService(pred, get_profile("gcp"), "kserve").stress_test(2)


def test_serve_main_rejects_the_kserve_batch_cap():
    """--max-batch only caps the gateway strategy, which is not ported: it is
    refused rather than silently ignored."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 1.3"):
        serve.main(["--arch", "granite_3_8b", "--smoke", "--device", "cpu",
                    "--max-batch", "4"])


@pytest.mark.parametrize("arch", ["granite_3_8b", "zamba2_1_2b", "xlstm_1_3b",
                                  "h2o_danube_3_4b", "minitron_4b"])
def test_serve_main_runs_the_smoke_config_on_cpu(capsys, arch):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
                "--gen-tokens", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["n"] == 2 and out["device"] == "cpu"
    assert out["arch"] == registry.get_config(arch).name


def test_continuous_batching_example_runs_the_smoke_config_on_cpu(capsys):
    """The example's two legs (batched prefill, teacher-forced) over the same
    mix give the same tokens; the smoke config on the host."""
    summary = continuous_batching.main(["--smoke", "--device", "cpu", "--requests", "4",
                                        "--prompt-len", "20", "--max-new", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out == summary and out["oracle_ok"] and out["device"] == "cpu"
    assert out["tokens_generated"] == 16 and out["prefill_stats"]["chunks"] == 12
