"""Tensor-parallel training of the MoE archs on the CPU: ``gloo`` ranks on a
model axis against one process and against the reference.

granite-moe (GQA, routed experts) and deepseek (MLA, routed and shared
experts, a dense first layer) at their smoke configs, and three variants
whose fitted specs relocate: granite-moe with 6 experts on 4 ranks (the
experts split on D), the same padded to 8 experts (split on E, two dead
experts on the last rank), and deepseek with 6 heads on 4 ranks (MLA's
query projections on D, its decompression on r, ``wo`` on its output D).

Two spawns (``tests/_ranks.spawn_ranks``, one torch thread a rank): 2
ranks on a (1, 2) mesh, and 4 ranks that build (1, 4) and (2, 2) meshes in
turn.  The rank functions are module-level and this module imports JAX only
inside the reference fixture, so a spawned child imports it cheaply.  The
reference's jobs run in two subprocesses on 4 fake CPU devices with Auto
axes, started before the ranks and read at the end.

What is held (the bounds of tests/test_torch_tp.py):
- one fp32 step, the gradients gathered whole, against one process on the
  same masters and global batch: the loss, the MoE aux loss and every
  leaf rel 1e-5, at every config and mesh above;
- the fitted specs of the expert and MLA leaves;
- every rank of a model group routing alike (``Route.ids`` and
  ``Route.slot`` of every MoE layer equal);
- each rank holding its block of every leaf (1/m of each split one), and
  the whole leaves (router, norms, ``w_dkv``) bit for bit on every rank
  after training;
- ZeRO-1 under ``tp`` on (2, 2) bit for bit plain TP;
- checkpoints between (1, 2) and one process, both ways;
- the port's 3-step jobs from the reference's init against the
  reference's Auto-axes jobs, within 1e-3.
"""
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.store import ArtifactStore  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import trainjob  # noqa: E402
from repro_torch.core.trainjob import LMTrainJob  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm, moe, steps  # noqa: E402
from repro_torch.models import sharding as msh  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from _ranks import spawn_ranks  # noqa: E402
from test_torch_tp import _bitwise, _job_out, _leaves, _rel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, LR, REF_STEPS = 4, 32, 2e-3, 3
TP_REL, TRAJ_REL, ZERO_LEAF = 1e-5, 1e-3, 1e-6
GMOE, DSEEK = "granite_moe_3b_a800m", "deepseek_v2_lite_16b"
# name -> (arch, config overrides, mesh)
CASES = {
    "granite_moe 1x2": (GMOE, {}, (1, 2)),
    "deepseek 1x2": (DSEEK, {}, (1, 2)),
    "granite_moe E6 1x4": (GMOE, {"n_experts": 6}, (1, 4)),
    "granite_moe E6 pad 8 1x4": (GMOE, {"n_experts": 6, "expert_pad_to": 8}, (1, 4)),
    "deepseek H6 1x4": (DSEEK, {"n_heads": 6, "n_kv_heads": 6}, (1, 4)),
    "deepseek 2x2": (DSEEK, {}, (2, 2)),
}
TWO = [c for c, (_, _, m) in CASES.items() if m == (1, 2)]
FOUR = [c for c in CASES if c not in TWO]
# the fitted specs' tails of one slot's leaves: experts on E, or relocated
ON_E = {"experts_gate": ("model", None, None), "experts_up": ("model", None, None),
        "experts_down": ("model", None, None), "router": (None, None)}
ON_D = {"experts_gate": (None, "model", None), "experts_up": (None, "model", None),
        "experts_down": (None, None, "model"), "router": (None, None)}
MLA_HEADS = {"w_uq": (None, "model", None), "w_qr": (None, "model", None),
             "w_uk": (None, "model", None), "w_uv": (None, "model", None),
             "wo": ("model", None, None), "w_dkv": (None, None)}
MLA_MOVED = {"w_uq": ("model", None, None), "w_qr": ("model", None, None),
             "w_uk": ("model", None, None), "w_uv": ("model", None, None),
             "wo": (None, None, "model"), "w_dkv": (None, None)}
SPECS = {"granite_moe 1x2": ON_E, "deepseek 1x2": {**ON_E, **MLA_HEADS},
         "granite_moe E6 1x4": ON_D, "granite_moe E6 pad 8 1x4": ON_E,
         "deepseek H6 1x4": {**ON_E, **MLA_MOVED}, "deepseek 2x2": {**ON_E, **MLA_HEADS}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(case):
    arch, kw, _ = CASES[case]
    return registry.get_smoke_config(arch).replace(**kw)


def _batch(cfg, seed=3):
    return {k: torch.as_tensor(v) for k, v in next(tokens.lm_batches(cfg, B, S, seed=seed)).items()}


def _fake_mesh(shape, coordinate):
    return types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 axis_names=("data", "model"), coordinate=coordinate)


@functools.lru_cache(maxsize=None)
def _one_step(case) -> tuple:
    """(loss, aux, {leaf: gradient}) of one process on the whole batch."""
    cfg = _cfg(case)
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = steps.loss_fn(leaves, cfg, _batch(cfg))
    grads = torch.autograd.grad(loss, [t for _, t in _leaves(leaves)])
    return (float(loss.detach()), float(metrics["aux"].detach()),
            dict(zip([k for k, _ in _leaves(leaves)], grads)))


def _tp_step(case, mesh) -> dict:
    """One fp32 step on this rank's shards and rows (``steps.dp_grads``
    under the mesh), the gradients gathered whole, each MoE layer's
    ``Route.ids`` and ``.slot`` recorded (``moe._route`` wrapped)."""
    cfg = _cfg(case)
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = _batch(cfg)
    routes, real = [], moe._route

    def spy(*args, **kw):
        route, probs = real(*args, **kw)
        routes.append((route.ids.clone(), route.slot.clone()))
        return route, probs

    moe._route = spy
    try:
        with msh.use_mesh(mesh):
            pspecs = msh.param_shardings(params, mesh)
            local = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone(), params,
                                   pspecs)
            bspecs = shardings.batch_shardings(batch, mesh)
            rows = {k: msh.local_slice(v, bspecs[k], mesh) for k, v in batch.items()}
            loss, metrics, grads = steps.dp_grads(local, rows, cfg=cfg)
            whole = adamw.tree_map(lambda g, s: msh.gather_leaf(g, s, mesh), grads, pspecs)
    finally:
        moe._route = real
    return {"loss": float(loss), "aux": float(metrics["aux"]), "grads": dict(_leaves(whole)),
            "specs": {k: tuple(v) for k, v in _leaves(pspecs)}, "routes": routes,
            "coordinate": mesh.coordinate}


def _from_init(init, case, mesh) -> list:
    """The losses of the port's job on ``mesh`` from the reference's
    parameters ``init`` (in place of the port's draw)."""
    saved = trainjob.lm.init_params
    trainjob.lm.init_params = lambda cfg, seed=0, device="cuda", dtype=None: transplant(
        init, device=device, dtype=dtype)
    try:
        return LMTrainJob(_cfg(case), batch_size=B, seq_len=S, n_steps=REF_STEPS, lr=LR,
                          mesh=mesh, device="cpu").run()["history"]
    finally:
        trainjob.lm.init_params = saved


# -- the spawns ----------------------------------------------------------------
def _two_rank(rank, inits, root):
    torch.set_num_threads(1)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    out = {"steps": {case: _tp_step(case, mesh) for case in TWO}}
    job = functools.partial(LMTrainJob, _cfg("deepseek 1x2"), batch_size=B, seq_len=S, lr=LR,
                            mesh=mesh, store=ArtifactStore(root), device="cpu")
    out["saved"] = _job_out(job(n_steps=3).run(checkpoint_name="tp"), mesh)
    out["from_one"] = _job_out(job(n_steps=0).run(resume_from="one"), mesh)
    out["from_one_resumed"] = job(n_steps=2).run(resume_from="one")["history"]
    out["fresh"] = {case: _job_out(LMTrainJob(
        _cfg(case), batch_size=B, seq_len=S, n_steps=0, mesh=mesh, device="cpu").run(), mesh)
        for case in TWO}
    out["ref_jobs"] = {case: _from_init(inits[case], case, mesh) for case in TWO}
    return out


def _four_rank(rank, inits):
    torch.set_num_threads(1)
    out = {"steps": {}, "ref_jobs": {}}
    for case in FOUR:
        mesh = make_mesh(CASES[case][2], ("data", "model"), "cpu")
        out["steps"][case] = _tp_step(case, mesh)
        out["ref_jobs"][case] = _from_init(inits[case], case, mesh)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = _cfg("deepseek 2x2")
    job = functools.partial(LMTrainJob, batch_size=B, seq_len=S, n_steps=3, lr=LR, mesh=mesh,
                            device="cpu")
    out["plain"] = _job_out(job(cfg).run(), mesh)
    out["zero1"] = _job_out(job(cfg.replace(zero1=True)).run(), mesh)
    return out


# -- the reference -------------------------------------------------------------
_REFERENCE = """
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs import registry
from repro.core.trainjob import LMTrainJob
out = {}
for name, (arch, kw, shape) in json.loads(sys.argv[1]).items():
    cfg = registry.get_smoke_config(arch).replace(**kw)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    res = LMTrainJob(cfg, batch_size=%d, seq_len=%d, n_steps=%d, lr=%r, mesh=mesh).run()
    out[name] = [float(v) for v in res["history"]]
print(json.dumps(out))
""" % (B, S, REF_STEPS, LR)


@pytest.fixture(scope="module")
def reference():
    """The reference's ``LMTrainJob`` at every case, on Auto-axes meshes of
    4 fake CPU devices, in two subprocesses (granite-moe's cases, then
    deepseek's), started here and read by ``reference_history``; and the
    reference's init at every case, which the port's jobs start from.
    (``jax.make_mesh`` alone makes Explicit axes under JAX 0.9, which the
    reference's sharding code refuses: ROADMAP.md queue 3.)"""
    import jax

    from repro.configs import registry as jreg
    from repro.models import lm as jlm
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE,
         json.dumps({c: v for c, v in CASES.items() if v[0] == arch})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for arch in (GMOE, DSEEK)]
    inits = {}
    for case, (arch, kw, _) in CASES.items():
        inits[case] = jax.tree_util.tree_map(np.asarray, jlm.init_params(
            jax.random.PRNGKey(0), jreg.get_smoke_config(arch).replace(**kw)))
    yield {"procs": procs, "init": inits}
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def reference_history(reference):
    out = {}
    for p in reference["procs"]:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-4000:]
        out.update(json.loads(stdout.strip().splitlines()[-1]))
    return out


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """A one-process deepseek checkpoint ("one"), 3 steps, for the ranks to load."""
    root = str(tmp_path_factory.mktemp("store"))
    LMTrainJob(_cfg("deepseek 1x2"), batch_size=B, seq_len=S, lr=LR, n_steps=3,
               store=ArtifactStore(root), device="cpu").run(checkpoint_name="one")
    return root


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, reference, store_root):
    out = tmp_path_factory.mktemp("ranks2")
    return spawn_ranks(_two_rank, 2, {c: reference["init"][c] for c in TWO}, store_root,
                       out_dir=out, timeout_s=300)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, reference):
    out = tmp_path_factory.mktemp("ranks4")
    return spawn_ranks(_four_rank, 4, {c: reference["init"][c] for c in FOUR}, out_dir=out,
                       timeout_s=300)


@pytest.fixture(scope="module")
def ranks(two_ranks, four_ranks):
    """case -> every rank's results of the spawn that ran it."""
    return {case: two_ranks if case in TWO else four_ranks for case in CASES}


# -- the tests -----------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_one_step_matches_one_process(ranks, case):
    """The loss, the aux loss and every gathered gradient leaf rel 1e-5 of
    one process (a leaf whose whole gradient is below 1e-6 of the tree's
    largest held below that floor, as in tests/test_torch_tp.py)."""
    loss, aux, want = _one_step(case)
    floor = ZERO_LEAF * max(float(w.abs().max()) for w in want.values())
    for res in ranks[case]:
        got = res["steps"][case]
        assert abs(got["loss"] - loss) <= TP_REL * abs(loss)
        assert abs(got["aux"] - aux) <= TP_REL * abs(aux)
        assert got["grads"].keys() == want.keys()
        bad = {}
        for k, w in want.items():
            if float(w.abs().max()) < floor:
                if float(got["grads"][k].abs().max()) >= floor:
                    bad[k] = "zero leaf"
            elif (r := _rel(got["grads"][k], w)) > TP_REL:
                bad[k] = r
        assert bad == {}, f"gradient leaves off by rel > {TP_REL}: {bad}"


@pytest.mark.parametrize("case", list(CASES))
def test_fitted_specs_of_the_expert_and_mla_leaves(ranks, case):
    """Experts on E where E (padded or not) divides the model axis, else on
    D (``experts_down`` on its output D); MLA on heads where they divide
    it, else ``w_uq``/``w_qr`` on D, ``w_uk``/``w_uv`` on r, ``wo`` on its
    output D; the router and ``w_dkv`` whole.  The dense first layer of
    deepseek splits as the dense MLP does."""
    specs = ranks[case][0]["steps"][case]["specs"]
    moe_phase = "phase1" if CASES[case][0] == DSEEK else "phase0"
    for name, tail in SPECS[case].items():
        where = "mixer" if name in MLA_HEADS else "ffn"
        for phase in (("phase0", "phase1") if where == "mixer" else (moe_phase,)):
            assert specs[f"{phase}/slot0/{where}/{name}"][1:] == tail, (phase, name)
    if CASES[case][0] == DSEEK:
        assert specs["phase0/slot0/ffn/w_down"] == (None, "model", None)
        assert specs["phase1/slot0/ffn/shared_gate"] == (None, None, "model")
        assert specs["phase1/slot0/ffn/shared_down"] == (None, "model", None)


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_of_a_model_group_routes_alike(ranks, case):
    """``Route.ids`` and ``Route.slot`` of every MoE layer equal on every
    rank of a model group (the ranks of one data coordinate): each rank
    routes the same rows from the same bits, and a near tie decided
    otherwise on one rank would dispatch tokens to other experts there."""
    arch = CASES[case][0]
    n_moe = _cfg(case).n_layers - (1 if arch == DSEEK else 0)
    groups: dict = {}
    for res in ranks[case]:
        got = res["steps"][case]
        assert len(got["routes"]) == n_moe
        groups.setdefault(got["coordinate"]["data"], []).append(got["routes"])
    assert len(groups) == CASES[case][2][0]
    for routes in groups.values():
        for other in routes[1:]:
            for (ids, slot), (ids0, slot0) in zip(other, routes[0]):
                assert torch.equal(ids, ids0) and torch.equal(slot, slot0)


@pytest.mark.parametrize("case", TWO)
def test_each_rank_holds_its_block_of_every_leaf(two_ranks, case):
    """A fresh job's parameters on each rank are its ``local_slice`` of the
    whole init under the fitted spec, each split leaf 1/2 of the whole."""
    whole = lm.init_params(_cfg(case), seed=0, device="cpu", dtype=torch.float32)
    specs = msh.param_shardings(whole, _fake_mesh((1, 2), {"data": 0, "model": 0}))
    for res in two_ranks:
        mesh = _fake_mesh((1, 2), res["fresh"][case]["coordinate"])
        got = res["fresh"][case]["params"]
        blocks = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh), whole, specs)
        assert _bitwise(blocks, got) == []
        for (name, t), (_, w), (_, s) in zip(_leaves(got), _leaves(whole), _leaves(specs)):
            assert t.numel() * (2 if "model" in s else 1) == w.numel(), name


def test_whole_leaves_stay_bit_for_bit_on_every_rank(two_ranks):
    """After 3 steps of deepseek on (1, 2) the leaves no spec splits (the
    routers, the norms, ``w_dkv``) are bit for bit equal on both ranks."""
    a, b = (dict(_leaves(r["saved"]["params"])) for r in two_ranks)
    specs = two_ranks[0]["steps"]["deepseek 1x2"]["specs"]
    whole = [k for k, s in specs.items() if "model" not in s]
    assert any(k.endswith("router") for k in whole) and any(k.endswith("w_dkv") for k in whole)
    assert [k for k in whole if not torch.equal(a[k], b[k])] == []
    assert two_ranks[0]["saved"]["history"] == two_ranks[1]["saved"]["history"]


def test_zero1_under_tp_is_bitwise_plain_tp(four_ranks):
    """deepseek on (2, 2): ZeRO-1's parameters equal plain TP's bit for bit
    and its moments are the data coordinate's block of plain TP's."""
    whole = lm.init_params(_cfg("deepseek 2x2"), device="meta", dtype=torch.float32)
    specs = shardings.opt_shardings(None, whole, msh.abstract_mesh((2, 2), ("data", "model")),
                                    zero1=True)["mu"]
    for res in four_ranks:
        plain, zero = res["plain"], res["zero1"]
        assert plain["history"] == zero["history"] == four_ranks[0]["plain"]["history"]
        assert _bitwise(plain["params"], zero["params"]) == []
        mesh = _fake_mesh((2, 2), zero["coordinate"])
        for key in ("mu", "nu"):
            blocks = adamw.tree_map(lambda t, s: msh.local_slice(
                t, msh.without_axis(s, "model"), mesh), plain[key], specs)
            assert _bitwise(blocks, zero[key]) == [], key


def test_checkpoints_between_a_1x2_mesh_and_one_process(two_ranks, store_root):
    """deepseek: a (1, 2) checkpoint is the whole tree, whose blocks are
    the ranks' shards and moments; a one-process checkpoint loads on the
    ranks as their blocks of it, bit for bit, and the two resumed
    trajectories agree within 1e-5."""
    job = functools.partial(LMTrainJob, _cfg("deepseek 1x2"), batch_size=B, seq_len=S, lr=LR,
                            store=ArtifactStore(store_root), device="cpu")
    for name, key in (("tp", "saved"), ("one", "from_one")):
        whole = job(n_steps=0).run(resume_from=name)
        specs = msh.param_shardings(whole["params"], _fake_mesh((1, 2), {"data": 0, "model": 0}))
        for res in two_ranks:
            mesh = _fake_mesh((1, 2), res[key]["coordinate"])
            assert res[key]["step"] == int(whole["opt_state"]["step"]) == 3
            for tree, src in (("params", whole["params"]), ("mu", whole["opt_state"]["mu"]),
                              ("nu", whole["opt_state"]["nu"])):
                blocks = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh), src, specs)
                assert _bitwise(blocks, res[key][tree]) == [], (name, tree)
    resumed = job(n_steps=2).run(resume_from="one")["history"]
    got = two_ranks[0]["from_one_resumed"]
    assert max(abs(a - b) / abs(b) for a, b in zip(got, resumed)) <= TP_REL
    assert two_ranks[1]["from_one_resumed"] == got


@pytest.mark.parametrize("case", list(CASES))
def test_tp_job_matches_the_reference(reference_history, ranks, case, capsys):
    """The port's 3-step job from the reference's init against the
    reference's job on an Auto-axes mesh of the same shape: 1e-3."""
    want = reference_history[case]
    got = ranks[case][0]["ref_jobs"][case]
    assert len(got) == REF_STEPS and all(r["ref_jobs"][case] == got for r in ranks[case])
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    with capsys.disabled():
        print(f"\ntp {case} vs the reference's Auto-axes job: losses {got} vs {want}, "
              f"largest rel {rel:.2e}")
    assert rel <= TRAJ_REL
