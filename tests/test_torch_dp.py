"""Data-parallel training on the CPU: ``gloo`` ranks against one process
and against the reference.

Each multi-process test spawns its ranks with ``tests/_ranks.spawn_ranks``
(one torch thread each; the rank functions live in this module, which
imports JAX only inside the fixture that runs the reference).  A
data-parallel job must compute what one process computes on the whole
global batch: losses within 1e-5 (summation order alone: each rank sums
its rows' gradients, the ranks' sums are summed), parameters and moments
bit for bit between ZeRO-1 and plain data parallelism (the update is
elementwise on the same all-reduced gradient and clip factor), and every
replica bit for bit equal to rank 0's.  Against the reference's
``LMTrainJob`` on its local mesh (built with Auto axes: see the
``granite`` fixture): the trajectory tolerance of
tests/test_torch_train.py, 1e-3, from the reference's init.  Gradients
are held per leaf, rel = max |dp - one| / max |one| <= 1e-5, a leaf whose
whole gradient is below 1e-6 of the tree's largest (fp32 cancellation
noise on both sides, as in tests/test_torch_train.py) held below that
floor.
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
from repro_torch.launch import shardings, train  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_mesh  # noqa: E402
from repro_torch.models import lm, steps  # noqa: E402
from repro_torch.models import sharding as msh  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from _ranks import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, STEPS, LR = 4, 32, 12, 2e-3
DP_REL, TRAJ_REL, ZERO_LEAF = 1e-5, 1e-3, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _host(tree):
    return adamw.tree_map(lambda t: t.detach().cpu().clone(), tree)


def _job_out(res) -> dict:
    opt = res["opt_state"]
    return {"history": res["history"], "params": _host(res["params"]),
            "mu": _host(opt["mu"]), "nu": _host(opt["nu"]), "step": int(opt["step"])}


def _patch_init(init) -> None:
    """The reference's parameters in place of the port's draw (in this
    process: a rank patches its own module)."""
    trainjob.lm.init_params = lambda cfg, seed=0, device="cuda", dtype=None: transplant(
        init, device=device, dtype=dtype)


def _spawn(tmp_path_factory, fn, world, *args):
    out = tmp_path_factory.mktemp("ranks")
    return spawn_ranks(fn, world, *args, out_dir=out, timeout_s=120)


def _blocks(tree: dict, specs: dict, coordinate: dict) -> dict:
    """Each leaf's block on the rank at ``coordinate`` of a (2, 1) mesh."""
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 1}, axis_names=("data", "model"),
                                 coordinate=coordinate)
    return adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh), tree, specs)


def _zero1_specs(params: dict) -> dict:
    mesh = msh.abstract_mesh((2, 1), ("data", "model"))
    return shardings.opt_shardings(None, params, mesh, zero1=True)["mu"]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / (want.float().abs().max() + 1e-12))


def _held_grads(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    floor = ZERO_LEAF * max(float(w.abs().max()) for w in want.values())
    bad = {}
    for k, w in want.items():
        if float(w.abs().max()) < floor:
            if float(got[k].abs().max()) >= floor:
                bad[k] = "zero leaf"
        elif (r := _rel(got[k], w)) > DP_REL:
            bad[k] = r
    assert bad == {}, f"gradient leaves off by rel > {DP_REL}: {bad}"


def _bitwise(a: dict, b: dict) -> list:
    """Leaves (as ``_leaves`` names them) whose bits differ."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    return [k for k in la if not torch.equal(la[k], lb[k])]


# -- granite: 2 ranks, plain DP and ZeRO-1, against one process and the reference
def _granite_rank(rank, init):
    torch.set_num_threads(1)
    _patch_init(init)
    mesh = make_local_mesh("cpu")
    cfg = registry.get_smoke_config("granite_3_8b")
    kw = dict(batch_size=B, seq_len=S, n_steps=STEPS, lr=LR, mesh=mesh, device="cpu")
    return {"plain": _job_out(LMTrainJob(cfg, **kw).run()),
            "zero1": _job_out(LMTrainJob(cfg.replace(zero1=True), **kw).run()),
            "coordinate": mesh.coordinate}


@pytest.fixture(scope="module")
def granite(tmp_path_factory):
    """The reference's ``LMTrainJob`` on its local mesh, the port's job in
    one process and on 2 ranks (plain DP and ZeRO-1), all from the
    reference's init."""
    import jax
    from jax.sharding import AxisType

    from repro.configs import registry as jreg
    from repro.core.trainjob import LMTrainJob as JLMTrainJob
    from repro.models import lm as jlm

    cfg_j = jreg.get_smoke_config("granite_3_8b")
    # the reference's make_local_mesh() with Auto axes: jax.make_mesh now
    # defaults to Explicit axes, which the reference's sharding code refuses
    # (a fault of the reference, ROADMAP.md queue 3)
    mesh = jax.make_mesh((len(jax.devices()), 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ref = JLMTrainJob(cfg_j, batch_size=B, seq_len=S, n_steps=STEPS, lr=LR, mesh=mesh).run()
    init = jax.tree_util.tree_map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), cfg_j))
    saved = trainjob.lm.init_params
    _patch_init(init)
    try:
        one = _job_out(LMTrainJob(registry.get_smoke_config("granite_3_8b"), batch_size=B,
                                  seq_len=S, n_steps=STEPS, lr=LR, device="cpu").run())
    finally:
        trainjob.lm.init_params = saved
    ranks = _spawn(tmp_path_factory, _granite_rank, 2, init)
    return {"ref": ref["history"], "one": one, "ranks": ranks}


def test_two_rank_job_matches_one_process_and_the_reference(granite, capsys):
    one, ranks = granite["one"], granite["ranks"]
    rels = {}
    for run in ("plain", "zero1"):
        got = ranks[0][run]["history"]
        assert len(got) == STEPS
        rels[run] = max(abs(a - b) / abs(b) for a, b in zip(got, one["history"]))
        assert rels[run] <= DP_REL, (run, got, one["history"])
        assert ranks[1][run]["history"] == got
    ref = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["plain"]["history"], granite["ref"]))
    with capsys.disabled():
        print(f"\n2 ranks vs one process, largest rel loss over {STEPS} steps: plain "
              f"{rels['plain']:.2e}, ZeRO-1 {rels['zero1']:.2e}; vs the reference {ref:.2e}")
    assert ref <= TRAJ_REL


def test_zero1_is_bitwise_plain_data_parallelism(granite):
    """Parameters equal bit for bit; each rank's moment blocks are its data
    coordinate's block of plain DP's moments, bit for bit, and half their
    bytes (every smoke leaf has an even dim)."""
    for r, res in enumerate(granite["ranks"]):
        plain, zero = res["plain"], res["zero1"]
        assert _bitwise(plain["params"], zero["params"]) == []
        assert plain["step"] == zero["step"] == STEPS
        specs = _zero1_specs(plain["params"])
        for key in ("mu", "nu"):
            assert _bitwise(_blocks(plain[key], specs, res["coordinate"]), zero[key]) == [], \
                (r, key)
            whole = sum(t.numel() for _, t in _leaves(plain[key]))
            assert 2 * sum(t.numel() for _, t in _leaves(zero[key])) == whole


def test_replicas_stay_bitwise_equal(granite):
    for run in ("plain", "zero1"):
        assert _bitwise(granite["ranks"][0][run]["params"],
                        granite["ranks"][1][run]["params"]) == [], run


# -- the dp profile over a (2, 2) mesh of 4 ranks ------------------------------
def _dp_profile_rank(rank):
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = registry.get_smoke_config("granite_3_8b").replace(sharding_profile="dp", zero1=True)
    res = LMTrainJob(cfg, batch_size=B, seq_len=S, n_steps=6, lr=LR, mesh=mesh,
                     device="cpu").run()
    return {"history": res["history"], "coordinate": mesh.coordinate,
            "params": _host(res["params"])}


def test_dp_profile_on_a_2x2_mesh_matches_one_process(tmp_path_factory):
    """Under the dp profile the model axis carries batch: each of 4 ranks
    takes one row; ZeRO-1 splits the moments over data (2 ways)."""
    ranks = _spawn(tmp_path_factory, _dp_profile_rank, 4)
    one = LMTrainJob(registry.get_smoke_config("granite_3_8b"), batch_size=B, seq_len=S,
                     n_steps=6, lr=LR, device="cpu").run()
    assert sorted((r["coordinate"]["data"], r["coordinate"]["model"]) for r in ranks) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    got = ranks[0]["history"]
    assert max(abs(a - b) / abs(b) for a, b in zip(got, one["history"])) <= DP_REL
    for r in ranks[1:]:
        assert r["history"] == got and _bitwise(r["params"], ranks[0]["params"]) == []


# -- one step's gradients: unequal label masks, MoE -------------------------------
def _grads_rank(rank, arch, batch):
    """``steps.dp_grads`` on this rank's rows of the global ``batch``."""
    torch.set_num_threads(1)
    mesh = make_local_mesh("cpu")
    cfg = registry.get_smoke_config(arch)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    specs = shardings.batch_shardings(batch, mesh)
    rows = {k: msh.local_slice(v, specs[k], mesh) for k, v in batch.items()}
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    loss, metrics, grads = steps.dp_grads(params, rows, cfg=cfg)
    return {"loss": float(loss), "ce": float(metrics["ce"]), "aux": float(metrics["aux"]),
            "grads": dict(_leaves(_host(grads)))}


def _one_process(arch, batch):
    cfg = registry.get_smoke_config(arch)
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = steps.loss_fn(leaves, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    names = [k for k, _ in _leaves(leaves)]
    grads = torch.autograd.grad(loss, [t for _, t in _leaves(leaves)])
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(names, grads))


def test_unequal_label_masks_across_ranks(tmp_path_factory):
    """Rank 0's rows keep their first 6 labels of 32, rank 1's all: the loss and every
    gradient equal one process's on the whole batch.  The mean of the two
    ranks' own means, the wrong reduction, is off by far more."""
    cfg = registry.get_smoke_config("granite_3_8b")
    batch = next(tokens.lm_batches(cfg, B, S, seed=4))
    batch["labels"][:2, 6:] = -1
    ranks = _spawn(tmp_path_factory, _grads_rank, 2, "granite_3_8b", batch)
    loss, metrics, grads = _one_process("granite_3_8b", batch)
    for r in ranks:
        assert abs(r["loss"] - float(loss)) <= DP_REL * abs(float(loss))
        assert abs(r["ce"] - float(metrics["ce"])) <= DP_REL * abs(float(metrics["ce"]))
        _held_grads(r["grads"], grads)
    halves = [_one_process("granite_3_8b", {k: v[i:i + 2] for k, v in batch.items()})[0]
              for i in (0, 2)]
    wrong = float(sum(halves)) / 2
    assert abs(wrong - float(loss)) > 100 * DP_REL * abs(float(loss))


def test_moe_aux_loss_and_gradients_over_a_split_batch(tmp_path_factory):
    """granite-moe: the auxiliary loss is a mean over rows (each routes
    alone), so a rank weights its own by its share of the rows; aux, loss
    and every gradient equal one process's."""
    cfg = registry.get_smoke_config("granite_moe_3b_a800m")
    batch = next(tokens.lm_batches(cfg, B, S, seed=2))
    ranks = _spawn(tmp_path_factory, _grads_rank, 2, "granite_moe_3b_a800m", batch)
    loss, metrics, grads = _one_process("granite_moe_3b_a800m", batch)
    assert float(metrics["aux"]) > 0
    for r in ranks:
        for k, want in (("loss", loss), ("ce", metrics["ce"]), ("aux", metrics["aux"])):
            assert abs(r[k] - float(want)) <= DP_REL * abs(float(want)), k
        _held_grads(r["grads"], grads)


# -- checkpoints across world sizes -------------------------------------------
def _checkpoint_rank(rank, root):
    torch.set_num_threads(1)
    mesh = make_local_mesh("cpu")
    cfg = registry.get_smoke_config("h2o_danube_3_4b").replace(zero1=True)
    job = functools.partial(LMTrainJob, cfg, batch_size=B, seq_len=S, lr=LR, mesh=mesh,
                            store=ArtifactStore(root), device="cpu")
    saved = _job_out(job(n_steps=6).run(checkpoint_name="dp"))
    return {"saved": saved, "loaded": _job_out(job(n_steps=0).run(resume_from="dp")),
            "resumed": job(n_steps=3).run(resume_from="dp")["history"],
            "from_one": _job_out(job(n_steps=0).run(resume_from="one")),
            "from_one_resumed": job(n_steps=3).run(resume_from="one")["history"],
            "coordinate": mesh.coordinate}


def test_zero1_checkpoint_resumes_and_loads_across_world_sizes(tmp_path_factory):
    """A 2-rank ZeRO-1 job saves the whole tree (moments gathered); resumed
    on 2 ranks it starts from the saved state bit for bit (the parameters,
    each rank's moment blocks, the step counter), and a one-process job
    loads the same state; a one-process checkpoint loads on 2 ranks.  The
    resumed trajectories agree across world sizes within 1e-5."""
    root = str(tmp_path_factory.mktemp("store"))
    cfg = registry.get_smoke_config("h2o_danube_3_4b")
    job = functools.partial(LMTrainJob, cfg, batch_size=B, seq_len=S, lr=LR,
                            store=ArtifactStore(root), device="cpu")
    one = _job_out(job(n_steps=6).run(checkpoint_name="one"))
    ranks = _spawn(tmp_path_factory, _checkpoint_rank, 2, root)
    for r in ranks:
        saved, loaded = r["saved"], r["loaded"]
        assert loaded["step"] == saved["step"] == 6
        for key in ("params", "mu", "nu"):
            assert _bitwise(saved[key], loaded[key]) == [], key
    # the whole moments are the ranks' blocks, in data order
    whole = _job_out(job(n_steps=0).run(resume_from="dp"))
    assert whole["step"] == 6 and _bitwise(whole["params"], ranks[0]["saved"]["params"]) == []
    specs = _zero1_specs(whole["params"])
    for r in ranks:
        for key in ("mu", "nu"):
            assert _bitwise(_blocks(whole[key], specs, r["coordinate"]), r["saved"][key]) == [], key
            assert _bitwise(_blocks(one[key], specs, r["coordinate"]), r["from_one"][key]) == [], \
                key
        assert _bitwise(one["params"], r["from_one"]["params"]) == []
        assert r["from_one"]["step"] == 6
    for name, got in (("dp", ranks[0]["resumed"]), ("one", ranks[0]["from_one_resumed"])):
        want = job(n_steps=3).run(resume_from=name)["history"]
        assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) <= DP_REL, name


# -- the launcher ---------------------------------------------------------------
def _launcher_json(text: str) -> dict:
    start = text.index("{\n")
    return json.loads(text[start:text.index("\n}", start) + 2])


def test_launcher_mesh_local_under_torch_distributed_run(tmp_path, capsys):
    """``python -m torch.distributed.run --nproc-per-node 2`` of
    ``launch.train --mesh local`` on gloo: both ranks train, rank 0 reports
    the global losses, equal to the launcher's one-process run."""
    args = ["--arch", "granite_3_8b", "--smoke", "--device", "cpu", "--steps", "3"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args,
                        "--mesh", "local", "--dist-backend", "gloo",
                        "--store", str(tmp_path / "dp")],
                       capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    got = _launcher_json(r.stdout)
    assert got["mesh"] == {"data": 2, "model": 1}
    train.main(args + ["--store", str(tmp_path / "one")])
    want = _launcher_json(capsys.readouterr().out)
    for k in ("loss_first", "loss_last"):
        assert abs(got[k] - want[k]) <= DP_REL * abs(want[k]), k


def test_launcher_mesh_local_run_plainly_is_a_one_rank_group(tmp_path, capsys):
    import torch.distributed as dist
    args = ["--arch", "granite_3_8b", "--smoke", "--device", "cpu", "--steps", "3"]
    dp = train.main(args + ["--mesh", "local", "--store", str(tmp_path / "dp")])
    assert not dist.is_initialized()
    assert _launcher_json(capsys.readouterr().out)["mesh"] == {"data": 1, "model": 1}
    one = train.main(args + ["--store", str(tmp_path / "one")])
    assert dp["history"] == one["history"]


def test_launcher_refuses_nccl_past_the_cards(monkeypatch):
    """NCCL refuses two ranks on one card: asked for more ranks on a host
    than it has cards (or for host tensors), the launcher raises before it
    joins a group, and never switches backend or device itself."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    base = ["--arch", "granite_3_8b", "--smoke", "--steps", "1", "--mesh", "local"]
    with pytest.raises(ValueError, match="nccl: 2 rank"):
        train.main(base + ["--dist-backend", "nccl"])
    with pytest.raises(ValueError, match="nccl"):
        train.main(base + ["--device", "cpu", "--dist-backend", "nccl"])
