"""Tensor-parallel training on the CPU: ``gloo`` ranks on a model axis
against one process and against the reference.

Two spawns (``tests/_ranks.spawn_ranks``, one torch thread a rank): 2 ranks
on a (1, 2) mesh over ("data", "model"), and 4 ranks that build a (2, 2), a
(1, 4) and a (2, 1, 2) mesh over ("pod", "data", "model") in turn.  The rank
functions are module-level and this module imports JAX only inside the
reference fixture, so a spawned child imports it cheaply.

What is held:
- the four layout Functions (``copy``, ``reduce``, ``gather``, ``scatter``),
  forward and backward, against one process's sums and slices;
- the vocab-parallel cross entropy against the whole-vocabulary one: loss
  and gradient within 1e-6;
- one fp32 step, the gradients gathered whole, against one process on the
  same masters and global batch (and granite on (1, 2) with each group
  checkpointed and the backward run on a thread where no mesh is active,
  as the autograd engine runs it for CUDA tensors): the loss and every leaf rel 1e-5 (a leaf
  whose whole gradient is below 1e-6 of the tree's largest held below that
  floor, as in tests/test_torch_dp.py), for every arch of the slice on
  (1, 2), granite on (2, 2) and (2, 1, 2), and granite with vocab 509 on
  (1, 4), whose fitted specs put ``embed``, ``lm_head``, ``wk`` and ``wv``
  on D;
- ZeRO-1 under ``tp`` on (2, 2) bit for bit the plain TP update, each
  rank's parameters exactly ``local_slice`` of the whole under the fitted
  spec;
- checkpoints between (1, 2) and one process, both ways;
- a family that tensor parallelism does not list (whisper's, taken out of
  ``TP_FAMILIES`` in the rank) refusing a (1, 2) mesh under ``tp``, naming
  item 1.13, and training under ``dp`` as one process does (whisper trains
  under ``tp``: tests/test_torch_tp_encdec.py);
- the reference's ``LMTrainJob`` on Auto-axes (1, 2) and (1, 4) meshes of
  4 fake CPU devices (a subprocess): the port's job from its init, within
  the trajectory tolerance of tests/test_torch_train.py, 1e-3.
"""
import concurrent.futures
import functools
import json
import os
import subprocess
import sys
from unittest import mock
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
from repro_torch.models import attention, lm, steps  # noqa: E402
from repro_torch.models import sharding as msh  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from _ranks import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, LR, REF_STEPS = 4, 32, 2e-3, 3
TP_REL, TRAJ_REL, ZERO_LEAF, XENT_TOL = 1e-5, 1e-3, 1e-6, 1e-6
SLICE = ["granite_3_8b", "h2o_danube_3_4b", "minitron_4b", "gemma3_4b", "qwen2_vl_7b"]
# an arch whose family is taken out of TP_FAMILIES -> the item it is refused under
OUTSIDE = {"whisper_base": "1.13"}
ODD_VOCAB = 509
# granite's smoke config with 6 query heads over 3 kv heads: on (1, 2) the kv
# heads do not divide the axis, and each rank's 3 query heads read kv heads
# (0, 0, 1) and (1, 2, 2), an uneven share: one kv head a query head
UNEVEN_KV = dict(d_model=96, n_heads=6, n_kv_heads=3)


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


def _unlisted(family: str):
    """``TP_FAMILIES`` without ``family``: it becomes a family named nowhere."""
    return mock.patch.object(msh, "TP_FAMILIES", tuple(f for f in msh.TP_FAMILIES if f != family))


def _host(tree):
    return adamw.tree_map(lambda t: t.detach().cpu().clone(), tree)


def _cfg(arch, vocab=0):
    if arch == "uneven_kv":
        return registry.get_smoke_config("granite_3_8b").replace(**UNEVEN_KV)
    cfg = registry.get_smoke_config(arch)
    return cfg.replace(vocab_size=vocab) if vocab else cfg


def _batch(cfg, seed=3, b=B, s=S):
    return {k: torch.as_tensor(v) for k, v in next(tokens.lm_batches(cfg, b, s, seed=seed)).items()}


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
        elif (r := _rel(got[k], w)) > TP_REL:
            bad[k] = r
    assert bad == {}, f"gradient leaves off by rel > {TP_REL}: {bad}"


def _bitwise(a: dict, b: dict) -> list:
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    return [k for k in la if not torch.equal(la[k], lb[k])]


def _from_init(init, cfg, mesh) -> list:
    """The losses of the port's job on ``mesh`` from the reference's
    parameters ``init`` (in place of the port's draw) for the reference's
    trajectory."""
    saved = trainjob.lm.init_params
    trainjob.lm.init_params = lambda cfg, seed=0, device="cuda", dtype=None: transplant(
        init, device=device, dtype=dtype)
    try:
        return LMTrainJob(cfg, batch_size=B, seq_len=S, n_steps=REF_STEPS, lr=LR, mesh=mesh,
                          device="cpu").run()["history"]
    finally:
        trainjob.lm.init_params = saved


def _one_step(cfg, batch) -> tuple:
    """(loss, {leaf: gradient}) of one process on the whole batch."""
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = steps.loss_fn(leaves, cfg, batch)
    names = [k for k, _ in _leaves(leaves)]
    grads = torch.autograd.grad(loss, [t for _, t in _leaves(leaves)])
    return float(loss.detach()), dict(zip(names, grads))


def _tp_step(cfg, mesh, batch) -> dict:
    """One fp32 step on this rank's shards and rows (``steps.dp_grads``
    under the mesh), the gradients gathered whole."""
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    with msh.use_mesh(mesh):
        pspecs = msh.param_shardings(params, mesh)
        local = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone(), params, pspecs)
        bspecs = shardings.batch_shardings(batch, mesh)
        rows = {k: msh.local_slice(v, bspecs[k], mesh) for k, v in batch.items()}
        loss, _, grads = steps.dp_grads(local, rows, cfg=cfg)
        whole = adamw.tree_map(lambda g, s: msh.gather_leaf(g, s, mesh), grads, pspecs)
    return {"loss": float(loss), "grads": dict(_leaves(whole)),
            "specs": {k: tuple(v) for k, v in _leaves(pspecs)}}


def _remat_step_off_thread(cfg, mesh, batch) -> dict:
    """``_tp_step`` on a (1, 2) mesh (one data rank: the rows are the
    batch) with each group checkpointed, the loss taken on this thread and
    its gradient on another, where no mesh is active: for CUDA tensors the
    autograd engine reruns a checkpointed group on its own thread so."""
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    with msh.use_mesh(mesh):
        pspecs = msh.param_shardings(params, mesh)
        local = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone().requires_grad_(),
                               params, pspecs)
        loss, _ = steps.loss_fn(local, cfg.replace(remat=True), batch)
        flat = adamw.tree_leaves(local)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            grads = pool.submit(torch.autograd.grad, loss, flat).result()
        by_leaf = dict(zip(map(id, flat), grads))
        grads = adamw.tree_map(lambda p, s: msh.gather_leaf(by_leaf[id(p)], s, mesh), local,
                               pspecs)
    return {"loss": float(loss.detach()), "grads": dict(_leaves(grads))}


def _job_out(res, mesh) -> dict:
    opt = res["opt_state"]
    return {"history": res["history"], "params": _host(res["params"]),
            "mu": _host(opt["mu"]), "nu": _host(opt["nu"]), "step": int(opt["step"]),
            "coordinate": mesh.coordinate}


# -- the layout Functions and the vocab-parallel loss, on 2 ranks --------------
def _layouts(rank, mesh) -> dict:
    gen = torch.Generator().manual_seed(5)
    whole = torch.randn(3, 4, 6, generator=gen, dtype=torch.float64)
    up = torch.randn(3, 4, 6, generator=gen, dtype=torch.float64)
    out = {}
    with msh.use_mesh(mesh):
        for name in ("copy", "reduce", "gather", "scatter"):
            x = (whole * (rank + 1) if name == "reduce" else
                 whole.narrow(1, 2 * rank, 2) if name == "gather" else whole).clone()
            x.requires_grad_()
            fn = {"copy": msh.copy, "reduce": msh.reduce,
                  "gather": lambda t: msh.gather(t, 1), "scatter": lambda t: msh.scatter(t, 1)}
            y = fn[name](x)
            g = up * (rank + 1) if name in ("copy", "scatter") else up
            g = g.narrow(1, 2 * rank, 2) if name == "scatter" else g
            y.backward(g)
            out[name] = (y.detach(), x.grad)
        logits = torch.randn(B, S, 64, generator=gen)
        labels = torch.randint(0, 64, (B, S), generator=gen)
        labels[0, :7] = -1
        block = logits.narrow(-1, 32 * rank, 32).clone().requires_grad_()
        loss = steps.vocab_parallel_xent(block, labels)
        loss.backward()
        out["xent"] = (float(loss.detach()), block.grad)
    return out


def test_layout_functions_forward_and_backward(two_ranks):
    """copy: identity, gradients summed; reduce: summed, gradient as it is;
    gather: the blocks on dim 1, backward this rank's block; scatter: this
    rank's block, backward the ranks' gradients on dim 1."""
    gen = torch.Generator().manual_seed(5)
    whole = torch.randn(3, 4, 6, generator=gen, dtype=torch.float64)
    up = torch.randn(3, 4, 6, generator=gen, dtype=torch.float64)
    for r, res in enumerate(two_ranks):
        lay = res["layouts"]
        mine = (slice(None), slice(2 * r, 2 * r + 2))
        want = {"copy": (whole, up * 3), "reduce": (whole * 3, up),
                "gather": (whole, up[mine]), "scatter": (whole[mine], up * torch.tensor(
                    [1.0, 1.0, 2.0, 2.0], dtype=torch.float64)[None, :, None])}
        for name, (y, dx) in want.items():
            assert torch.allclose(lay[name][0], y, rtol=0, atol=1e-12), (r, name)
            assert torch.allclose(lay[name][1], dx, rtol=0, atol=1e-12), (r, name)


def test_vocab_parallel_xent_matches_the_whole_vocabulary(two_ranks):
    gen = torch.Generator().manual_seed(5)
    torch.randn(3, 4, 6, generator=gen, dtype=torch.float64)
    torch.randn(3, 4, 6, generator=gen, dtype=torch.float64)
    logits = torch.randn(B, S, 64, generator=gen).requires_grad_()
    labels = torch.randint(0, 64, (B, S), generator=gen)
    labels[0, :7] = -1
    want = steps.softmax_xent(logits, labels)
    want.backward()
    want = float(want.detach())
    for r, res in enumerate(two_ranks):
        loss, grad = res["layouts"]["xent"]
        assert abs(loss - want) <= XENT_TOL * abs(want)
        assert float((grad - logits.grad.narrow(-1, 32 * r, 32)).abs().max()) <= XENT_TOL


# -- the 2-rank spawn ----------------------------------------------------------
def _two_rank(rank, init, root):
    torch.set_num_threads(1)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    out = {"layouts": _layouts(rank, mesh), "coordinate": mesh.coordinate}
    out["steps"] = {arch: _tp_step(_cfg(arch), mesh, _batch(_cfg(arch)))
                    for arch in SLICE + ["uneven_kv"]}
    cfg = _cfg("granite_3_8b")
    out["remat_off_thread"] = _remat_step_off_thread(cfg, mesh, _batch(cfg))
    # checkpoints between (1, 2) and one process, both ways
    job = functools.partial(LMTrainJob, cfg, batch_size=B, seq_len=S, lr=LR, mesh=mesh,
                            store=ArtifactStore(root), device="cpu")
    out["saved"] = _job_out(job(n_steps=4).run(checkpoint_name="tp"), mesh)
    out["from_one"] = _job_out(job(n_steps=0).run(resume_from="one"), mesh)
    out["from_one_resumed"] = job(n_steps=2).run(resume_from="one")["history"]
    out["fresh"] = _job_out(job(n_steps=0).run(), mesh)
    # a family named nowhere: refused under tp, trained under dp
    out["outside"] = {}
    for arch in OUTSIDE:
        c = _cfg(arch)
        try:
            with _unlisted(c.family):
                LMTrainJob(c, batch_size=2, seq_len=16, n_steps=1, mesh=mesh, device="cpu").run()
            refused = None
        except NotImplementedError as e:
            refused = str(e)
        dp = LMTrainJob(c.replace(sharding_profile="dp"), batch_size=2, seq_len=16, n_steps=1,
                        lr=LR, mesh=mesh, device="cpu").run()["history"]
        out["outside"][arch] = (refused, dp)
    out["ref_job"] = _from_init(init, cfg, mesh)
    return out


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """A one-process granite checkpoint ("one"), 4 steps, for the ranks to load."""
    root = str(tmp_path_factory.mktemp("store"))
    LMTrainJob(_cfg("granite_3_8b"), batch_size=B, seq_len=S, lr=LR, n_steps=4,
               store=ArtifactStore(root), device="cpu").run(checkpoint_name="one")
    return root


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, reference, store_root):
    out = tmp_path_factory.mktemp("ranks2")
    return spawn_ranks(_two_rank, 2, reference["init"][0], store_root, out_dir=out,
                       timeout_s=300)


@pytest.mark.parametrize("arch", SLICE + ["uneven_kv"])
def test_one_step_on_a_1x2_mesh_matches_one_process(two_ranks, arch):
    cfg = _cfg(arch)
    loss, grads = _one_step(cfg, _batch(cfg))
    for res in two_ranks:
        got = res["steps"][arch]
        assert abs(got["loss"] - loss) <= TP_REL * abs(loss)
        _held_grads(got["grads"], grads)
        split = [k for k, s in got["specs"].items() if "model" in s]
        assert any(k.endswith("wq") for k in split) and any(k.endswith("w_down") for k in split)


def test_remat_rerun_on_another_thread_matches_one_process(two_ranks):
    """A checkpointed group rerun in the backward on a thread with no
    active mesh shards as its forward did: loss and every leaf within
    1e-5 of one process."""
    cfg = _cfg("granite_3_8b")
    loss, grads = _one_step(cfg, _batch(cfg))
    for res in two_ranks:
        got = res["remat_off_thread"]
        assert abs(got["loss"] - loss) <= TP_REL * abs(loss)
        _held_grads(got["grads"], grads)


def test_checkpoints_between_a_1x2_mesh_and_one_process(two_ranks, store_root):
    """A (1, 2) checkpoint is the whole tree: one process loads it, each
    rank's shards and moments are its blocks of it, and the two resumed
    trajectories agree within 1e-5; a one-process checkpoint loads on the
    ranks as their blocks of it, bit for bit."""
    job = functools.partial(LMTrainJob, _cfg("granite_3_8b"), batch_size=B, seq_len=S, lr=LR,
                            store=ArtifactStore(store_root), device="cpu")
    for name, key in (("tp", "saved"), ("one", "from_one")):
        whole = job(n_steps=0).run(resume_from=name)
        specs = msh.param_shardings(whole["params"], _mesh12(0))
        for res in two_ranks:
            mesh = _mesh12(res["coordinate"]["model"])
            got = res[key]
            assert got["step"] == int(whole["opt_state"]["step"]) == 4
            for tree, src in (("params", whole["params"]), ("mu", whole["opt_state"]["mu"]),
                              ("nu", whole["opt_state"]["nu"])):
                blocks = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh), src, specs)
                assert _bitwise(blocks, got[tree]) == [], (name, tree)
    resumed = job(n_steps=2).run(resume_from="one")["history"]
    got = two_ranks[0]["from_one_resumed"]
    assert max(abs(a - b) / abs(b) for a, b in zip(got, resumed)) <= TP_REL
    assert two_ranks[1]["from_one_resumed"] == got


def _mesh12(model: int):
    import types
    return types.SimpleNamespace(shape={"data": 1, "model": 2}, axis_names=("data", "model"),
                                 coordinate={"data": 0, "model": model})


def test_each_rank_holds_its_block_of_every_leaf(two_ranks):
    whole = lm.init_params(_cfg("granite_3_8b"), seed=0, device="cpu", dtype=torch.float32)
    specs = msh.param_shardings(whole, _mesh12(0))
    for res in two_ranks:
        mesh = _mesh12(res["coordinate"]["model"])
        blocks = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh), whole, specs)
        assert _bitwise(blocks, res["fresh"]["params"]) == []
        assert sum(t.numel() for _, t in _leaves(res["fresh"]["mu"])) < \
            sum(t.numel() for _, t in _leaves(whole)) * 0.6


@pytest.mark.parametrize("arch", sorted(OUTSIDE))
def test_families_outside_the_slice_refuse_tp_and_train_under_dp(two_ranks, arch):
    """With its family taken out of ``TP_FAMILIES``, under ``tp`` on (1, 2)
    the job raises before any work, naming item 1.13; under ``dp`` on the
    same mesh it trains as one process does (loss rel 1e-5, both ranks
    equal)."""
    cfg = _cfg(arch)
    one = LMTrainJob(cfg, batch_size=2, seq_len=16, n_steps=1, lr=LR, device="cpu").run()
    for res in two_ranks:
        refused, dp = res["outside"][arch]
        assert refused is not None and f"ROADMAP.md queue 1 item {OUTSIDE[arch]}." in refused
        assert abs(dp[0] - one["history"][0]) <= TP_REL * abs(one["history"][0])
    assert two_ranks[0]["outside"][arch][1] == two_ranks[1]["outside"][arch][1]


def test_an_unlisted_family_is_refused_under_tp():
    """The refusal is by an allow-list: a family outside ``TP_FAMILIES``
    that no item names is refused too, under item 1.13."""
    cfg = _cfg("granite_3_8b").replace(family="novel")
    with pytest.raises(NotImplementedError, match=r"queue 1 item 1\.13\b"):
        trainjob._refuse_sharded_params(cfg, msh.abstract_mesh((1, 2), ("data", "model")))
    trainjob._refuse_sharded_params(cfg, msh.abstract_mesh((2, 1), ("data", "model")))


@pytest.mark.parametrize("first,hq,group,want", [
    (0, 16, 4, [0, 1, 2, 3]),           # granite at full width, m 2: kv split with q
    (2, 2, 4, [0]), (4, 2, 4, [1]),     # granite's smoke config, m 4: one kv head
    (7, 7, 7, [1]),                     # qwen2-vl at full width, m 4
    (0, 3, 2, [0, 0, 1]), (3, 3, 2, [1, 2, 2]),   # UNEVEN_KV, m 2
    (8, 8, 3, [2, 3, 3, 3, 4, 4, 4, 5]),          # minitron at full width, m 3
])
def test_kv_heads_of_a_ranks_query_heads(first, hq, group, want):
    assert attention.kv_heads(first, hq, group) == want


def test_constrain_runs_nothing_without_a_model_axis():
    """No mesh, a model axis of 1, or the dp profile: ``constrain`` and the
    four Functions return their input itself (no collective, no graph
    node)."""
    x = torch.ones(2, 3, 4)
    cases = [(None, "tp"), (msh.abstract_mesh((2, 1), ("data", "model")), "tp"),
             (msh.abstract_mesh((1, 2), ("data", "model")), "dp")]
    for mesh, profile in cases:
        with msh.use_mesh(mesh), msh.use_profile(profile):
            assert msh.model_ways() == 1
            assert msh.constrain(x, "batch", None, "model", layout=msh.PARTIAL) is x
            for fn in (msh.copy, msh.reduce, lambda t: msh.gather(t, 1),
                       lambda t: msh.scatter(t, 1)):
                assert fn(x) is x


# -- the 4-rank spawn: (2, 2), (1, 4) and (2, 1, 2) -----------------------------
def _four_rank(rank, init509):
    torch.set_num_threads(1)
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = _cfg("granite_3_8b")
    out["2x2"] = _tp_step(cfg, mesh, _batch(cfg))
    job = functools.partial(LMTrainJob, batch_size=B, seq_len=S, n_steps=4, lr=LR, mesh=mesh,
                            device="cpu")
    out["plain"] = _job_out(job(cfg).run(), mesh)
    out["zero1"] = _job_out(job(cfg.replace(zero1=True)).run(), mesh)

    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    odd = _cfg("granite_3_8b", ODD_VOCAB)
    out["1x4"] = _tp_step(odd, mesh, _batch(odd))
    out["ref_job"] = _from_init(init509, odd, mesh)

    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
    out["2x1x2"] = _tp_step(cfg, mesh, _batch(cfg))
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, reference):
    out = tmp_path_factory.mktemp("ranks4")
    return spawn_ranks(_four_rank, 4, reference["init"][1], out_dir=out, timeout_s=300)


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "2x1x2"])
def test_granite_one_step_on_larger_meshes_matches_one_process(four_ranks, mesh):
    """(2, 2): two data groups of two model ranks; (1, 4) at vocab 509: the
    embedding and the head split on D (509 is odd), wk and wv on D (2 kv
    heads over 4 ranks), so k and v are reduced and each rank slices the kv
    head of its query heads; (2, 1, 2): the batch group is (pod, data)."""
    cfg = _cfg("granite_3_8b", ODD_VOCAB if mesh == "1x4" else 0)
    loss, grads = _one_step(cfg, _batch(cfg))
    for res in four_ranks:
        got = res[mesh]
        assert abs(got["loss"] - loss) <= TP_REL * abs(loss)
        _held_grads(got["grads"], grads)
    specs = four_ranks[0][mesh]["specs"]
    if mesh == "1x4":
        assert specs["embed"] == (None, "model") and specs["lm_head"] == ("model", None)
        assert specs["phase0/slot0/mixer/wk"] == (None, "model", None, None)
        assert specs["phase0/slot0/mixer/wq"] == (None, None, "model", None)
    else:
        assert specs["embed"] == ("model", None) and specs["lm_head"] == (None, "model")


def test_zero1_under_tp_is_bitwise_plain_tp(four_ranks):
    """On (2, 2) ZeRO-1 splits each rank's moments of its shard over data:
    the parameters equal plain TP's bit for bit, and the moments are the
    data coordinate's block of plain TP's."""
    import types
    for r, res in enumerate(four_ranks):
        plain, zero = res["plain"], res["zero1"]
        assert plain["history"] == zero["history"] == four_ranks[0]["plain"]["history"]
        assert _bitwise(plain["params"], zero["params"]) == []
        whole = lm.init_params(_cfg("granite_3_8b"), device="meta", dtype=torch.float32)
        mesh = types.SimpleNamespace(shape={"data": 2, "model": 2},
                                     axis_names=("data", "model"), coordinate=zero["coordinate"])
        specs = shardings.opt_shardings(None, whole, msh.abstract_mesh((2, 2), ("data", "model")),
                                        zero1=True)["mu"]
        for key in ("mu", "nu"):
            blocks = adamw.tree_map(lambda t, s: msh.local_slice(
                t, msh.without_axis(s, "model"), mesh), plain[key], specs)
            assert _bitwise(blocks, zero[key]) == [], (r, key)
    # each data group's model ranks hold other shards; the data peers the same
    by = {(r["plain"]["coordinate"]["data"], r["plain"]["coordinate"]["model"]): r
          for r in four_ranks}
    assert _bitwise(by[(0, 1)]["plain"]["params"], by[(1, 1)]["plain"]["params"]) == []
    assert _bitwise(by[(0, 0)]["plain"]["params"], by[(0, 1)]["plain"]["params"]) != []


# -- against the reference -----------------------------------------------------
_REFERENCE = """
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs import registry
from repro.core.trainjob import LMTrainJob
out = {}
for shape, vocab in ((1, 2), 512), ((1, 4), 509):
    cfg = registry.get_smoke_config("granite_3_8b").replace(vocab_size=vocab)
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
    res = LMTrainJob(cfg, batch_size=%d, seq_len=%d, n_steps=%d, lr=%r, mesh=mesh).run()
    out["x".join(map(str, shape))] = [float(v) for v in res["history"]]
print(json.dumps(out))
""" % (B, S, REF_STEPS, LR)


@pytest.fixture(scope="module")
def reference():
    """The reference's granite job on Auto-axes (1, 2) and (1, 4) meshes of
    4 fake CPU devices (a subprocess: the device count is fixed at JAX's
    start), and its init for vocab 512 and 509, which the port's jobs
    start from.  (``jax.make_mesh`` alone makes Explicit axes under JAX
    0.9, which the reference's sharding code refuses: ROADMAP.md queue 3.)"""
    import jax

    from repro.configs import registry as jreg
    from repro.models import lm as jlm
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    r = subprocess.run([sys.executable, "-c", _REFERENCE], capture_output=True, text=True,
                       timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    init = [jax.tree_util.tree_map(np.asarray, jlm.init_params(
        jax.random.PRNGKey(0), jreg.get_smoke_config("granite_3_8b").replace(vocab_size=v)))
        for v in (512, ODD_VOCAB)]
    return {"history": json.loads(r.stdout.strip().splitlines()[-1]), "init": init}


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_tp_job_matches_the_reference(reference, two_ranks, four_ranks, mesh, capsys):
    want = reference["history"][mesh]
    ranks = two_ranks if mesh == "1x2" else four_ranks
    got = ranks[0]["ref_job"]
    assert len(got) == REF_STEPS and all(r["ref_job"] == got for r in ranks)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    with capsys.disabled():
        print(f"\ntp {mesh} vs the reference's Auto-axes job: losses {got} vs {want}, "
              f"largest rel {rel:.2e}")
    assert rel <= TRAJ_REL
