"""Tensor parallelism of the recurrent mixers on the CPU: zamba2 (Mamba2
with its shared attention block) and xlstm (mLSTM and sLSTM) trained and
served by ``gloo`` ranks on a model axis, against one process and against
the reference.

Two spawns (``tests/_ranks.spawn_ranks``, one torch thread a rank): 2 ranks
on a (1, 2) mesh over ("data", "model"), and 4 ranks that build a (2, 2)
and a (1, 4) mesh in turn.  The rank functions are module-level and this
module imports JAX only inside the reference fixture, so a spawned child
imports it cheaply.  Every run starts from the reference's init
(``lm.init_params(jax.random.PRNGKey(0), cfg)``, transplanted), fp32.

Layouts this covers (smoke configs): zamba2 on (1, 2) has 2 of its 4
heads a rank and a 144-channel conv block against heads of 64 channels,
on (1, 4) one head and a 72-channel block (a head straddles two ranks'
blocks; B and C sit on the last rank's); xlstm on (1, 2) one head of
its 2 a rank, on (1, 4) every head on every rank (q, k, v gathered, the
gate weights ``w_i``/``w_f`` relocated to D and their partial sums
reduced, the state caches whole).

What is held, every rank against one process on its rows:
- one training step (``steps.dp_grads``, the gradients gathered whole):
  the loss and every gradient leaf within 1e-5;
- ``steps.prefill``'s last logits, ``steps.serve_step``'s at each of GEN
  teacher-forced steps and ``lm.prefill_chunk``'s over two chunks, over
  the whole vocabulary, within 1e-5 of the largest logit, and
  ``greedy_decode_loop``'s tokens equal;
- the prefill's cache: every leaf the rank's block of one process's
  whole cache under ``cache_shardings`` (``local_slice``), shape exact,
  values within 1e-5;
- the reference's ``LMTrainJob`` on Auto-axes meshes of 4 fake CPU
  devices (zamba2 on (1, 2), xlstm on (1, 4); one subprocess started
  before the spawns): the port's job on the same mesh from the same init,
  within the trajectory tolerance 1e-3; and, in the same subprocess, the
  reference's one-process serving steps (plain path, jitted) on the same
  init and tokens: every (1, 2) rank's logits within 1e-3;
- the dry-run's counting mesh against a real gloo rank for one zamba2
  decode step on (1, 2): FLOPs, bytes, ops and collectives by kind and
  axis;
- full-width ``pod`` and ``multi`` records for zamba2 and xlstm at
  decode_32k (a subprocess): ``ok``, the useful-FLOP ratio at most 1, a
  collective term on the model axis.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.registry import InputShape  # noqa: E402
from repro_torch.core import trainjob  # noqa: E402
from repro_torch.core.trainjob import LMTrainJob  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.launch import dryrun, shardings  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm, steps  # noqa: E402
from repro_torch.models import sharding as msh  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from _ranks import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("zamba2_1_2b", "xlstm_1_3b")
B, S, LR, REF_STEPS = 4, 32, 2e-3, 2              # training
PROMPT, GEN, CHUNK = 12, 4, 6                     # serving
TP_REL, REF_REL, ZERO_LEAF = 1e-5, 1e-3, 1e-6
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
RUNS = {"1x2": ARCHS, "2x2": ("zamba2_1_2b",), "1x4": ARCHS}
CASES = [(m, a) for m, archs in RUNS.items() for a in archs]
REF_JOBS = {"zamba2_1_2b": "1x2", "xlstm_1_3b": "1x4"}
COUNT_SHAPE = InputShape("d", 24, 4, "decode")
PROD = [(a, "decode_32k") for a in ARCHS]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(arch):
    return registry.get_smoke_config(arch).replace(dtype="float32")


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / (want.float().abs().max() + 1e-12))


def _batch(cfg):
    return {k: torch.as_tensor(v) for k, v in next(tokens.lm_batches(cfg, B, S, seed=3)).items()}


def _serve_inputs(cfg):
    """(prompt (B,PROMPT), decode tokens (B,GEN)) from a seed."""
    rng = np.random.default_rng(7)
    return (torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)),
            torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, GEN), dtype=np.int32)))


def _mesh_rows(mesh):
    rows = torch.arange(B)
    if mesh is None:
        return rows
    return msh.local_slice(rows, shardings.batch_shardings({"r": rows}, mesh)["r"], mesh)


def _run(arch, init, mesh=None) -> dict:
    """One training step, then prefill, GEN teacher-forced decode steps,
    greedy decoding and a two-chunk prefill, on this rank's shards and
    rows under ``mesh`` (one process with none)."""
    cfg = _cfg(arch)
    params = transplant(init, device="cpu", dtype=torch.float32)
    batch = _batch(cfg)
    prompt, dec = _serve_inputs(cfg)
    rows = _mesh_rows(mesh)
    out = {"rows": rows.tolist()}
    with msh.use_mesh(mesh):
        pspecs = None
        if mesh is not None:
            pspecs = msh.param_shardings(params, mesh)
            params = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone(), params,
                                    pspecs)
            out["specs"] = {k: tuple(v) for k, v in _leaves(pspecs)}
        # training: this rank's rows of the batch, the gradients gathered whole
        if mesh is None:
            leaves = dict(_leaves(adamw.tree_map(lambda t: t.detach().requires_grad_(),
                                                 params)))
            loss, _ = steps.loss_fn(_nest(leaves), cfg, batch)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        else:
            loss, _, grads = steps.dp_grads(params, {k: v[rows] for k, v in batch.items()},
                                            cfg=cfg)
            grads = dict(_leaves(adamw.tree_map(lambda g, s: msh.gather_leaf(g, s, mesh),
                                                grads, pspecs)))
        out["loss"], out["grads"] = float(loss.detach()), grads
        # serving
        prompt, dec = prompt[rows], dec[rows]
        b = len(rows)
        with torch.no_grad():
            last, cache = steps.prefill(params, {"tokens": prompt}, cfg=cfg,
                                        cache_len=PROMPT + GEN)
            out["prefill"] = last
            out["cache"] = {k: v.clone() for k, v in _leaves(cache)}
            pos = steps.start_positions(cfg, b, PROMPT, "cpu")
            out["decode"] = []
            for t in range(GEN):
                logits, cache = steps.serve_step(params, cache, dec[:, t:t + 1], pos + t, cfg=cfg)
                out["decode"].append(logits)
            _, cache = steps.prefill(params, {"tokens": prompt}, cfg=cfg, cache_len=PROMPT + GEN)
            out["greedy"], _ = steps.greedy_decode_loop(params, cache, dec[:, :1], pos, GEN,
                                                        cfg=cfg)
            cache = lm.init_cache(cfg, B, PROMPT + GEN, device="cpu")
            out["chunks"] = []
            for c0 in range(0, PROMPT, CHUNK):
                p = torch.arange(c0, c0 + CHUNK, dtype=torch.int32)[None].expand(b, CHUNK)
                logits, cache = lm.prefill_chunk(params, cfg, prompt[:, c0:c0 + CHUNK], p, cache)
                out["chunks"].append(logits)
            out["chunk_cache"] = dict(_leaves(cache))
    return out


def _from_init(init, cfg, mesh) -> list:
    """The losses of the port's job on ``mesh`` from the reference's init."""
    saved = trainjob.lm.init_params
    trainjob.lm.init_params = lambda cfg, seed=0, device="cuda", dtype=None: transplant(
        init, device=device, dtype=dtype)
    try:
        return LMTrainJob(cfg, batch_size=B, seq_len=S, n_steps=REF_STEPS, lr=LR, mesh=mesh,
                          device="cpu").run()["history"]
    finally:
        trainjob.lm.init_params = saved


# -- the spawns ------------------------------------------------------------------
def _two_rank(rank, inits):
    torch.set_num_threads(1)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    out = {"1x2": {a: _run(a, inits[a], mesh) for a in RUNS["1x2"]}}
    out["1x2"]["coordinate"] = mesh.coordinate
    with msh.use_mesh(mesh):
        c = dryrun.count_step(_cfg("zamba2_1_2b").replace(dtype="bfloat16"), COUNT_SHAPE,
                              device="cpu")
    out["count"] = {k: c[k] for k in ("flops", "bytes", "ops", "collectives")}
    out["ref_job"] = _from_init(inits["zamba2_1_2b"], _cfg("zamba2_1_2b"), mesh)
    return out


def _four_rank(rank, inits):
    torch.set_num_threads(1)
    out = {}
    for key in ("2x2", "1x4"):
        mesh = make_mesh(MESHES[key], ("data", "model"), "cpu")
        out[key] = {a: _run(a, inits[a], mesh) for a in RUNS[key]}
        out[key]["coordinate"] = mesh.coordinate
    out["ref_job"] = _from_init(inits["xlstm_1_3b"], _cfg("xlstm_1_3b"), mesh)
    return out


# -- the reference and the production meshes, in subprocesses ---------------------
_REFERENCE = """
import functools, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import registry
from repro.core.trainjob import LMTrainJob
from repro.models import lm, steps
out = {"jobs": {}, "serve": {}}
for arch, shape in (("zamba2_1_2b", (1, 2)), ("xlstm_1_3b", (1, 4))):
    cfg = registry.get_smoke_config(arch).replace(dtype="float32")
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    res = LMTrainJob(cfg, batch_size=%d, seq_len=%d, n_steps=%d, lr=%r, mesh=mesh).run()
    out["jobs"][arch] = [float(v) for v in res["history"]]
    # the one-process serving steps (plain path, jitted) on the same init and tokens
    cfg = cfg.replace(use_kernels=False)
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (%d, %d), dtype=np.int32)
    dec = rng.integers(0, cfg.vocab_size, (%d, %d), dtype=np.int32)
    last, cache = jax.jit(functools.partial(steps.prefill, cfg=cfg, cache_len=%d))(
        params, {"tokens": jnp.asarray(prompt)})
    step = jax.jit(functools.partial(steps.serve_step, cfg=cfg))
    logits = [np.asarray(last)]
    for t in range(dec.shape[1]):
        lg, cache = step(params, cache, jnp.asarray(dec[:, t:t + 1]),
                         jnp.full((prompt.shape[0],), %d + t, jnp.int32))
        logits.append(np.asarray(lg))
    out["serve"][arch] = logits
pickle.dump(out, open(sys.argv[1], "wb"))
""" % (B, S, REF_STEPS, LR, B, PROMPT, B, GEN, PROMPT + GEN, PROMPT)

_PRODUCTION = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
out = {}
for arch, shape in json.loads(sys.argv[1]):
    for mesh in ("single", "pod", "multi"):
        out[f"{arch} {shape} {mesh}"] = dryrun.run_one(arch, shape, mesh)
print(json.dumps(out))
"""


def _env(**extra):
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": "1", **extra}


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The reference's Auto-axes jobs and one-process serving steps, and the
    full-width production-mesh records, each in a subprocess started before
    the spawns."""
    ref_out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    procs = {"ref": subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(ref_out)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4")),
        "prod": subprocess.Popen([sys.executable, "-c", _PRODUCTION, json.dumps(PROD)],
                                 cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True, env=_env()),
        "ref_out": ref_out}
    yield procs
    for p in (procs["ref"], procs["prod"]):
        if p.poll() is None:
            p.kill()
            p.communicate()


def _finish(proc) -> str:
    out, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module")
def inits():
    """The reference's init of each smoke config, as numpy trees."""
    import jax

    from repro.configs import registry as jreg
    from repro.models import lm as jlm
    return {a: jax.tree_util.tree_map(np.asarray, jlm.init_params(
        jax.random.PRNGKey(0), jreg.get_smoke_config(a).replace(dtype="float32")))
        for a in ARCHS}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, background, inits):
    return spawn_ranks(_two_rank, 2, inits, out_dir=tmp_path_factory.mktemp("ranks2"),
                       timeout_s=300)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, two_ranks, inits):
    return spawn_ranks(_four_rank, 4, inits, out_dir=tmp_path_factory.mktemp("ranks4"),
                       timeout_s=300)


@pytest.fixture(scope="module")
def one_process(inits):
    return {a: _run(a, inits[a]) for a in ARCHS}


@pytest.fixture(scope="module")
def reference(background, two_ranks, four_ranks):
    import pickle
    _finish(background["ref"])
    with open(background["ref_out"], "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def production(background, two_ranks, four_ranks):
    return json.loads(_finish(background["prod"]).strip().splitlines()[-1])


def _ranks_of(two_ranks, four_ranks, mesh) -> list:
    if mesh == "1x2":
        return [r["1x2"] for r in two_ranks]
    return [r[mesh] for r in four_ranks]


def _ids(cases):
    return [f"{m}-{a}" for m, a in cases]


@pytest.mark.parametrize("mesh,arch", CASES, ids=_ids(CASES))
def test_one_step_matches_one_process(two_ranks, four_ranks, one_process, mesh, arch):
    """The loss and every gradient leaf within 1e-5 of one process (a
    leaf whose whole gradient is below 1e-6 of the tree's largest held
    below that floor, as in tests/test_torch_tp.py)."""
    want = one_process[arch]
    floor = ZERO_LEAF * max(float(g.abs().max()) for g in want["grads"].values())
    for res in _ranks_of(two_ranks, four_ranks, mesh):
        got = res[arch]
        assert abs(got["loss"] - want["loss"]) <= TP_REL * abs(want["loss"])
        assert got["grads"].keys() == want["grads"].keys()
        bad = {}
        for k, w in want["grads"].items():
            if float(w.abs().max()) < floor:
                if float(got["grads"][k].abs().max()) >= floor:
                    bad[k] = "zero leaf"
            elif (r := _rel(got["grads"][k], w)) > TP_REL:
                bad[k] = r
        assert bad == {}, (mesh, bad)


@pytest.mark.parametrize("mesh,arch", CASES, ids=_ids(CASES))
def test_serving_steps_match_one_process(two_ranks, four_ranks, one_process, mesh, arch):
    """Prefill, decode and chunked-prefill logits within 1e-5 of one
    process on the rank's rows, over the whole vocabulary; greedy tokens
    equal."""
    want = one_process[arch]
    for res in _ranks_of(two_ranks, four_ranks, mesh):
        got = res[arch]
        rows = got["rows"]
        assert got["prefill"].shape[-1] == _cfg(arch).vocab_size
        rel = {"prefill": _rel(got["prefill"], want["prefill"][rows]),
               "decode": max(_rel(g, w[rows]) for g, w in zip(got["decode"], want["decode"])),
               "chunks": max(_rel(g, w[rows]) for g, w in zip(got["chunks"], want["chunks"]))}
        assert max(rel.values()) <= TP_REL, rel
        assert torch.equal(got["greedy"], want["greedy"][rows])


def _mesh_at(key, coordinate):
    import types
    shape = MESHES[key]
    return types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]},
                                 axis_names=("data", "model"), coordinate=coordinate)


@pytest.mark.parametrize("mesh,arch", CASES, ids=_ids(CASES))
def test_each_rank_holds_its_block_of_the_state_cache(two_ranks, four_ranks, one_process,
                                                      mesh, arch):
    """After the prefill and after the chunked prefill, every cache leaf is
    ``local_slice`` of one process's whole cache under ``cache_shardings``
    at the rank's coordinate: the shape exact, the values within 1e-5.
    zamba2's ``conv`` block is its conv_dim channels (288 / m), which
    straddle heads on (1, 4); xlstm's states are whole there (2 heads over
    4 ranks) and split on heads on (1, 2)."""
    cfg = _cfg(arch)
    m = MESHES[mesh][1]
    for res in _ranks_of(two_ranks, four_ranks, mesh):
        view = _mesh_at(mesh, res["coordinate"])
        for key in ("cache", "chunk_cache"):
            whole = one_process[arch][key]
            specs = dict(_leaves(msh.cache_shardings(_nest(whole), view)))
            for k, w in whole.items():
                want = msh.local_slice(w, specs[k], view)
                got = res[arch][key][k]
                assert got.shape == want.shape, (key, k, got.shape, want.shape)
                assert _rel(got, want) <= TP_REL or float(want.abs().max()) == 0, (key, k)
            shapes = {k.rsplit("/", 1)[-1]: v.shape for k, v in res[arch][key].items()
                      if not k.startswith("phase0/shared")}
            if arch == "zamba2_1_2b":
                assert shapes["conv"][-1] == (cfg.d_inner + 2 * cfg.ssm_state) // m
                assert shapes["ssm"][2] == cfg.n_heads // m
            else:
                heads = cfg.n_heads // m if cfg.n_heads % m == 0 else cfg.n_heads
                assert shapes["C"][2] == shapes["c"][2] == heads


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_xlstm_on_1x4_relocates_the_gate_weights_to_d(four_ranks):
    """xlstm's 2 heads do not divide 4: ``w_i``/``w_f`` (D, H) go to D (row
    parallel), the biases stay whole, q/k/v/o weights split on columns
    (a quarter of a head a rank)."""
    specs = four_ranks[0]["1x4"]["xlstm_1_3b"]["specs"]
    for gate in ("w_i", "w_f"):
        assert specs[f"phase0/slot0/mixer/{gate}"] == (None, "model", None)
    assert specs["phase0/slot0/mixer/b_i"] == (None, None)
    assert specs["phase0/slot0/mixer/w_qx"] == (None, None, "model")
    assert specs["phase0/slot1/mixer/r_i"] == (None, None, None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_job_matches_the_reference(reference, two_ranks, four_ranks, arch, capsys):
    """The port's ``LMTrainJob`` on the mesh from the reference's init,
    every rank alike, within 1e-3 of the reference's Auto-axes job."""
    want = reference["jobs"][arch]
    ranks = two_ranks if REF_JOBS[arch] == "1x2" else four_ranks
    got = ranks[0]["ref_job"]
    assert len(got) == REF_STEPS and all(r["ref_job"] == got for r in ranks)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    with capsys.disabled():
        print(f"\ntp {arch} {REF_JOBS[arch]} vs the reference's Auto-axes job: losses {got} vs "
              f"{want}, largest rel {rel:.2e}")
    assert rel <= REF_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_1x2_matches_the_reference(reference, two_ranks, arch):
    """Every rank's prefill and teacher-forced decode logits on (1, 2)
    within 1e-3 of the reference's one-process serving steps (plain path,
    jitted) on the same init and tokens, on the rank's rows."""
    want = reference["serve"][arch]
    for res in two_ranks:
        got = res["1x2"][arch]
        rows = got["rows"]
        for g, w in zip([got["prefill"]] + got["decode"], want):
            assert _rel(g, torch.from_numpy(w)[rows]) <= REF_REL


def test_counting_mesh_counts_what_a_real_rank_counts(two_ranks):
    """One zamba2 decode step: the dry-run's count on its counting mesh,
    as rank r, equals rank r's count on a real gloo group (FLOPs, bytes,
    ops, collectives by kind and axis), with all-gathers and all-reduces
    on the model axis."""
    for r, res in enumerate(two_ranks):
        with dryrun.counting_mesh((1, 2), ("data", "model"), rank=r) as mesh, \
                msh.use_mesh(mesh):
            c = dryrun.count_step(_cfg("zamba2_1_2b").replace(dtype="bfloat16"), COUNT_SHAPE)
        assert {k: c[k] for k in ("flops", "bytes", "ops", "collectives")} == res["count"], r
        coll = res["count"]["collectives"]
        assert "model" in coll["all-gather"]["by_axis"] and "model" in coll["all-reduce"]["by_axis"]
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape", PROD, ids=[f"{a}-{s}" for a, s in PROD])
def test_production_mesh_records(production, arch, shape):
    """Full width on pod (256 cards) and multi (512): ok, the useful-FLOP
    ratio at most 1, a collective term over the model axis, and the held
    bytes a card below one card's."""
    one = production[f"{arch} {shape} single"]
    assert one["status"] == "ok", one
    for mesh, chips in (("pod", 256), ("multi", 512)):
        rec = production[f"{arch} {shape} {mesh}"]
        assert rec["status"] == "ok", rec
        assert rec["chips"] == chips and rec["useful_flops_ratio"] <= 1 + 1e-6
        assert rec["roofline"]["coll_bytes"] > 0
        assert any("model" in c["by_axis"] for c in rec["collectives"].values())
        assert 0 < rec["memory"]["total_bytes"] < one["memory"]["total_bytes"]


def test_only_enc_dec_and_unlisted_families_refuse_tp():
    """The allow-list holds the SSM and hybrid families, and since enc-dec
    joined it every family of the registry: under ``tp`` on a model axis
    of 2 none refuses, and no item is left in ``TP_ITEMS``; a family named
    nowhere still refuses, under item 1.13."""
    mesh = msh.abstract_mesh((1, 2), ("data", "model"))
    with msh.use_mesh(mesh):
        for arch in registry.list_archs():
            msh.refuse_outside_tp(registry.get_smoke_config(arch), "test")
        with pytest.raises(NotImplementedError, match=r"item 1\.13\b"):
            msh.refuse_outside_tp(registry.get_smoke_config("xlstm_1_3b").replace(
                family="novel"), "test")
    assert msh.TP_ITEMS == {}
