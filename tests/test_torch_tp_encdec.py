"""Tensor parallelism of enc-dec on the CPU: whisper's encoder and its
decoder's cross-attention trained and served by ``gloo`` ranks on a model
axis, against one process and against the reference.

Two spawns (``tests/_ranks.spawn_ranks``, one torch thread a rank): 2 ranks
on a (1, 2) mesh over ("data", "model"), and 4 ranks that build a (2, 2)
and a (1, 4) mesh in turn.  The rank functions are module-level and this
module imports JAX only inside the reference fixture, so a spawned child
imports it cheaply.  Every run starts from the reference's init
(``lm.init_params(jax.random.PRNGKey(0), cfg)``, transplanted), fp32, and
serves frames drawn from a numpy seed.

Layouts this covers (whisper's smoke config, 4 heads of 16 over 30 encoder
rows, vocabulary 512): on (1, 2) two heads a rank, on (1, 4) one, in the
encoder, the decoder's self-attention and its cross-attention alike (each
rank's ``cross_k``/``cross_v`` its heads' block); and ``two_heads`` on
(1, 4), 2 heads of 32 that do not divide the axis: ``wq``/``wk``/``wv``/
``wo`` sit on D, every rank attends every head, and the cross rows are
whole on every rank, as ``cache_shardings`` places them; and
``odd_vocab`` on (1, 2), 509 ids, which divide no model axis as whisper's
51865 do not: ``embed`` and ``lm_head`` on D, the lookup gathered before
the sinusoid is added and the head's partial sums reduced.

What is held, every rank against one process on its rows:
- one training step (``steps.dp_grads``, the gradients gathered whole):
  the loss and every gradient leaf, the encoder's included, within 1e-5;
  on (1, 2) also with every decoder group checkpointed and the backward
  on a thread where no mesh is active;
- ``steps.prefill``'s last logits and ``steps.serve_step``'s at each of
  GEN teacher-forced steps, over the whole vocabulary, within 1e-5 of the
  largest logit, and ``greedy_decode_loop``'s tokens equal;
- the cache after the prefill and after the GEN steps: every leaf the
  rank's block of one process's whole cache under ``cache_shardings``
  (``local_slice``), shape exact, values within 1e-5, ``enc_len`` whole;
- the reference's ``LMTrainJob`` on Auto-axes (1, 2) and (1, 4) meshes of
  4 fake CPU devices (one subprocess started before the spawns): the
  port's job on the same mesh from the same init, within the trajectory
  tolerance 1e-3; and, in the same subprocess, the reference's one-process
  serving steps (plain path, jitted) on the same init, tokens and frames:
  every (1, 2) rank's logits within 1e-3;
- the dry-run's counting mesh against a real gloo rank for one whisper
  decode step on (1, 2): FLOPs, bytes, ops and collectives by kind and
  axis;
- full-width ``pod`` and ``multi`` records for whisper at decode_32k,
  prefill_32k and train_4k (a subprocess; each counts in a few seconds):
  ``ok``, the useful-FLOP ratio at most 1, a collective term on the model
  axis.
"""
import concurrent.futures
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
from repro_torch.models import steps  # noqa: E402
from repro_torch.models import sharding as msh  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from _ranks import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper_base"
B, S, LR, REF_STEPS = 4, 32, 1e-3, 2              # training
PROMPT, GEN = 12, 4                               # serving
TP_REL, REF_REL, ZERO_LEAF = 1e-5, 1e-3, 1e-6
# smoke variants: two_heads has 2 heads of 32, which do not divide (1, 4);
# odd_vocab's 509 ids divide no axis, as whisper's 51865 do not: the table
# and the head sit on D
VARIANTS = {"whisper_base": {}, "two_heads": dict(n_heads=2, n_kv_heads=2, head_dim=32),
            "odd_vocab": dict(vocab_size=509)}
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
RUNS = {"1x2": ("whisper_base", "odd_vocab"), "2x2": ("whisper_base",),
        "1x4": ("whisper_base", "two_heads")}
CASES = [(m, v) for m, vs in RUNS.items() for v in vs]
REF_JOBS = ("1x2", "1x4")
COUNT_SHAPE = InputShape("d", 24, 4, "decode")
PROD = [(ARCH, s) for s in ("decode_32k", "prefill_32k", "train_4k")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(variant):
    return registry.get_smoke_config(ARCH).replace(dtype="float32", **VARIANTS[variant])


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / (want.float().abs().max() + 1e-12))


def _batch(cfg):
    return {k: torch.as_tensor(v) for k, v in next(tokens.lm_batches(cfg, B, S, seed=3)).items()}


def _serve_inputs(cfg):
    """(prompt (B,PROMPT), decode tokens (B,GEN), frames (B,encoder_len,D))
    from a seed."""
    rng = np.random.default_rng(7)
    return (torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)),
            torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, GEN), dtype=np.int32)),
            torch.from_numpy(rng.standard_normal((B, cfg.encoder_len, cfg.d_model),
                                                 dtype=np.float32)))


def _mesh_rows(mesh):
    rows = torch.arange(B)
    if mesh is None:
        return rows
    return msh.local_slice(rows, shardings.batch_shardings({"r": rows}, mesh)["r"], mesh)


def _grads(params, cfg, batch, off_thread: bool = False):
    """(loss, gradient tree) of one process's step on ``batch``; with
    ``off_thread`` the backward runs on another thread, where no mesh is
    active, as the autograd engine runs a checkpointed group for CUDA
    tensors."""
    leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = steps.loss_fn(leaves, cfg, batch)
    flat = adamw.tree_leaves(leaves)
    if off_thread:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            grads = pool.submit(torch.autograd.grad, loss, flat).result()
    else:
        grads = torch.autograd.grad(loss, flat)
    by_leaf = dict(zip(map(id, flat), grads))
    return loss, adamw.tree_map(lambda p: by_leaf[id(p)], leaves)


def _run(variant, init, mesh=None) -> dict:
    """One training step (and on (1, 2) a checkpointed one with the
    backward off the thread), then prefill, GEN teacher-forced decode
    steps and greedy decoding, on this rank's shards and rows under
    ``mesh`` (one process with none)."""
    cfg = _cfg(variant)
    params = transplant(init, device="cpu", dtype=torch.float32)
    batch = _batch(cfg)
    prompt, dec, frames = _serve_inputs(cfg)
    rows = _mesh_rows(mesh)
    out = {"rows": rows.tolist()}
    with msh.use_mesh(mesh):
        pspecs = None
        if mesh is not None:
            pspecs = msh.param_shardings(params, mesh)
            params = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone(), params,
                                    pspecs)
            out["specs"] = {k: tuple(v) for k, v in _leaves(pspecs)}

        def whole(grads):
            if mesh is not None:
                grads = adamw.tree_map(lambda g, s: msh.gather_leaf(g, s, mesh), grads, pspecs)
            return dict(_leaves(grads))
        # training: this rank's rows of the batch, the gradients gathered whole
        if mesh is None:
            loss, grads = _grads(params, cfg, batch)
        else:
            loss, _, grads = steps.dp_grads(params, {k: v[rows] for k, v in batch.items()},
                                            cfg=cfg)
        out["loss"], out["grads"] = float(loss.detach()), whole(grads)
        if variant == ARCH and (mesh is None or mesh.shape == {"data": 1, "model": 2}):
            loss, grads = _grads(params, cfg.replace(remat=True), batch, off_thread=True)
            out["remat"] = {"loss": float(loss.detach()), "grads": whole(grads)}
        # serving
        prompt, dec, frames = prompt[rows], dec[rows], frames[rows]
        inputs = {"tokens": prompt, "frames": frames}
        with torch.no_grad():
            last, cache = steps.prefill(params, inputs, cfg=cfg, cache_len=PROMPT + GEN)
            out["prefill"] = last
            out["cache"] = {k: v.clone() for k, v in _leaves(cache)}
            pos = steps.start_positions(cfg, len(rows), PROMPT, "cpu")
            out["decode"] = []
            for t in range(GEN):
                logits, cache = steps.serve_step(params, cache, dec[:, t:t + 1], pos + t, cfg=cfg)
                out["decode"].append(logits)
            out["decode_cache"] = dict(_leaves(cache))
            _, cache = steps.prefill(params, inputs, cfg=cfg, cache_len=PROMPT + GEN)
            out["greedy"], _ = steps.greedy_decode_loop(params, cache, dec[:, :1], pos, GEN,
                                                        cfg=cfg)
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
    out = {"1x2": {v: _run(v, inits[v], mesh) for v in RUNS["1x2"]}}
    out["1x2"]["coordinate"] = mesh.coordinate
    with msh.use_mesh(mesh):
        c = dryrun.count_step(_cfg(ARCH).replace(dtype="bfloat16"), COUNT_SHAPE, device="cpu")
    out["count"] = {k: c[k] for k in ("flops", "bytes", "ops", "collectives")}
    out["ref_job"] = _from_init(inits[ARCH], _cfg(ARCH), mesh)
    return out


def _four_rank(rank, inits):
    torch.set_num_threads(1)
    out = {}
    for key in ("2x2", "1x4"):
        mesh = make_mesh(MESHES[key], ("data", "model"), "cpu")
        out[key] = {v: _run(v, inits[v], mesh) for v in RUNS[key]}
        out[key]["coordinate"] = mesh.coordinate
    out["ref_job"] = _from_init(inits[ARCH], _cfg(ARCH), mesh)
    return out


# -- the reference and the production meshes, in subprocesses ---------------------
_REFERENCE = """
import functools, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import registry
from repro.core.trainjob import LMTrainJob
from repro.models import lm, steps
cfg = registry.get_smoke_config("whisper_base").replace(dtype="float32")
out = {"jobs": {}}
for key, shape in (("1x2", (1, 2)), ("1x4", (1, 4))):
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    res = LMTrainJob(cfg, batch_size=%d, seq_len=%d, n_steps=%d, lr=%r, mesh=mesh).run()
    out["jobs"][key] = [float(v) for v in res["history"]]
# the one-process serving steps (plain path, jitted) on the same init, tokens and frames
cfg = cfg.replace(use_kernels=False)
params = lm.init_params(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(7)
prompt = rng.integers(0, cfg.vocab_size, (%d, %d), dtype=np.int32)
dec = rng.integers(0, cfg.vocab_size, (%d, %d), dtype=np.int32)
frames = rng.standard_normal((prompt.shape[0], cfg.encoder_len, cfg.d_model), dtype=np.float32)
last, cache = jax.jit(functools.partial(steps.prefill, cfg=cfg, cache_len=%d))(
    params, {"tokens": jnp.asarray(prompt), "frames": jnp.asarray(frames)})
step = jax.jit(functools.partial(steps.serve_step, cfg=cfg))
logits = [np.asarray(last)]
for t in range(dec.shape[1]):
    lg, cache = step(params, cache, jnp.asarray(dec[:, t:t + 1]),
                     jnp.full((prompt.shape[0],), %d + t, jnp.int32))
    logits.append(np.asarray(lg))
out["serve"] = logits
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
    """The reference's init of each variant, as numpy trees."""
    import jax

    from repro.configs import registry as jreg
    from repro.models import lm as jlm
    return {v: jax.tree_util.tree_map(np.asarray, jlm.init_params(
        jax.random.PRNGKey(0), jreg.get_smoke_config(ARCH).replace(dtype="float32", **kw)))
        for v, kw in VARIANTS.items()}


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
    return {v: _run(v, inits[v]) for v in VARIANTS}


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
    return [f"{m}-{v}" for m, v in cases]


def _held_step(got: dict, want: dict, label) -> None:
    """The loss and every gradient leaf within 1e-5 (a leaf whose whole
    gradient is below 1e-6 of the tree's largest held below that floor,
    as in tests/test_torch_tp.py)."""
    floor = ZERO_LEAF * max(float(g.abs().max()) for g in want["grads"].values())
    assert abs(got["loss"] - want["loss"]) <= TP_REL * abs(want["loss"]), label
    assert got["grads"].keys() == want["grads"].keys()
    bad = {}
    for k, w in want["grads"].items():
        if float(w.abs().max()) < floor:
            if float(got["grads"][k].abs().max()) >= floor:
                bad[k] = "zero leaf"
        elif (r := _rel(got["grads"][k], w)) > TP_REL:
            bad[k] = r
    assert bad == {}, (label, bad)


@pytest.mark.parametrize("mesh,variant", CASES, ids=_ids(CASES))
def test_one_step_matches_one_process(two_ranks, four_ranks, one_process, mesh, variant):
    """The loss and every gradient leaf, the encoder's and the
    cross-attention's included, within 1e-5 of one process."""
    want = one_process[variant]
    assert any(k.startswith("encoder/") for k in want["grads"])
    assert any("/cross/" in k for k in want["grads"])
    for res in _ranks_of(two_ranks, four_ranks, mesh):
        _held_step(res[variant], want, mesh)


def test_checkpointed_step_off_the_thread_matches_one_process(two_ranks, one_process):
    """On (1, 2), every decoder group checkpointed (``cfg.remat``) and the
    backward run on a thread where no mesh is active: the rerun groups
    shard as their forward did (``sharding.bind_active``), and the loss and
    every leaf are within 1e-5 of one process's checkpointed step, itself
    equal to the plain step's within the same bound."""
    want = one_process[ARCH]
    _held_step(want["remat"], want, "one process, checkpointed")
    for res in two_ranks:
        _held_step(res["1x2"][ARCH]["remat"], want["remat"], "1x2, checkpointed")


@pytest.mark.parametrize("mesh,variant", CASES, ids=_ids(CASES))
def test_serving_steps_match_one_process(two_ranks, four_ranks, one_process, mesh, variant):
    """Prefill and decode logits within 1e-5 of one process on the rank's
    rows, over the whole vocabulary (the head's block gathered, or on D
    its partial sums reduced); greedy tokens equal."""
    want = one_process[variant]
    for res in _ranks_of(two_ranks, four_ranks, mesh):
        got = res[variant]
        rows = got["rows"]
        assert got["prefill"].shape[-1] == _cfg(variant).vocab_size
        rel = {"prefill": _rel(got["prefill"], want["prefill"][rows]),
               "decode": max(_rel(g, w[rows]) for g, w in zip(got["decode"], want["decode"]))}
        assert max(rel.values()) <= TP_REL, rel
        assert torch.equal(got["greedy"], want["greedy"][rows])


def _mesh_at(key, coordinate):
    import types
    shape = MESHES[key]
    return types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]},
                                 axis_names=("data", "model"), coordinate=coordinate)


@pytest.mark.parametrize("mesh,variant", CASES, ids=_ids(CASES))
def test_each_rank_holds_its_block_of_the_cache(two_ranks, four_ranks, one_process, mesh,
                                                 variant):
    """After the prefill and after the GEN decode steps, every cache leaf
    is ``local_slice`` of one process's whole cache under
    ``cache_shardings`` at the rank's coordinate: the shape exact, the
    values within 1e-5, ``enc_len`` equal.  ``cross_k``/``cross_v`` hold
    the rank's heads where they divide the axis, else every head."""
    cfg = _cfg(variant)
    m = MESHES[mesh][1]
    heads = cfg.n_heads // m if cfg.n_heads % m == 0 else cfg.n_heads
    for res in _ranks_of(two_ranks, four_ranks, mesh):
        view = _mesh_at(mesh, res["coordinate"])
        for key in ("cache", "decode_cache"):
            whole = one_process[variant][key]
            specs = dict(_leaves(msh.cache_shardings(_nest(whole), view)))
            for k, w in whole.items():
                want = msh.local_slice(w, specs[k], view)
                got = res[variant][key][k]
                assert got.shape == want.shape, (key, k, got.shape, want.shape)
                if k == "enc_len":
                    assert torch.equal(got, want)
                else:
                    assert _rel(got, want) <= TP_REL or float(want.abs().max()) == 0, (key, k)
            shapes = {k.rsplit("/", 1)[-1]: v.shape for k, v in res[variant][key].items()}
            assert shapes["cross_k"][3] == shapes["cross_v"][3] == shapes["k"][3] == heads
            assert shapes["cross_k"][2] == cfg.encoder_len


def test_two_heads_on_1x4_move_the_attention_weights_to_d(four_ranks):
    """2 heads do not divide 4: ``wq``/``wk``/``wv`` (D, H, hd) and ``wo``
    (H, hd, D) of every attention, the cross-attention's and the encoder's
    included, sit on D; the odd vocabulary's table and head on D too."""
    specs = four_ranks[0]["1x4"]["two_heads"]["specs"]
    for where in ("phase0/slot0/mixer", "phase0/slot0/cross", "encoder/mixer"):
        for w in ("wq", "wk", "wv"):
            assert specs[f"{where}/{w}"] == (None, "model", None, None), (where, w)
        assert specs[f"{where}/wo"] == (None, None, None, "model"), where
    specs = four_ranks[0]["1x4"]["whisper_base"]["specs"]
    assert specs["phase0/slot0/cross/wk"] == (None, None, "model", None)


def test_odd_vocabulary_puts_the_table_and_the_head_on_d(two_ranks):
    """509 ids on (1, 2): ``embed`` (V, D) and ``lm_head`` (D, V) on D
    (the lookup gathered, the head's partial sums reduced), as whisper's
    51865 sit on every model axis."""
    specs = two_ranks[0]["1x2"]["odd_vocab"]["specs"]
    assert specs["embed"] == (None, "model") and specs["lm_head"] == ("model", None)


@pytest.mark.parametrize("mesh", REF_JOBS)
def test_tp_job_matches_the_reference(reference, two_ranks, four_ranks, mesh, capsys):
    """The port's ``LMTrainJob`` on the mesh from the reference's init,
    every rank alike, within 1e-3 of the reference's Auto-axes job."""
    want = reference["jobs"][mesh]
    ranks = two_ranks if mesh == "1x2" else four_ranks
    got = ranks[0]["ref_job"]
    assert len(got) == REF_STEPS and all(r["ref_job"] == got for r in ranks)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    with capsys.disabled():
        print(f"\ntp whisper {mesh} vs the reference's Auto-axes job: losses {got} vs "
              f"{want}, largest rel {rel:.2e}")
    assert rel <= REF_REL


def test_serving_on_1x2_matches_the_reference(reference, two_ranks):
    """Every rank's prefill and teacher-forced decode logits on (1, 2)
    within 1e-3 of the reference's one-process serving steps (plain path,
    jitted) on the same init, tokens and frames, on the rank's rows."""
    want = reference["serve"]
    for res in two_ranks:
        got = res["1x2"][ARCH]
        rows = got["rows"]
        for g, w in zip([got["prefill"]] + got["decode"], want):
            assert _rel(g, torch.from_numpy(w)[rows]) <= REF_REL


def test_counting_mesh_counts_what_a_real_rank_counts(two_ranks):
    """One whisper decode step: the dry-run's count on its counting mesh,
    as rank r, equals rank r's count on a real gloo group (FLOPs, bytes,
    ops, collectives by kind and axis): the cross-attention's reductions
    and the embedding's gather on the model axis."""
    for r, res in enumerate(two_ranks):
        with dryrun.counting_mesh((1, 2), ("data", "model"), rank=r) as mesh, \
                msh.use_mesh(mesh):
            c = dryrun.count_step(_cfg(ARCH).replace(dtype="bfloat16"), COUNT_SHAPE)
        assert {k: c[k] for k in ("flops", "bytes", "ops", "collectives")} == res["count"], r
        coll = res["count"]["collectives"]
        assert set(coll["all-reduce"]["by_axis"]) == {"model"}
        assert "model" in coll["all-gather"]["by_axis"]
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
