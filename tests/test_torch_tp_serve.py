"""Tensor-parallel serving on the CPU: ``gloo`` ranks on a model axis
against one process and against the reference, and the dry-run's per-card
counts on a mesh that lives in one process against a real rank's.

Two spawns (``tests/_ranks.spawn_ranks``, one torch thread a rank): 2 ranks
on a (1, 2) mesh over ("data", "model"), and 4 ranks that build a (2, 2), a
(1, 4) and a (2, 1, 2) mesh over ("pod", "data", "model") in turn.  The
rank functions are module-level and this module imports JAX only inside
the reference fixture, so a spawned child imports it cheaply.

What is held, each at a smoke config in fp32 on the same weights and
tokens (the port's init, drawn from a seed):
- ``steps.prefill``'s last logits, ``steps.serve_step``'s logits at each
  of GEN teacher-forced decode steps, and ``lm.prefill_chunk``'s logits
  over a prompt in two chunks, every rank (its rows of the batch, the
  whole vocabulary) against one process within 1e-5 of the largest
  logit, and ``greedy_decode_loop``'s tokens equal: the seven archs of
  ``sharding.TP_FAMILIES`` on (1, 2), with a granite whose 3 kv heads do
  not divide the axis (one kv head a query head) and a deepseek with 3
  heads (MLA's queries relocated to D, ``w_uk`` and ``w_uv`` to r);
  granite and granite-moe on (2, 2), (1, 4) (granite's 2 kv heads stay
  whole, each rank reading its query heads' one as a view) and (2, 1, 2);
  and on (1, 4) a granite with 6 query heads, which do not divide the
  axis (the attention repeated whole on every rank);
- each rank's cache block: its rows, its kv heads where they divide;
- the reference's one-process ``steps.prefill`` and ``steps.serve_step``
  (plain path, jitted, in a subprocess started before the ranks) on the
  same weights and tokens: every rank's logits within 1e-3;
- ``launch/dryrun.py``'s count of a decode, a prefill and a training step
  on its counting mesh (a ``fake`` group of the same shape in this
  process, ``meta`` tensors) equal to the count a real gloo rank takes of
  the same step: FLOPs, bytes, ops and collectives by kind and axis, on
  (1, 2) and (2, 2), every rank;
- a family that tensor parallelism does not list (whisper's, taken out
  of ``TP_FAMILIES`` in the rank: item 1.13) refusing the serving steps
  under ``tp`` on (1, 2), and serving under ``dp`` as one process does
  (zamba2 and xlstm serve under ``tp``: tests/test_torch_tp_ssm.py;
  whisper: tests/test_torch_tp_encdec.py);
- full-width dry-run records on the production meshes (``pod``, 16 x 16,
  and ``multi``, 2 x 16 x 16; a subprocess an arch, started with the
  ranks):
  granite, qwen2-vl and deepseek at decode_32k and train_4k are ``ok``,
  their ``useful_flops_ratio`` at most 1, per-card FLOPs times the cards
  at least one card's count, a collective term and the held bytes a card;
  and no process group is left behind by ``run_one``.
"""
import json
import os
import subprocess
import sys
from unittest import mock
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.registry import InputShape  # noqa: E402
from repro_torch.launch import dryrun, shardings  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm, steps  # noqa: E402
from repro_torch.models import sharding as msh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

from _ranks import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, GEN, CHUNK = 4, 12, 8, 6
TP_REL, REF_REL = 1e-5, 1e-3
SLICE = ["granite_3_8b", "h2o_danube_3_4b", "minitron_4b", "gemma3_4b", "qwen2_vl_7b",
         "granite_moe_3b_a800m", "deepseek_v2_lite_16b"]
# smoke variants: (arch, overrides).  uneven_kv: 6 query heads over 3 kv
# heads, on (1, 2) each rank's 3 query heads read kv heads (0, 0, 1) and
# (1, 2, 2); mla_on_r: 3 heads, on (1, 2) MLA's queries relocate to D and
# w_uk, w_uv to r; odd_q: 6 query heads over 2 kv heads, on (1, 4) neither
# divides and the attention runs whole on every rank
VARIANTS = {"uneven_kv": ("granite_3_8b", dict(d_model=96, n_heads=6, n_kv_heads=3)),
            "mla_on_r": ("deepseek_v2_lite_16b", dict(n_heads=3, n_kv_heads=3)),
            "odd_q": ("granite_3_8b", dict(d_model=96, n_heads=6, n_kv_heads=2))}
TWO = SLICE + ["uneven_kv", "mla_on_r"]
FOUR = {"2x2": ["granite_3_8b", "granite_moe_3b_a800m"],
        "1x4": ["granite_3_8b", "granite_moe_3b_a800m", "odd_q"],
        "2x1x2": ["granite_3_8b", "granite_moe_3b_a800m"]}
MESHES = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")), "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# an arch whose family is taken out of TP_FAMILIES -> the item it is refused under
OUTSIDE = {"whisper_base": "1.13"}
# the dry-run's count on a counting mesh against a real rank: (arch, kind)
COUNTED = [("granite_3_8b", "decode"), ("granite_3_8b", "prefill"), ("granite_3_8b", "train"),
           ("granite_moe_3b_a800m", "decode")]
COUNT_SHAPE = {"decode": InputShape("d", 24, 4, "decode"),
               "prefill": InputShape("p", 16, 4, "prefill"),
               "train": InputShape("t", 16, 4, "train")}
# full width on the production meshes
PROD = [(a, s) for a in ("granite_3_8b", "qwen2_vl_7b", "deepseek_v2_lite_16b")
        for s in ("decode_32k", "train_4k")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(name):
    arch, over = VARIANTS.get(name, (name, {}))
    return registry.get_smoke_config(arch).replace(dtype="float32", **over)


def _inputs(cfg):
    """(prompt (B,S), decode tokens (B,GEN)) from a seed."""
    rng = np.random.default_rng(7)
    return (torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)),
            torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, GEN), dtype=np.int32)))


def _serve(cfg, mesh=None) -> dict:
    """Prefill, GEN teacher-forced decode steps, greedy decoding and a
    two-chunk prefill, on this rank's shards and rows under ``mesh`` (one
    process with none)."""
    params = lm.init_params(cfg, seed=0, device="cpu")
    prompt, dec = _inputs(cfg)
    rows = torch.arange(B)
    with msh.use_mesh(mesh):
        if mesh is not None:
            pspecs = msh.param_shardings(params, mesh)
            params = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone(), params,
                                    pspecs)
            rows = msh.local_slice(rows, shardings.batch_shardings({"r": rows}, mesh)["r"], mesh)
        prompt, dec = prompt[rows], dec[rows]
        b = len(rows)
        batch = steps.batch_inputs(cfg, prompt)
        last, cache = steps.prefill(params, batch, cfg=cfg, cache_len=S + GEN)
        out = {"rows": rows.tolist(), "prefill": last}
        pos = steps.start_positions(cfg, b, S, "cpu")
        decode = []
        for t in range(GEN):
            logits, cache = steps.serve_step(params, cache, dec[:, t:t + 1], pos + t, cfg=cfg)
            decode.append(logits)
        out["decode"] = decode
        _, cache = steps.prefill(params, batch, cfg=cfg, cache_len=S + GEN)
        out["greedy"], _ = steps.greedy_decode_loop(params, cache, dec[:, :1], pos, GEN, cfg=cfg)
        cache = lm.init_cache(cfg, B, S + GEN, device="cpu")
        out["cache_shapes"] = _shapes(cache)
        chunks = []
        for c0 in range(0, S, CHUNK):
            p = torch.arange(c0, c0 + CHUNK, dtype=torch.int32)[None].expand(b, CHUNK)
            if cfg.use_mrope:
                p = p[:, None].expand(b, 3, CHUNK)
            logits, cache = lm.prefill_chunk(params, cfg, prompt[:, c0:c0 + CHUNK], p, cache)
            chunks.append(logits)
        out["chunks"] = chunks
    return out


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def _count(cfg, kind, device) -> dict:
    """``dryrun.count_step`` of one smoke step under the active mesh."""
    c = dryrun.count_step(cfg.replace(dtype="bfloat16"), COUNT_SHAPE[kind], device=device)
    return {k: c[k] for k in ("flops", "bytes", "ops", "collectives")}


def _counts(mesh) -> dict:
    with msh.use_mesh(mesh):
        return {f"{a} {k}": _count(_cfg(a), k, "cpu") for a, k in COUNTED}


def _outside(mesh) -> dict:
    """Each outside arch's refusal under tp on ``mesh`` with its family
    taken out of ``TP_FAMILIES``, and its serving under dp (its rows' last
    logits)."""
    out = {}
    for arch in OUTSIDE:
        cfg = _cfg(arch)
        params = lm.init_params(cfg, seed=0, device="cpu")
        prompt, _ = _inputs(cfg)
        refused = []
        unlisted = tuple(f for f in msh.TP_FAMILIES if f != cfg.family)
        with msh.use_mesh(mesh), mock.patch.object(msh, "TP_FAMILIES", unlisted):
            for name, fn in (("prefill", lambda: steps.prefill(
                    params, steps.batch_inputs(cfg, prompt), cfg=cfg)),
                    ("serve_step", lambda: steps.serve_step(
                        params, lm.init_cache(cfg, B, S, device="cpu"), prompt[:, :1],
                        steps.start_positions(cfg, B, 0, "cpu"), cfg=cfg))):
                try:
                    fn()
                    refused.append((name, None))
                except NotImplementedError as e:
                    refused.append((name, str(e)))
            with msh.use_profile("dp"):
                rows = msh.local_slice(torch.arange(B), shardings.batch_shardings(
                    {"r": torch.arange(B)}, mesh)["r"], mesh)
                last, _ = steps.prefill(params, steps.batch_inputs(cfg, prompt[rows]), cfg=cfg)
        out[arch] = {"refused": refused, "dp_rows": rows.tolist(), "dp": last}
    return out


# -- the spawns ------------------------------------------------------------------
def _two_rank(rank):
    torch.set_num_threads(1)
    mesh = make_mesh(*MESHES["1x2"], "cpu")
    out = {"coordinate": mesh.coordinate, "serve": {n: _serve(_cfg(n), mesh) for n in TWO}}
    out["counts"] = _counts(mesh)
    out["outside"] = _outside(mesh)
    return out


def _four_rank(rank):
    torch.set_num_threads(1)
    out = {}
    for key, names in FOUR.items():
        mesh = make_mesh(*MESHES[key], "cpu")
        out[key] = {"coordinate": mesh.coordinate,
                    "serve": {n: _serve(_cfg(n), mesh) for n in names}}
        if key == "2x2":
            out[key]["counts"] = _counts(mesh)
    return out


# -- the reference and the production meshes, in subprocesses ---------------------
_REFERENCE = """
import functools, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.models import steps
cases = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, (arch, over, params, prompt, dec, batch) in cases.items():
    cfg = registry.get_smoke_config(arch).replace(dtype="float32", use_kernels=False, **over)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    last, cache = jax.jit(functools.partial(steps.prefill, cfg=cfg, cache_len=%d))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    step = jax.jit(functools.partial(steps.serve_step, cfg=cfg))
    logits = [np.asarray(last)]
    b = prompt.shape[0]
    for t in range(dec.shape[1]):
        pos = jnp.full((b, 3) if cfg.use_mrope else (b,), %d + t, jnp.int32)
        lg, cache = step(params, cache, jnp.asarray(dec[:, t:t + 1]), pos)
        logits.append(np.asarray(lg))
    out[name] = logits
pickle.dump(out, open(sys.argv[2], "wb"))
""" % (S + GEN, S)

_PRODUCTION = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
cells = json.loads(sys.argv[1])
out = {}
for arch, shape in cells:
    for mesh in ("single", "pod", "multi"):
        rec = dryrun.run_one(arch, shape, mesh)
        out[f"{arch} {shape} {mesh}"] = rec
print(json.dumps(out))
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The reference's serving runs and the full-width production-mesh
    records, each in a subprocess started before the spawns."""
    import pickle
    d = tmp_path_factory.mktemp("bg")
    cases = {}
    for name in TWO:
        cfg = _cfg(name)
        arch, over = VARIANTS.get(name, (name, {}))
        params = adamw.tree_map(lambda t: t.numpy(), lm.init_params(cfg, seed=0, device="cpu"))
        prompt, dec = _inputs(cfg)
        batch = {k: v.numpy() for k, v in steps.batch_inputs(cfg, prompt).items()}
        cases[name] = (arch, over, params, prompt.numpy(), dec.numpy(), batch)
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(d / "cases.pkl"),
                            str(d / "ref.pkl")], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    prod = [subprocess.Popen([sys.executable, "-c", _PRODUCTION,
                              json.dumps([c for c in PROD if c[0] == arch])], cwd=ROOT,
                             env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for arch in sorted({a for a, _ in PROD})]
    yield {"ref": (ref, d / "ref.pkl"), "prod": prod}
    for p in [ref] + prod:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def reference(background, two_ranks, four_ranks):
    import pickle
    proc, path = background["ref"]
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def production(background, two_ranks, four_ranks):
    recs = {}
    for proc in background["prod"]:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        recs.update(json.loads(out.strip().splitlines()[-1]))
    return recs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, background):
    return spawn_ranks(_two_rank, 2, out_dir=tmp_path_factory.mktemp("ranks2"), timeout_s=300)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, two_ranks):
    return spawn_ranks(_four_rank, 4, out_dir=tmp_path_factory.mktemp("ranks4"), timeout_s=300)


@pytest.fixture(scope="module")
def one_process():
    names = set(TWO) | {n for names in FOUR.values() for n in names}
    return {n: _serve(_cfg(n)) for n in sorted(names)}


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / (want.float().abs().max() + 1e-12))


def _held(got: dict, want: dict) -> dict:
    """The largest rel error of each phase of a rank's run against one
    process's (on the rank's rows)."""
    rows = got["rows"]
    return {"prefill": _rel(got["prefill"], want["prefill"][rows]),
            "decode": max(_rel(g, w[rows]) for g, w in zip(got["decode"], want["decode"])),
            "chunks": max(_rel(g, w[rows]) for g, w in zip(got["chunks"], want["chunks"]))}


def _ranks_of(two_ranks, four_ranks, key):
    return two_ranks if key == "1x2" else [r[key] for r in four_ranks]


CASES = [("1x2", n) for n in TWO] + [(k, n) for k, names in FOUR.items() for n in names]


@pytest.mark.parametrize("mesh,name", CASES, ids=[f"{m}-{n}" for m, n in CASES])
def test_serving_steps_match_one_process(two_ranks, four_ranks, one_process, mesh, name):
    """Every rank's prefill, decode and chunked-prefill logits within 1e-5
    of one process on its rows, over the whole vocabulary, and its greedy
    tokens equal."""
    want = one_process[name]
    for res in _ranks_of(two_ranks, four_ranks, mesh):
        got = res["serve"][name]
        assert got["prefill"].shape[-1] == _cfg(name).vocab_size
        rel = _held(got, want)
        assert max(rel.values()) <= TP_REL, (res["coordinate"], rel)
        assert torch.equal(got["greedy"], want["greedy"][got["rows"]]), res["coordinate"]


@pytest.mark.parametrize("mesh,name", CASES, ids=[f"{m}-{n}" for m, n in CASES])
def test_each_rank_holds_its_block_of_the_cache(two_ranks, four_ranks, mesh, name):
    """``lm.init_cache`` under the mesh: every leaf its rows of the batch
    and, for k and v, its kv heads where they divide the model axis (the
    whole cache's shape under ``cache_shardings``)."""
    cfg = _cfg(name)
    sizes = dict(zip(*reversed(MESHES[mesh])))
    m = sizes["model"]
    rows = B * m // int(np.prod(list(sizes.values())))
    whole = _shapes(lm.init_cache(cfg, B, S + GEN, device="meta"))
    for res in _ranks_of(two_ranks, four_ranks, mesh):
        got = res["serve"][name]["cache_shapes"]
        assert got.keys() == whole.keys()
        for k, w in whole.items():
            want = list(w)
            want[1] = rows
            if k.rsplit("/", 1)[-1] in ("k", "v") and w[3] % m == 0:
                want[3] = w[3] // m
            assert got[k] == tuple(want), (k, got[k], want)


@pytest.mark.parametrize("name", TWO)
def test_serving_on_1x2_matches_the_reference(two_ranks, reference, name):
    """Every rank's prefill and decode logits within 1e-3 of the
    reference's one-process steps on the same weights and tokens."""
    want = reference[name]
    for res in two_ranks:
        got = res["serve"][name]
        rows = got["rows"]
        for g, w in zip([got["prefill"]] + got["decode"], want):
            assert _rel(g, torch.from_numpy(w)[rows]) <= REF_REL


def _counting_mesh_count(key, rank) -> dict:
    with dryrun.counting_mesh(*MESHES[key], rank=rank) as mesh, msh.use_mesh(mesh):
        return {f"{a} {k}": _count(_cfg(a), k, "meta") for a, k in COUNTED}


@pytest.mark.parametrize("key", ["1x2", "2x2"])
def test_counting_mesh_counts_what_a_real_rank_counts(two_ranks, four_ranks, key):
    """The dry-run's count on its counting mesh, as rank r, equals rank r's
    count of the same step on a real gloo group: FLOPs, bytes, ops and the
    collectives by kind and axis; a collective ran on the model axis."""
    ranks = two_ranks if key == "1x2" else [r for r in four_ranks]
    for r, res in enumerate(ranks):
        real = res["counts"] if key == "1x2" else res["2x2"]["counts"]
        assert _counting_mesh_count(key, r) == real, r
        assert "model" in real["granite_3_8b decode"]["collectives"]["all-reduce"]["by_axis"]
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", sorted(OUTSIDE))
def test_families_outside_the_slice_refuse_tp_serving_and_serve_under_dp(two_ranks, arch):
    """whisper with its family taken out of ``TP_FAMILIES`` (1.13):
    ``steps.prefill`` and ``steps.serve_step`` under ``tp`` on (1, 2)
    raise naming the item; under ``dp`` each rank serves its rows as one
    process does."""
    cfg = _cfg(arch)
    prompt, _ = _inputs(cfg)
    one, _ = steps.prefill(lm.init_params(cfg, seed=0, device="cpu"),
                           steps.batch_inputs(cfg, prompt), cfg=cfg)
    for res in two_ranks:
        got = res["outside"][arch]
        for name, msg in got["refused"]:
            assert msg is not None and f"ROADMAP.md queue 1 item {OUTSIDE[arch]}." in msg, name
        assert _rel(got["dp"], one[got["dp_rows"]]) <= TP_REL


@pytest.mark.parametrize("arch,shape", PROD, ids=[f"{a}-{s}" for a, s in PROD])
def test_production_mesh_records(production, arch, shape):
    """Full width on pod (256 cards) and multi (512): ok, the useful-FLOP
    ratio at most 1, per-card FLOPs times the cards at least one card's
    count, a collective term over the model axis, the held bytes a card
    and whether they fit."""
    one = production[f"{arch} {shape} single"]
    assert one["status"] == "ok", one
    for mesh, chips in (("pod", 256), ("multi", 512)):
        rec = production[f"{arch} {shape} {mesh}"]
        assert rec["status"] == "ok", rec
        t = rec["roofline"]
        assert rec["chips"] == chips and t["chips"] == chips
        assert rec["useful_flops_ratio"] <= 1 + 1e-6
        assert t["flops"] * chips >= one["roofline"]["flops"]
        assert t["coll_bytes"] > 0 and t["collective_s"] > 0
        assert any("model" in by for c in rec["collectives"].values() for by in c["by_axis"])
        mem = rec["memory"]
        assert 0 < mem["total_bytes"] < one["memory"]["total_bytes"]
        assert mem["fits"] == (mem["total_bytes"] <= mem["hbm_bytes"])


def test_run_one_leaves_no_process_group(monkeypatch):
    """A counted mesh, an error record on one (whisper with its family
    taken out of ``TP_FAMILIES``) and a one-card count: no process group
    remains in the calling process."""
    assert dryrun.run_one("granite_3_8b", "decode_32k", "pod", smoke=True)["status"] == "ok"
    assert not dist.is_initialized()
    monkeypatch.setattr(msh, "TP_FAMILIES", tuple(f for f in msh.TP_FAMILIES if f != "audio"))
    rec = dryrun.run_one("whisper_base", "decode_32k", "multi", smoke=True)
    assert rec["status"] == "error" and "item 1.13." in rec["error"]
    assert not dist.is_initialized()
    assert dryrun.run_one("whisper_base", "decode_32k", "multi", smoke=True,
                          profile="dp")["status"] == "ok"
    assert not dist.is_initialized()


def test_decode_wrapper_reads_a_range_of_cache_heads_in_place():
    """The decode wrapper's layout rule (``decode_attention._row_heads``):
    a contiguous cache, and a ``narrow`` of its heads (a rank's kv heads
    in a cache whole on every rank), pass to the kernel as they are, with
    the heads a row holds; a cut of its rows, whose batch rows are not S
    rows apart, is made contiguous (None)."""
    from repro_torch.kernels import decode_attention as dec
    cache = torch.zeros(2, 9, 8, 16)
    assert dec._row_heads(cache) == 8
    assert dec._row_heads(cache.narrow(2, 3, 2)) == 8
    assert dec._row_heads(cache[:, :5]) is None
    assert dec._row_heads(cache[:1, :5].narrow(2, 7, 1)) == 8
    assert dec._row_heads(cache.transpose(2, 3)[..., :8, :]) is None
