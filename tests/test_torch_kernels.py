"""Per-kernel parity of the PyTorch port with the JAX reference.

The same inputs, drawn with numpy from a seed, go through the reference's
Pallas kernel (interpret mode, as tests/test_kernels.py runs it on the CPU)
and through the port's dispatch with ``use_kernel=True``.  On a CPU tensor
``ops`` runs the kernel's plain twin, so these tests hold the
twins to the reference; tests/test_torch_gpu.py holds the CUDA / Triton
kernels to the twins on the card.  Tolerances are the
reference's (tests/test_kernels.py:17-19): 3e-4 in fp32, 2e-2 in bf16.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.mlstm_scan import mlstm_scan as jax_mlstm  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as jax_ssm  # noqa: E402
from repro_torch.kernels import native, ops, ref  # noqa: E402
from test_torch_gpu import (DECODE_CASES, FLASH_CASES, MLSTM_CASES,  # noqa: E402
                            RMSNORM_SHAPES, SSM_CASES, bwd_inputs, extreme_decay_inputs,
                            mlstm_inputs, rule_share, ssm_inputs, tol)

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py:83-88, 144

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype_name: str):
    """One numpy array as a JAX array and a CPU torch tensor of the same dtype
    (both round fp32 -> bf16 to nearest even)."""
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# plain twins vs the reference's Pallas kernels (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_matches_reference(shape, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal(shape, dtype=np.float32), dtype)
    sj, st = _pair((rng.standard_normal(shape[-1:]) * 0.1).astype(np.float32), dtype)
    want = jax_rmsnorm(xj, sj, block_rows=8, interpret=True)
    got = ops.rmsnorm(xt, st, use_kernel=True)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **tol(dtype))


@pytest.mark.parametrize("sq,skv,hq,hkv,d,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_reference(sq, skv, hq, hkv, d, window, dtype):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng.standard_normal((2, sq, hq, d), dtype=np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((2, skv, hkv, d), dtype=np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((2, skv, hkv, d), dtype=np.float32), dtype)
    off = skv - sq
    want = jax_flash(qj, kj, vj, causal=True, window=window, q_offset=off,
                     block_q=32, block_k=32, interpret=True)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window, q_offset=off,
                              use_kernel=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol(dtype))


@pytest.mark.parametrize("s,hq,hkv,d,block_k", DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_matches_reference(s, hq, hkv, d, block_k, dtype):
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng.standard_normal((3, hq, d), dtype=np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((3, s, hkv, d), dtype=np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((3, s, hkv, d), dtype=np.float32), dtype)
    lens = np.array([s, s // 2, 1], np.int32)
    want = jax_decode(qj, kj, vj, jnp.asarray(lens), block_k=block_k, interpret=True)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens), use_kernel=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol(dtype))


@pytest.mark.parametrize("split", [16, 64, 256])
@pytest.mark.parametrize("s,hq,hkv,d,block_k", DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_split_form_matches_reference(s, hq, hkv, d, block_k, split, dtype):
    """The decode kernel's split-K algorithm (a partial softmax state per
    split, merged by log-sum-exp) against the reference's Pallas kernel:
    splits past a row's length (lengths s, s//2, 1), a last split cut short
    by S, and one split longer than the cache."""
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng.standard_normal((3, hq, d), dtype=np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((3, s, hkv, d), dtype=np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((3, s, hkv, d), dtype=np.float32), dtype)
    lens = np.array([s, s // 2, 1], np.int32)
    want = jax_decode(qj, kj, vj, jnp.asarray(lens), block_k=block_k, interpret=True)
    got = ref.decode_attention_split_ref(qt, kt, vt, torch.from_numpy(lens), split=split)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **tol(dtype))


def test_decode_split_count_comes_from_the_cache_size_alone():
    """The decode wrapper sizes its grid and scratch from S, never from the
    row lengths, so a decode step reads nothing back from the card."""
    import inspect

    from repro_torch.kernels import decode_attention as dk
    assert [dk.n_splits(s) for s in (0, 1, dk.SPLIT_KEYS, dk.SPLIT_KEYS + 1, 4096)] == \
        [1, 1, 1, 2, -(-4096 // dk.SPLIT_KEYS)]
    body = inspect.getsource(dk.decode_attention)
    assert not any(f in body for f in (".item(", ".tolist(", ".cpu(", ".numpy(", "int(cache_len"))


@pytest.mark.parametrize("s,h,p,n,chunk", SSM_CASES)
def test_ssm_scan_twins_match_reference(s, h, p, n, chunk):
    """The sequential oracle and the chunked twin (ops' plain path) against
    the reference's oracle, its Pallas kernel in interpret mode and its
    chunked jnp twin, fp32."""
    arrays = ssm_inputs(np.random.default_rng(4), 2, s, h, p, n)
    jx = [jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(a) for a in arrays]
    y_o, h_o = jref.ssm_scan_ref(*jx)
    y_k, h_k = jax_ssm(*jx, chunk=chunk, interpret=True)
    y_j, h_j = jops.ssd_chunked_jnp(*jx, chunk=chunk)
    y_r, h_r = ref.ssm_scan_ref(*tx)
    y_t, h_t = ops.ssm_scan(*tx, chunk=chunk, use_kernel=True)     # CPU: the chunked twin
    for got_y, got_h in ((y_r, h_r), (y_t, h_t)):
        assert got_h.dtype == torch.float32
        np.testing.assert_allclose(_f32(got_y), _f32(y_o), **SCAN_TOL)
        np.testing.assert_allclose(_f32(got_h), _f32(h_o), **SCAN_TOL)
    for want_y, want_h in ((y_k, h_k), (y_j, h_j)):
        np.testing.assert_allclose(_f32(y_t), _f32(want_y), **SCAN_TOL)
        np.testing.assert_allclose(_f32(h_t), _f32(want_h), **SCAN_TOL)


def test_ssm_scan_twins_extreme_decay_no_nan():
    """tests/test_kernels.py:91-102: strong decay must not overflow."""
    arrays = extreme_decay_inputs(np.random.default_rng(5))
    tx = [torch.from_numpy(a) for a in arrays]
    y_t, _ = ops.ssd_chunked(*tx, chunk=16)
    assert bool(torch.isfinite(y_t).all())
    y_k, _ = jax_ssm(*(jnp.asarray(a) for a in arrays), chunk=16, interpret=True)
    np.testing.assert_allclose(_f32(y_t), _f32(y_k), **SCAN_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_scan_twin_keeps_dtypes(dtype):
    arrays = ssm_inputs(np.random.default_rng(7), 1, 20, 2, 8, 4)
    pairs = [_pair(a, dtype) for a in arrays]
    (xj, xt), (dj, dtt), (aj, at), (bj, bt), (cj, ct) = pairs
    y_t, h_t = ops.ssm_scan(xt, dtt, at, bt, ct, chunk=8, use_kernel=True)
    y_j, h_j = jops.ssd_chunked_jnp(xj, dj, aj, bj, cj, chunk=8)
    assert y_t.dtype == xt.dtype and h_t.dtype == torch.float32
    np.testing.assert_allclose(_f32(y_t), _f32(y_j), **tol(dtype))
    np.testing.assert_allclose(_f32(h_t), _f32(h_j), **tol(dtype))


@pytest.mark.parametrize("s,h,d,chunk", MLSTM_CASES)
def test_mlstm_scan_twins_match_reference(s, h, d, chunk):
    """The sequential oracle and the chunked twin against the reference's
    oracle and its Pallas kernel in interpret mode, fp32."""
    q, k, v, logi, fpre = mlstm_inputs(np.random.default_rng(6), 2, s, h, d)
    jq, jk, jv, jli, jfp = (jnp.asarray(a) for a in (q, k, v, logi, fpre))
    tq, tk, tv, tli, tfp = (torch.from_numpy(a) for a in (q, k, v, logi, fpre))
    want = jref.mlstm_scan_ref(jq, jk, jv, jli, jfp)
    got_k = jax_mlstm(jq, jk, jv, jli, jax.nn.log_sigmoid(jfp), chunk=chunk, interpret=True)
    logf = torch.nn.functional.logsigmoid(tfp)
    np.testing.assert_allclose(_f32(ref.mlstm_scan_ref(tq, tk, tv, tli, tfp)), _f32(want),
                               **SCAN_TOL)
    got = ops.mlstm_scan(tq, tk, tv, tli, logf, chunk=chunk, use_kernel=True)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **SCAN_TOL)
    np.testing.assert_allclose(_f32(got), _f32(got_k), **SCAN_TOL)


# ---------------------------------------------------------------------------
# the scan kernels' decompositions (the order the bf16 CUDA kernels compute
# in) vs the reference's Pallas kernels and the port's chunked twins (CPU)
# ---------------------------------------------------------------------------
# kernel chunk lengths: 16 and 64 (the CUDA kernels' own), neither of them
# the twin's chunk in every case, and no divisor of S = 50 or 37
SCAN_KERNEL_CHUNKS = [16, 64]


@pytest.mark.parametrize("kchunk", SCAN_KERNEL_CHUNKS)
@pytest.mark.parametrize("s,h,p,n,chunk", SSM_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_chunk_parallel_form_matches_reference(s, h, p, n, chunk, kchunk, dtype):
    """G once per chunk, chunk-local states, then the inter-chunk pass: the
    same y and h_final as the reference's Pallas kernel (interpret mode, at
    the case's own chunk) and the port's chunked twin."""
    arrays = ssm_inputs(np.random.default_rng(4), 2, s, h, p, n)
    pairs = [_pair(a, dtype) for a in arrays]
    jx, tx = [j for j, _ in pairs], [t for _, t in pairs]
    y_k, h_k = jax_ssm(*jx, chunk=chunk, interpret=True)
    y_t, h_t = ops.ssd_chunked(*tx, chunk=chunk)
    y, hf = ref.ssd_chunk_parallel_ref(*tx, chunk=kchunk)
    assert y.dtype == tx[0].dtype and hf.dtype == torch.float32
    for want_y, want_h in ((y_k, h_k), (y_t, h_t)):
        np.testing.assert_allclose(_f32(y), _f32(want_y), **tol(dtype))
        np.testing.assert_allclose(_f32(hf), _f32(want_h), **tol(dtype))


@pytest.mark.parametrize("kchunk", SCAN_KERNEL_CHUNKS)
def test_ssd_chunk_parallel_form_extreme_decay_no_nan(kchunk):
    """The masked exponent keeps extreme decay finite in the kernels' order."""
    arrays = extreme_decay_inputs(np.random.default_rng(5))
    y, hf = ref.ssd_chunk_parallel_ref(*(torch.from_numpy(a) for a in arrays), chunk=kchunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hf).all())
    y_k, h_k = jax_ssm(*(jnp.asarray(a) for a in arrays), chunk=16, interpret=True)
    np.testing.assert_allclose(_f32(y), _f32(y_k), **SCAN_TOL)
    np.testing.assert_allclose(_f32(hf), _f32(h_k), **SCAN_TOL)


@pytest.mark.parametrize("kchunk", SCAN_KERNEL_CHUNKS)
@pytest.mark.parametrize("s,h,d,chunk", MLSTM_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_chunk_parallel_form_matches_reference(s, h, d, chunk, kchunk, dtype):
    """m from a gates-only pre-pass, chunk-parallel scores, then the carry
    walk: the same y as the reference's Pallas kernel (interpret mode) and
    the port's chunked twin."""
    q, k, v, logi, fpre = mlstm_inputs(np.random.default_rng(6), 2, s, h, d)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    logf = np.array(jax.nn.log_sigmoid(jnp.asarray(fpre)))
    want = jax_mlstm(jq, jk, jv, jnp.asarray(logi), jnp.asarray(logf), chunk=chunk,
                     interpret=True)
    tli, tlf = torch.from_numpy(logi), torch.from_numpy(logf)
    twin = ops.mlstm_scan(tq, tk, tv, tli, tlf, chunk=chunk, use_kernel=False)
    got = ref.mlstm_chunk_parallel_ref(tq, tk, tv, tli, tlf, chunk=kchunk)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(twin), **tol(dtype))


@pytest.mark.parametrize("kchunk", SCAN_KERNEL_CHUNKS)
def test_mlstm_chunk_parallel_form_restabilises(kchunk):
    """Strongly negative forget gates and large input gates move the
    stabiliser by tens within and across chunks: the pre-pass's m keeps the
    carry finite and y equal to the sequential oracle's, fp32."""
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal((2, 90, 2, 16), dtype=np.float32) for _ in range(3))
    logi = rng.standard_normal((2, 90, 2), dtype=np.float32) * 4.0
    fpre = rng.standard_normal((2, 90, 2), dtype=np.float32) - 4.0
    tq, tk, tv, tli, tfp = (torch.from_numpy(a) for a in (q, k, v, logi, fpre))
    want = jref.mlstm_scan_ref(*(jnp.asarray(a) for a in (q, k, v, logi, fpre)))
    got = ref.mlstm_chunk_parallel_ref(tq, tk, tv, tli, torch.nn.functional.logsigmoid(tfp),
                                       chunk=kchunk)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_f32(got), _f32(want), **SCAN_TOL)


def test_kernel_order_oracles_stay_off_the_main_path():
    """The kernels' order is a test oracle: no module of the port but ``ref``
    names it."""
    from pathlib import Path
    root = Path(ref.__file__).resolve().parents[1]
    names = ("ssd_chunk_parallel_ref", "mlstm_chunk_parallel_ref", "decode_attention_split_ref")
    users = [str(f.relative_to(root)) for f in root.rglob("*.py")
             if f.name != "ref.py" and any(n in f.read_text() for n in names)]
    assert users == []


def test_flash_attention_scale_argument():
    """``scale`` reaches the twin (the reference's ops lacks it; its MLA
    kernel path depends on it)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 8), dtype=np.float32))
               for _ in range(3))
    a = ops.flash_attention(q, k, v, scale=0.125, use_kernel=True)
    b = ops.flash_attention(q * 0.125 / 8 ** -0.5, k, v, use_kernel=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-5, atol=3e-5)


def test_cpu_wrappers_run_the_twin_and_count_nothing():
    """A CPU tensor goes to the plain twin; only a kernel launch counts."""
    native.reset_launches()
    x = torch.randn(3, 32)
    s = torch.zeros(32)
    assert torch.equal(ops.rmsnorm(x, s, use_kernel=True), ref.rmsnorm_ref(x, s))
    y, _ = ops.ssm_scan(torch.randn(1, 4, 2, 8), torch.rand(1, 4, 2), -torch.rand(2),
                        torch.randn(1, 4, 4), torch.randn(1, 4, 4), use_kernel=True)
    q = torch.randn(1, 4, 2, 8)
    ops.mlstm_scan(q, q, q, torch.zeros(1, 4, 2), torch.zeros(1, 4, 2), use_kernel=True)
    ops.ssm_scan_bwd(torch.randn(1, 4, 2, 8), torch.rand(1, 4, 2), -torch.rand(2),
                     torch.randn(1, 4, 4), torch.randn(1, 4, 4), torch.randn(1, 4, 2, 8),
                     use_kernel=True)
    ops.mlstm_scan_bwd(q, q, q, torch.zeros(1, 4, 2), torch.zeros(1, 4, 2), q, use_kernel=True)
    assert native.LAUNCHES == {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
                               "ssm_scan": 0, "mlstm_scan": 0, "flash_attention_bwd": 0,
                               "rmsnorm_bwd": 0, "ssm_scan_bwd": 0, "mlstm_scan_bwd": 0}


@pytest.mark.parametrize("fn,args", [
    ("rmsnorm", lambda: (torch.empty(2, 8, device="meta"), torch.empty(8, device="meta"))),
    ("flash_attention", lambda: tuple(torch.empty(1, 4, 2, 8, device="meta")
                                      for _ in range(3))),
    ("ssm_scan", lambda: (torch.empty(1, 4, 2, 8, device="meta"),
                          torch.empty(1, 4, 2, device="meta"), torch.empty(2, device="meta"),
                          torch.empty(1, 4, 4, device="meta"),
                          torch.empty(1, 4, 4, device="meta"))),
    ("mlstm_scan", lambda: tuple(torch.empty(1, 4, 2, 8, device="meta") for _ in range(3))
     + tuple(torch.empty(1, 4, 2, device="meta") for _ in range(2))),
    ("ssm_scan_bwd", lambda: (torch.empty(1, 4, 2, 8, device="meta"),
                              torch.empty(1, 4, 2, device="meta"), torch.empty(2, device="meta"),
                              torch.empty(1, 4, 4, device="meta"),
                              torch.empty(1, 4, 4, device="meta"),
                              torch.empty(1, 4, 2, 8, device="meta"))),
    ("mlstm_scan_bwd", lambda: tuple(torch.empty(1, 4, 2, 8, device="meta") for _ in range(3))
     + tuple(torch.empty(1, 4, 2, device="meta") for _ in range(2))
     + (torch.empty(1, 4, 2, 8, device="meta"),)),
])
def test_wrappers_refuse_other_devices(fn, args):
    """Only the CPU selects the twin: any other device launches or raises."""
    with pytest.raises(ValueError, match="no kernel"):
        getattr(ops, fn)(*args(), use_kernel=True)


@pytest.mark.parametrize("module,args", [
    ("rmsnorm", lambda: (torch.randn(2, 8), torch.zeros(8))),
    ("flash_attention", lambda: tuple(torch.randn(1, 4, 2, 8) for _ in range(3))),
    ("decode_attention", lambda: (torch.randn(1, 2, 8), torch.randn(1, 4, 2, 8),
                                  torch.randn(1, 4, 2, 8), torch.full((1,), 4))),
    ("ssm_scan", lambda: (torch.randn(1, 4, 2, 8), torch.rand(1, 4, 2), -torch.rand(2),
                          torch.randn(1, 4, 4), torch.randn(1, 4, 4))),
    ("mlstm_scan", lambda: tuple(torch.randn(1, 4, 2, 8) for _ in range(3))
     + (torch.zeros(1, 4, 2), torch.zeros(1, 4, 2))),
])
def test_kernel_wrappers_never_run_the_twin(module, args):
    """The choice of the twin is made once, in ``ops``: a kernel wrapper given
    a CPU tensor raises instead of computing anything."""
    import importlib
    wrapper = getattr(importlib.import_module(f"repro_torch.kernels.{module}"), module)
    native.reset_launches()
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        wrapper(*args())
    assert native.LAUNCHES[module] == 0


@pytest.mark.parametrize("case,usual", [
    ("one_hot", {"delta": "output", "exact_delta_tiles": 0}),
    ("common_keys", {"delta": "sum_p_dp", "split_dq": False, "centre": "none"})])
def test_flash_backward_order_holds_where_the_usual_orders_miss(case, usual):
    """The bf16 backward kernel's order (``ref.flash_attention_bwd_order_ref``:
    Delta exact in short bands and from the forward's fp32 output beyond,
    the keys centred for dq, dS in two bf16 halves) keeps dq, dk, dv within
    the card's rule against the gradient in fp32.  The usual flash
    backward's orders miss dq there: Delta = rowsum(dO o O) from the bf16
    output carries O's rounding into the small dS of a nearly one-hot row,
    and one bf16 rounding of dS survives the cancellation of dS K."""
    q, k, v, do = bwd_inputs(case)
    want = ref.flash_attention_bwd_ref(q, k, v, do)
    got = ref.flash_attention_bwd_order_ref(q, k, v, do)
    assert max(rule_share(g, w) for g, w in zip(got, want)) <= 1.0
    assert rule_share(ref.flash_attention_bwd_order_ref(q, k, v, do, **usual)[0], want[0]) > 1.0


def bwd_random_inputs(seed: int):
    """bf16 GQA 4:1 inputs at D 128 (B 1, S 512, 8 query heads on 2 kv
    heads), drawn with numpy: eight 64-row query blocks of the kernel, the
    last three of which (causal) take Delta from O32."""
    rng = np.random.default_rng(seed)
    shapes = [(1, 512, 8, 128), (1, 512, 2, 128), (1, 512, 2, 128), (1, 512, 8, 128)]
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
                 for s in shapes)


def bwd_late_one_hot():
    """``bwd_inputs("one_hot")``'s row, but at position 330 (B 1, S 384, 2
    query heads on 1 kv head, D 128): its band spans six key tiles, so the
    kernel takes its Delta from O32."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 384, 2, 128), dtype=np.float32)
    k = rng.standard_normal((1, 384, 1, 128), dtype=np.float32)
    q[0, 330, 0] = k[0, 7, 0]
    v = rng.standard_normal((1, 384, 1, 128), dtype=np.float32)
    do = rng.standard_normal((1, 384, 2, 128), dtype=np.float32)
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))


BWD_ORDER_INPUTS = {"one_hot": lambda: (bwd_inputs("one_hot"), 0),
                    "common_keys": lambda: (bwd_inputs("common_keys"), 0),
                    "late_one_hot": lambda: (bwd_late_one_hot(), 0),
                    "random_causal": lambda: (bwd_random_inputs(1), 0),
                    "random_window": lambda: (bwd_random_inputs(2), 300)}


def _order_shares(name: str, **flags):
    (q, k, v, do), window = BWD_ORDER_INPUTS[name]()
    want = ref.flash_attention_bwd_ref(q, k, v, do, window=window)
    got = ref.flash_attention_bwd_order_ref(q, k, v, do, window=window, **flags)
    return [rule_share(g, w) for g, w in zip(got, want)]


@pytest.mark.parametrize("name", list(BWD_ORDER_INPUTS))
def test_flash_backward_order_within_half_the_rule(name):
    """The kernel's order keeps dq, dk and dv within half the card's rule on
    the hard inputs and on seeded random ones, causal and windowed."""
    assert max(_order_shares(name)) <= 0.5


# (the alternative's flags, input, gradient (0 dq, 1 dk), what it does
# there): "misses" the rule, "worse" within it but above the kernel's order
# (by 0.05 of the rule or more), "within" it
BWD_ORDER_FLAGS = [
    ({"delta": "output"}, "late_one_hot", 0, "misses"),      # O32 holds a long band's one-hot row
    ({"centre": "none", "exact_delta_tiles": 0}, "common_keys", 0, "misses"),
    ({"split_dq": False}, "random_causal", 0, "worse"),
    ({"split_dk": False}, "random_causal", 1, "worse"),
    ({"exact_delta_tiles": 0}, "random_causal", 0, "within"),  # O32 for every row
    ({"delta": "sum_p_dp"}, "random_causal", 0, "within"),     # PR 20's first pass everywhere
    ({"centre": "first"}, "random_window", 0, "within"),
]


@pytest.mark.parametrize("flags,name,grad,effect", BWD_ORDER_FLAGS)
def test_flash_backward_order_flag(flags, name, grad, effect):
    """Each alternative the kernel's order was chosen against, on the input
    where it shows: what it does to dq or dk under the rule."""
    base = _order_shares(name)[grad]
    alt = _order_shares(name, **flags)[grad]
    if effect == "misses":
        assert alt > 1.0
    else:
        assert alt <= 1.0
    if effect == "worse":
        assert alt > base + 0.05
