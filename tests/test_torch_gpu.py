"""The port's CUDA / Triton kernels against their plain twins, on the card.

Marked ``gpu``: without an NVIDIA GPU every test skips.  This file imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The shapes are those of tests/test_kernels.py, which test_torch_kernels.py
also uses to hold the twins to the JAX reference; the tolerances are the
reference's (tests/test_kernels.py:17-19): 3e-4 in fp32, 2e-2 in bf16.
The backward kernels (flash attention, RMSNorm) are held to autograd of
their twins at the same tolerances, and a smoke model's gradients through
the kernels to its plain path's; the kernels without a backward must
raise under grad.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import native, ops, ref  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the last is h2o_danube's width (3840), which no power of two matches
RMSNORM_SHAPES = [(4, 64), (3, 17, 128), (2, 5, 7, 96), (5, 3840)]
# (sq, skv, hq, hkv, d, window); q_offset = skv - sq
FLASH_CASES = [
    (64, 64, 4, 4, 32, 0),        # MHA causal
    (100, 100, 4, 2, 32, 0),      # GQA, Sq no block divides
    (64, 64, 8, 2, 64, 24),       # sliding window
    (33, 128, 4, 4, 32, 0),       # cross-length, q_offset 95
    (40, 72, 2, 1, 320, 24),      # gemma3's head dim: window, ragged tail, q_offset 32
]
# and on the card only: D 16 (the smoke configs), D 120 (h2o_danube, zero-
# padded to the 128-column tile), D 17 (not a whole number of 16-byte
# vectors: the plain-load staging), S 300 with a window and a q_offset,
# and h2o_danube's D 120 under a window that binds (kv longer than it);
# gemma3's D 320 (group 2) under its window of 1024 with the keys longer
# than it, and under a short window with a q_offset; D 300, zero-padded to
# the 320-column tile and (bf16) no whole number of 16-byte vectors
FLASH_GPU_CASES = FLASH_CASES + [
    (70, 70, 8, 2, 16, 0),
    (50, 90, 4, 4, 120, 0),
    (40, 40, 2, 1, 17, 0),
    (300, 364, 4, 2, 128, 100),
    (600, 600, 4, 2, 120, 256),
    (1100, 1100, 8, 4, 320, 1024),
    (300, 364, 8, 4, 320, 100),
    (130, 130, 4, 2, 300, 0),
]
# (s, hq, hkv, d, reference block_k); lengths [s, s//2, 1]
DECODE_CASES = [(128, 4, 4, 32, 64), (200, 8, 2, 64, 64), (64, 4, 1, 128, 32),
                (96, 4, 2, 320, 32)]
# (lengths, s, hq, hkv, d) on the card, around the kernel's split of
# SPLIT_KEYS = 512 keys: lengths at the split edges with S no multiple of
# it; a 4096-row cache whose merge takes 8 splits; granite's serving shape
# (one split, one launch); D 17, which takes the plain-load instantiation;
# groups of 8 and 16 query heads per kv head (the kernel's widest
# registers); h2o_danube's fully wrapped 4096-row ring at D 120 (every row
# valid, as ``eff_len`` gives it once the ring has wrapped); gemma3's D 320
# (group 2): the global cache of its long leg (2064 rows, five splits),
# its wrapped 1024-row local ring (two splits), its serving cache (one
# split), a group of 16 at D 320 (the widest registers of that width), and
# D 300 (bf16: the plain-load instantiation)
DECODE_GPU_CASES = [
    ([2064, 1000, 513, 1], 2064, 8, 4, 320),
    ([1024, 1024, 1024, 1024], 1024, 8, 4, 320),
    ([145, 130, 1, 145], 145, 8, 4, 320),
    ([600, 5], 600, 32, 2, 320),
    ([700, 3], 700, 4, 2, 300),
    ([4096, 4096], 4096, 32, 8, 120),
    ([1, 511, 512, 513, 1300], 1300, 8, 2, 64),
    ([4096, 3001], 4096, 32, 8, 128),
    ([145, 130, 1, 145], 145, 32, 8, 128),
    ([1, 100, 600, 1025], 1025, 4, 4, 17),
    ([600, 5], 600, 16, 2, 128),
    ([300, 77], 300, 16, 1, 64),
]
# (s, h, p, n, chunk): tests/test_kernels.py:70-72, then zamba2's P 128 and
# N 64 with S not a multiple of the chunk
SSM_CASES = [(64, 2, 8, 16, 16), (96, 3, 16, 8, 32), (50, 1, 4, 4, 16)]
SSM_GPU_CASES = SSM_CASES + [(300, 4, 128, 64, 256)]
# (s, h, d, chunk): tests/test_kernels.py:131-132, then xlstm's D 512
MLSTM_CASES = [(37, 3, 8, 8), (64, 2, 16, 16), (50, 1, 32, 37)]
MLSTM_GPU_CASES = MLSTM_CASES + [(300, 2, 512, 256)]
# (b, s, h, p, n) for the scans' own chunk (64 rows): zamba2's serving shape
# and an S no chunk divides at full width (H 32, P 128, N 64); the smoke
# configs' N 16 with P 8 and 16; S below one chunk; a P that no 64-column
# tile and no 16-byte vector divides
SSM_TC_CASES = [(4, 128, 32, 128, 64), (1, 1000, 32, 128, 64), (2, 40, 4, 8, 16),
                (2, 70, 4, 16, 16), (2, 20, 2, 64, 16), (1, 100, 2, 100, 12)]
# (b, s, h, d, logi scale, forget-gate offset, q and k drawn positive) for
# the mLSTM's own chunk: xlstm's D 512 with S no chunk divides; strongly
# negative logf with large input gates, so the stabiliser drops and rises
# within and across chunks (q and k positive: with a memory a few tokens
# long, random signs let |n . q| cancel until fp32 summation order alone
# parts kernel and twin by 1e-3); S below one chunk; a D that no 16-byte
# vector divides
MLSTM_TC_CASES = [(1, 300, 2, 512, 0.5, 2.0, False), (2, 200, 2, 64, 4.0, -4.0, True),
                  (2, 30, 1, 128, 0.5, 2.0, False), (1, 150, 2, 36, 0.5, 2.0, False)]


def tol(dtype_name):
    return dict(rtol=2e-2, atol=2e-2) if dtype_name == "bfloat16" else \
        dict(rtol=3e-4, atol=3e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA / Triton kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def ssm_inputs(rng: np.random.Generator, b: int, s: int, h: int, p: int, n: int):
    """The inputs of tests/test_kernels.py:74-80, drawn with numpy."""
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    A = -np.abs(rng.standard_normal(h, dtype=np.float32)) * 4
    Bm = rng.standard_normal((b, s, n), dtype=np.float32) * 0.3
    Cm = rng.standard_normal((b, s, n), dtype=np.float32) * 0.3
    return x, dt, A, Bm, Cm


def extreme_decay_inputs(rng: np.random.Generator):
    """tests/test_kernels.py:91-99: strong decay must not overflow."""
    b, s, h, p, n = 1, 32, 4, 8, 16
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32) + 2))
    A = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    Bm = rng.standard_normal((b, s, n), dtype=np.float32)
    Cm = rng.standard_normal((b, s, n), dtype=np.float32)
    return x, dt, A, Bm, Cm


def mlstm_inputs(rng: np.random.Generator, b: int, s: int, h: int, d: int):
    """The inputs of tests/test_kernels.py:137-141: q, k, v, logi and the
    forget-gate preactivation (log-sigmoid it for the chunked forms)."""
    q, k, v = (rng.standard_normal((b, s, h, d), dtype=np.float32) for _ in range(3))
    logi = rng.standard_normal((b, s, h), dtype=np.float32) * 0.5
    fpre = rng.standard_normal((b, s, h), dtype=np.float32) + 2.0
    return q, k, v, logi, fpre


def _close(got, want, dtype):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv,hq,hkv,d,window", FLASH_GPU_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_matches_twin_on_gpu(cuda, sq, skv, hq, hkv, d, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    q = torch.randn(2, sq, hq, d, device=cuda, generator=g).to(td)
    k = torch.randn(2, skv, hkv, d, device=cuda, generator=g).to(td)
    v = torch.randn(2, skv, hkv, d, device=cuda, generator=g).to(td)
    kw = dict(causal=True, window=window, q_offset=skv - sq)
    got = ops.flash_attention(q, k, v, use_kernel=True, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    _close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("s,hq,hkv,d,block_k", DECODE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_matches_twin_on_gpu(cuda, s, hq, hkv, d, block_k, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    q = torch.randn(3, hq, d, device=cuda, generator=g).to(td)
    kc = torch.randn(3, s, hkv, d, device=cuda, generator=g).to(td)
    vc = torch.randn(3, s, hkv, d, device=cuda, generator=g).to(td)
    lens = torch.tensor([s, s // 2, 1], dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, kc, vc, lens, use_kernel=True)
    want = ref.decode_attention_ref(q, kc, vc, lens)
    _close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("lens,s,hq,hkv,d", DECODE_GPU_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_split_edges_on_gpu(cuda, lens, s, hq, hkv, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    b = len(lens)
    q = torch.randn(b, hq, d, device=cuda, generator=g).to(td)
    kc = torch.randn(b, s, hkv, d, device=cuda, generator=g).to(td)
    vc = torch.randn(b, s, hkv, d, device=cuda, generator=g).to(td)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, kc, vc, cl, use_kernel=True)
    _close(got, ref.decode_attention_ref(q, kc, vc, cl), dtype)


def _misaligned(shape, device, dtype, gen):
    """A contiguous tensor whose data starts one element into its buffer, so
    its pointer is not 16-byte aligned."""
    n = int(np.prod(shape))
    t = torch.randn(n + 1, device=device, generator=gen).to(dtype)[1:].view(shape)
    assert t.data_ptr() % 16
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_kernels_take_misaligned_pointers_on_gpu(cuda, dtype):
    """A pointer that is not 16-byte aligned takes the kernels' plain-load
    staging (16-byte copies need aligned rows) and gives the same result."""
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    q, k, v = (_misaligned((2, 100, 4, 64), cuda, td, g) for _ in range(3))
    kw = dict(causal=True, window=0, q_offset=0)
    _close(ops.flash_attention(q, k, v, use_kernel=True, **kw),
           ref.flash_attention_ref(q, k, v, **kw), dtype)
    qd = torch.randn(2, 8, 64, device=cuda, generator=g).to(td)
    kc, vc = (_misaligned((2, 300, 2, 64), cuda, td, g) for _ in range(2))
    cl = torch.tensor([300, 7], dtype=torch.int32, device=cuda)
    _close(ops.decode_attention(qd, kc, vc, cl, use_kernel=True),
           ref.decode_attention_ref(qd, kc, vc, cl), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_kernel_matches_twin_on_gpu(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    x = torch.randn(shape, device=cuda, generator=g).to(td)
    s = (torch.randn(shape[-1:], device=cuda, generator=g) * 0.1).to(td)
    got = ops.rmsnorm(x, s, use_kernel=True)
    _close(got, ref.rmsnorm_ref(x, s), dtype)


def _on(arrays, device, dtype):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,p,n,chunk", SSM_GPU_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_scan_kernel_matches_twin_on_gpu(cuda, s, h, p, n, chunk, dtype):
    x, dt, A, Bm, Cm = ssm_inputs(np.random.default_rng(4), 2, s, h, p, n)
    x, dt, Bm, Cm = _on((x, dt, Bm, Cm), cuda, DTYPES[dtype])
    A = torch.from_numpy(A).to(cuda)
    y, hf = ops.ssm_scan(x, dt, A, Bm, Cm, chunk=chunk, use_kernel=True)
    y_t, hf_t = ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    assert y.dtype == x.dtype and hf.dtype == torch.float32
    _close(y, y_t, dtype)
    _close(hf, hf_t, dtype)


@pytest.mark.gpu
def test_ssm_scan_kernel_extreme_decay_no_nan_on_gpu(cuda):
    x, dt, A, Bm, Cm = _on(extreme_decay_inputs(np.random.default_rng(5)), cuda, torch.float32)
    y, hf = ops.ssm_scan(x, dt, A, Bm, Cm, chunk=16, use_kernel=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hf).all())
    _close(y, ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=16)[0], "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,d,chunk", MLSTM_GPU_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_scan_kernel_matches_twin_on_gpu(cuda, s, h, d, chunk, dtype):
    q, k, v, logi, fpre = mlstm_inputs(np.random.default_rng(6), 2, s, h, d)
    q, k, v = _on((q, k, v), cuda, DTYPES[dtype])
    logi, fpre = _on((logi, fpre), cuda, torch.float32)
    logf = torch.nn.functional.logsigmoid(fpre)
    got = ops.mlstm_scan(q, k, v, logi, logf, chunk=chunk, use_kernel=True)
    want = ops.mlstm_scan(q, k, v, logi, logf, chunk=chunk, use_kernel=False)
    assert got.dtype == q.dtype
    _close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n", SSM_TC_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_scan_kernel_chunk_edges_on_gpu(cuda, b, s, h, p, n, dtype):
    """The bf16 tensor-core path (and the fp32 kernel) at full width, at S
    below and across the kernels' chunk, and at widths no tile divides."""
    x, dt, A, Bm, Cm = ssm_inputs(np.random.default_rng(8), b, s, h, p, n)
    x, dt, Bm, Cm = _on((x, dt, Bm, Cm), cuda, DTYPES[dtype])
    A = torch.from_numpy(A).to(cuda)
    y, hf = ops.ssm_scan(x, dt, A, Bm, Cm, use_kernel=True)
    y_t, hf_t = ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=256)
    _close(y, y_t, dtype)
    _close(hf, hf_t, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,d,li_scale,f_offset,positive", MLSTM_TC_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_scan_kernel_chunk_edges_on_gpu(cuda, b, s, h, d, li_scale, f_offset, positive,
                                              dtype):
    """The bf16 tensor-core path (and the fp32 kernel) at xlstm's D, with
    strongly negative forget gates (the carry restabilised), at S below one
    chunk and at a D no 16-byte vector divides."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((b, s, h, d), dtype=np.float32) for _ in range(3))
    if positive:
        q, k = np.abs(q), np.abs(k)
    logi = rng.standard_normal((b, s, h), dtype=np.float32) * li_scale
    fpre = rng.standard_normal((b, s, h), dtype=np.float32) + f_offset
    q, k, v = _on((q, k, v), cuda, DTYPES[dtype])
    logi, fpre = _on((logi, fpre), cuda, torch.float32)
    logf = torch.nn.functional.logsigmoid(fpre)
    got = ops.mlstm_scan(q, k, v, logi, logf, use_kernel=True)
    want = ops.mlstm_scan(q, k, v, logi, logf, chunk=256, use_kernel=False)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scans_take_their_dtype_entry_points_on_gpu(cuda, dtype, monkeypatch):
    """fp32 inputs go to the CUDA-core kernels' entry points (``*_f32``, no
    scratch), bf16 inputs to the tensor-core paths (``*_bf16`` with their
    scratch), one counted launch a call either way."""
    real = native.function
    seen = []

    def function(src, name, argtypes, restype=ctypes.c_int):
        seen.append((name, len(argtypes)))
        return real(src, name, argtypes, restype)

    monkeypatch.setattr(native, "function", function)
    td = DTYPES[dtype]
    x, dt, A, Bm, Cm = ssm_inputs(np.random.default_rng(4), 1, 70, 2, 16, 8)
    x, dt, Bm, Cm = _on((x, dt, Bm, Cm), cuda, td)
    q = torch.randn(1, 70, 2, 32, device=cuda).to(td)
    gates = torch.zeros(1, 70, 2, device=cuda)
    native.reset_launches()
    ops.ssm_scan(x, dt, torch.from_numpy(A).to(cuda), Bm, Cm, use_kernel=True)
    ops.mlstm_scan(q, q, q, gates, gates, use_kernel=True)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ssm_scan"] == 1 and native.LAUNCHES["mlstm_scan"] == 1
    entries = [name for name, _ in seen if not name.endswith("_error_string")]
    if dtype == "float32":
        assert entries == ["ssm_scan_f32", "mlstm_scan_f32"]
        assert [n for _, n in seen] == [13, 12]       # the kernels' unchanged signatures
    else:
        assert entries == ["ssm_scan_bf16", "ssm_scan_bf16_scratch", "mlstm_scan_bf16",
                           "mlstm_scan_bf16_scratch"]


@pytest.mark.gpu
def test_wrappers_count_launches_and_reject_wide_heads(cuda):
    """One count a call; a head dim past the kernels' 320 raises before any
    launch."""
    native.reset_launches()
    q = torch.randn(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    ops.flash_attention(q, q, q, use_kernel=True)
    ops.decode_attention(q[:, 0], q, q, torch.full((1,), 8, dtype=torch.int32, device=cuda),
                         use_kernel=True)
    ops.rmsnorm(q, torch.zeros(64, device=cuda, dtype=torch.bfloat16), use_kernel=True)
    assert native.LAUNCHES == {"rmsnorm": 1, "flash_attention": 1, "decode_attention": 1,
                               "ssm_scan": 0, "mlstm_scan": 0, "flash_attention_bwd": 0,
                               "rmsnorm_bwd": 0}
    wide = torch.randn(1, 8, 2, 336, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 336"):
        ops.flash_attention(wide, wide, wide, use_kernel=True)
    with pytest.raises(ValueError, match="head_dim 336"):
        ops.decode_attention(wide[:, 0], wide, wide,
                             torch.full((1,), 8, dtype=torch.int32, device=cuda),
                             use_kernel=True)
    assert native.LAUNCHES["flash_attention"] == native.LAUNCHES["decode_attention"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_head_dim_320_runs_the_hand_written_kernels_on_gpu(cuda, dtype, monkeypatch):
    """gemma3's D 320 goes to the attention kernels' own entry points, one
    counted launch a call, and never to SDPA (patched to raise here)."""
    real = native.function
    seen = []

    def function(src, name, argtypes, restype=ctypes.c_int):
        seen.append(name)
        return real(src, name, argtypes, restype)

    def no_sdpa(*args, **kw):
        raise AssertionError("scaled_dot_product_attention called")

    monkeypatch.setattr(native, "function", function)
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention", no_sdpa)
    td = DTYPES[dtype]
    q = torch.randn(1, 40, 8, 320, device=cuda).to(td)
    kv = torch.randn(1, 40, 4, 320, device=cuda).to(td)
    native.reset_launches()
    ops.flash_attention(q, kv, kv, window=16, use_kernel=True)
    ops.decode_attention(q[:, 0], kv, kv, torch.full((1,), 40, dtype=torch.int32, device=cuda),
                         use_kernel=True)
    torch.cuda.synchronize()
    assert native.LAUNCHES["flash_attention"] == native.LAUNCHES["decode_attention"] == 1
    suffix = "bf16" if dtype == "bfloat16" else "f32"
    assert [n for n in seen if not n.endswith("_error_string")] == [
        f"flash_attention_{suffix}", f"decode_attention_{suffix}"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite_3_8b", "zamba2_1_2b", "xlstm_1_3b",
                                  "h2o_danube_3_4b", "minitron_4b", "gemma3_4b"])
def test_smoke_model_kernel_path_matches_plain_path_on_gpu(cuda, arch):
    """Smoke configs (fp32): prefill and a decode step through the kernels
    agree with the plain path on the same weights (granite, minitron:
    attention and norms; zamba2: the SSD scan and the shared attention
    block's kernels; xlstm: norms, and below its scoring forward through the
    mLSTM scan; h2o_danube: a window of 16 that binds in prefill, then decode
    on the wrapped ring; gemma3: its local ring beside a global cache, and
    the tied, scaled embeddings)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, steps
    cfg = registry.get_smoke_config(arch)
    params = lm.init_params(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    out = {}
    for use in (True, False):
        c = cfg.replace(use_kernels=use)
        last, cache = steps.prefill(params, {"tokens": tokens[:, :-1]}, cfg=c, cache_len=30)
        step, _ = lm.decode_step(params, c, tokens[:, -1:],
                                 torch.full((2,), 23, dtype=torch.int32, device=cuda), cache)
        out[use] = (last, step)
    for got, want in zip(out[True], out[False]):
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel < 2e-3, rel


@pytest.mark.gpu
def test_xlstm_smoke_scoring_kernel_path_matches_plain_path_on_gpu(cuda):
    """The full-sequence forward of loss_fn is xlstm's one route to the mLSTM
    scan kernel: its loss and logits agree with the plain path."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, steps
    cfg = registry.get_smoke_config("xlstm_1_3b")
    params = lm.init_params(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens}
    native.reset_launches()
    loss_k, _ = steps.loss_fn(params, cfg.replace(use_kernels=True), batch)
    torch.cuda.synchronize()
    assert native.LAUNCHES["mlstm_scan"] == cfg.n_layers - cfg.n_layers // cfg.slstm_every
    loss_p, _ = steps.loss_fn(params, cfg, batch)
    assert abs(float(loss_k) - float(loss_p)) < 2e-3 * abs(float(loss_p))
    got, _, _ = lm.forward(params, cfg.replace(use_kernels=True), batch)
    want, _, _ = lm.forward(params, cfg, batch)
    assert float((got - want).abs().max() / want.abs().max()) < 2e-3


@pytest.mark.gpu
def test_h2o_smoke_batcher_kernel_path_matches_plain_path_on_gpu(cuda):
    """The continuous batcher on the card (fp32, smoke h2o_danube, window
    16): prompts past the window, more requests than slots, prefill chunks
    of 5; the kernel path's tokens equal the plain path's, and its steps
    launch only RMSNorm and decode attention (chunked prefill runs no
    attention kernel)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serving.continuous import ContinuousBatcher
    cfg = registry.get_smoke_config("h2o_danube_3_4b")
    params = lm.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (3, 22, 9, 30, 17)]
    outs = {}
    for use in (True, False):
        native.reset_launches()
        cb = ContinuousBatcher(cfg.replace(use_kernels=use), params, max_slots=2, max_len=48,
                               prefill_chunk=5)
        reqs = [cb.submit(p, max_new=6) for p in prompts]
        cb.run()
        outs[use] = [r.output for r in reqs]
        launches = dict(native.LAUNCHES)
        if use:
            assert launches["rmsnorm"] > 0 and launches["decode_attention"] > 0
            assert launches["flash_attention"] == launches["ssm_scan"] == 0
        else:
            assert sum(launches.values()) == 0
    assert outs[True] == outs[False]


@pytest.mark.gpu
def test_kserve_strategy_serves_the_smoke_predictor_on_gpu(cuda):
    """The gateway's kserve strategy over granite's smoke Predictor on the
    card: 16 burst requests each served once, batched up to 4 a predict,
    in less total time than the k8s strategy's one-at-a-time."""
    from repro_torch.clouds.profiles import get_profile
    from repro_torch.configs import registry
    from repro_torch.launch.serve import make_lm_predictor
    from repro_torch.serving.kserve import InferenceService
    cfg = registry.get_smoke_config("granite_3_8b").replace(use_kernels=True)
    pred = make_lm_predictor(cfg, gen_tokens=4, prompt_len=8, device=cuda)
    native.reset_launches()
    res = InferenceService(pred, get_profile("gcp"), "kserve", max_batch=4).stress_test(16)
    assert native.LAUNCHES["decode_attention"] > 0 and native.LAUNCHES["flash_attention"] > 0
    assert len(res.latencies_s) == 16 and sum(res.per_version.values()) == 16
    k8s = InferenceService(pred, get_profile("k8s"), "k8s").stress_test(16)
    assert res.total_time_s < k8s.total_time_s


def _rel(got, want) -> float:
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    return float((g - w).abs().max() / (w.abs().max() + 1e-12))


@pytest.mark.gpu
def test_lenet_logits_grads_and_training_match_cpu_on_gpu(cuda):
    """LeNet (width 16, batch 64, fp32, TF32 off for cuDNN too) on the card
    against the port's CPU path on one init and the batches of chip_smoke.py's
    MNIST leg (10 distinct batches of its 2048 images): logits rel <= 1e-5,
    the first step's gradients rel <= 1e-4 per leaf, the trainer's reported
    losses over 10 steps rel <= 1e-3 (the parameters drift further where a
    near-zero pre-activation passes the ReLU on one device only, and the gap
    grows with every step: chip_smoke.py reports them); no port kernel
    launches on this path."""
    from repro_torch.core.trainjob import SupervisedTrainJob
    from repro_torch.data.mnist import Batches, make_dataset
    from repro_torch.models import lenet
    from repro_torch.optim import adamw
    torch.backends.cudnn.allow_tf32 = False
    imgs, labels = make_dataset(2048, seed=0)
    native.reset_launches()
    params = {d: lenet.init_params(torch.Generator().manual_seed(0), device=d)
              for d in ("cpu", cuda)}
    assert _rel(lenet.apply(params[cuda], imgs[:64]), lenet.apply(params["cpu"], imgs[:64])) <= 1e-5
    grads = {}
    for d, p in params.items():
        leaves = adamw.tree_map(lambda t: t.requires_grad_(), p)
        loss, _ = lenet.loss_fn(leaves, {"image": imgs[:64], "label": labels[:64]})
        grads[d] = torch.autograd.grad(loss, adamw.tree_leaves(leaves))
    for g, c in zip(grads[cuda], grads["cpu"]):
        assert _rel(g, c) <= 1e-4
    losses = {d: [] for d in ("cpu", cuda)}
    for d in losses:
        SupervisedTrainJob(lr=2e-3, n_steps=10, device=d).run(
            Batches(imgs, labels, 64), report=lambda i, v, d=d: losses[d].append(v))
    assert len(losses[cuda]) == 5
    for a, b in zip(losses[cuda], losses["cpu"]):
        assert abs(a - b) / abs(b) <= 1e-3
    assert not any(native.LAUNCHES.values())


# (sq, skv, hq, hkv, d, window) for the flash backward (q_offset 0): MHA;
# GQA 4:1 with S no tile divides; h2o's D 120 under a binding window; D 17
# (plain-load staging); zamba2's D 64; granite's D 128 over several key
# tiles, causal and with a window; kv longer than q; a window of 1
FLASH_BWD_CASES = [
    (64, 64, 4, 4, 32, 0),
    (100, 100, 8, 2, 64, 0),
    (200, 200, 8, 2, 120, 64),
    (40, 40, 2, 1, 17, 0),
    (130, 130, 4, 4, 64, 0),
    (300, 300, 8, 2, 128, 0),
    (300, 300, 8, 2, 128, 100),
    (70, 150, 4, 2, 128, 0),
    (65, 65, 2, 2, 16, 1),
]


def _flash_grads(q, k, v, do, use_kernel, **kw):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, use_kernel=use_kernel, **kw)
    return out, torch.autograd.grad(out, leaves, do)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv,hq,hkv,d,window", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_backward_kernel_matches_twin_on_gpu(cuda, sq, skv, hq, hkv, d, window, dtype):
    """Autograd through the kernel (the LSE forward, then the backward
    kernel) against the twin's gradient (autograd in fp32): dq, dk, dv."""
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    q = torch.randn(2, sq, hq, d, device=cuda, generator=g).to(td)
    k, v = (torch.randn(2, skv, hkv, d, device=cuda, generator=g).to(td) for _ in range(2))
    do = torch.randn(2, sq, hq, d, device=cuda, generator=g).to(td)
    native.reset_launches()
    out, got = _flash_grads(q, k, v, do, True, causal=True, window=window)
    torch.cuda.synchronize()
    assert native.LAUNCHES["flash_attention"] == native.LAUNCHES["flash_attention_bwd"] == 1
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=True, window=window)
    for a, b in zip(got, want):
        assert a.dtype == td
        _close(a, b, dtype)
    _close(out.detach(), ref.flash_attention_ref(q, k, v, causal=True, window=window), dtype)


def rule_share(got: torch.Tensor, want: torch.Tensor, floor: float = 1e-6) -> float:
    """The largest share of its allowance any element uses under the card's
    rule for a backward kernel (``chip_smoke._check``): |got - want| <=
    2e-2 (|want| + rms of want's row), the row's rms at least ``floor / 2e-2``
    of want's largest value."""
    g, w = got.float(), want.float()
    row = w.square().mean(dim=-1, keepdim=True).sqrt()
    row = torch.clamp(row, min=float(floor / 2e-2 * w.abs().max()))
    return float(((g - w).abs() / (2e-2 * (w.abs() + row))).max())


def bwd_inputs(case: str):
    """bf16 causal GQA inputs (B 1, S 16, 2 query heads on 1 kv head, D 128)
    on which a bf16 backward's order shows.  ``one_hot``: head 0's row 1
    puts all but ~1e-5 of its weight on key 0, so its dS is ~1e-5 of dP.
    ``common_keys``: every key is one shared vector plus 0.1 of noise, so
    dq = scale sum_j dS_ij k_j (sum_j dS_ij = 0) cancels to ~0.1 of
    sum_j |dS_ij| |k_j|."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 16, 2, 128), dtype=np.float32)
    if case == "one_hot":
        k = rng.standard_normal((1, 16, 1, 128), dtype=np.float32)
        q[0, 1, 0] = k[0, 0, 0]             # score ~ |k_0|^2 / sqrt(128) ~ 11 above key 1's
    else:
        k = rng.standard_normal(128, dtype=np.float32) \
            + 0.1 * rng.standard_normal((1, 16, 1, 128), dtype=np.float32)
    v = rng.standard_normal((1, 16, 1, 128), dtype=np.float32)
    do = rng.standard_normal((1, 16, 2, 128), dtype=np.float32)
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_hot", "common_keys"])
def test_flash_backward_kernel_holds_where_the_usual_orders_miss_on_gpu(cuda, case):
    """The kernel on the inputs where the usual flash backward's orders miss
    the fp32 gradient (``test_torch_kernels.py``): dq, dk, dv within the
    rule ``chip_smoke.py`` holds the backward kernels to."""
    q, k, v, do = (t.to(cuda) for t in bwd_inputs(case))
    _, got = _flash_grads(q, k, v, do, True)
    want = ref.flash_attention_bwd_ref(q, k, v, do)
    assert max(rule_share(a, b) for a, b in zip(got, want)) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 64, 120, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_lse_variant_output_equals_the_serving_variant_on_gpu(cuda, d, dtype):
    """The training forward writes the same output, bit for bit, as the
    serving forward, and a log-sum-exp equal to the twin's."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(1)
    td = DTYPES[dtype]
    q = torch.randn(2, 150, 8, d, device=cuda, generator=g).to(td)
    k, v = (torch.randn(2, 150, 2, d, device=cuda, generator=g).to(td) for _ in range(2))
    for window in (0, 40):
        serve, _ = fa._forward(q, k, v, True, window, d ** -0.5, 0, False)
        train, lse = fa._forward(q, k, v, True, window, d ** -0.5, 0, True)
        torch.cuda.synchronize()
        assert torch.equal(serve, train)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(4, 2))
        pos = torch.arange(150, device=cuda)
        mask = (pos[None] <= pos[:, None]) & ((pos[:, None] - pos[None] < window) | (window == 0))
        want = torch.logsumexp(torch.where(mask, logits * d ** -0.5, -torch.inf), dim=-1)
        np.testing.assert_allclose(lse.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_backward_kernel_repeats_bit_for_bit_on_gpu(cuda, dtype):
    """Each gradient has one owner block and sums in a fixed order (no
    atomics): two calls give the same bits."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(2)
    td = DTYPES[dtype]
    q = torch.randn(2, 300, 8, 128, device=cuda, generator=g).to(td)
    k, v = (torch.randn(2, 300, 2, 128, device=cuda, generator=g).to(td) for _ in range(2))
    do = torch.randn(2, 300, 8, 128, device=cuda, generator=g).to(td)
    _, lse, o32 = fa.forward_for_training(q, k, v, True, 100, 128 ** -0.5)
    first = fa.flash_attention_bwd(q, k, v, do, lse, o32, window=100)
    again = fa.flash_attention_bwd(q, k, v, do, lse, o32, window=100)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 256])
def test_flash_backward_kernel_training_scale_on_gpu(cuda, window):
    """bf16 at a training shape (S 1024, 32 query heads on 8 kv heads, D
    128, causal, and under a window of 256): dq, dk, dv within the rule
    ``chip_smoke.py`` holds the backward kernel to."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(1, 1024, 32, 128, device=cuda, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(1, 1024, 8, 128, device=cuda, generator=g).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn(1, 1024, 32, 128, device=cuda, generator=g).to(torch.bfloat16)
    _, got = _flash_grads(q, k, v, do, True, window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, do, window=window)
    assert max(rule_share(a, b) for a, b in zip(got, want)) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 64, 120, 128])
def test_flash_training_forward_o32_matches_twin_on_gpu(cuda, d):
    """The bf16 training forward's O32 (the output before rounding, over
    the rounded P's own sum): against the twin's output in fp32 within the
    rule the forward is held to (it carries P's bf16 rounding: an H100 read
    0.29-0.35 of it); over rows of V that are all ones, 1 to fp32 rounding
    (its weights sum to one, where l, the fp32 P's sum, leaves ~1e-3); its
    bf16 output stays the serving output's bits."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(2, 150, 8, d, device=cuda, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(2, 150, 2, d, device=cuda, generator=g).to(torch.bfloat16)
            for _ in range(2))
    for window in (0, 40):
        out, _, o32 = fa.forward_for_training(q, k, v, True, window, d ** -0.5)
        serve, _ = fa._forward(q, k, v, True, window, d ** -0.5, 0, False)
        torch.cuda.synchronize()
        assert o32.dtype == torch.float32 and o32.shape == q.shape
        assert torch.equal(out, serve)
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(), window=window)
        assert rule_share(o32, want) <= 1.0
        _, _, ones = fa.forward_for_training(q, k, torch.ones_like(v), True, window, d ** -0.5)
        assert float((ones - 1).abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RMSNORM_SHAPES + [(4096, 4096)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_backward_kernel_matches_twin_on_gpu(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    x = torch.randn(shape, device=cuda, generator=g).to(td)
    s = (torch.randn(shape[-1:], device=cuda, generator=g) * 0.1).to(td)
    gy = torch.randn(shape, device=cuda, generator=g).to(td)
    leaves = [x.clone().requires_grad_(), s.clone().requires_grad_()]
    native.reset_launches()
    out = ops.rmsnorm(*leaves, use_kernel=True)
    got = torch.autograd.grad(out, leaves, gy)
    torch.cuda.synchronize()
    assert native.LAUNCHES["rmsnorm"] == native.LAUNCHES["rmsnorm_bwd"] == 1
    want = ref.rmsnorm_bwd_ref(x, s, gy)
    _close(got[0], want[0], dtype)
    # dscale sums over every row: hold it relative to its own scale
    rel = float((got[1].float() - want[1].float()).abs().max() / want[1].float().abs().max())
    assert rel <= tol(dtype)["rtol"], rel
    # the result repeats: no atomics
    again = torch.autograd.grad(ops.rmsnorm(*leaves, use_kernel=True), leaves, gy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite_3_8b", "h2o_danube_3_4b", "minitron_4b"])
def test_smoke_model_gradients_kernel_path_match_plain_path_on_gpu(cuda, arch):
    """fp32 smoke config, 2 layers: every parameter leaf gets a gradient
    through the kernels (attention and norms both ways), within 3e-4 of the
    plain path's, and a training step launches the four kernels and no other."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, steps
    from repro_torch.optim import adamw
    cfg = registry.get_smoke_config(arch)
    params = lm.init_params(cfg, seed=0, device=cuda, dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    grads = {}
    for use in (True, False):
        leaves = adamw.tree_map(lambda p: p.clone().requires_grad_(), params)
        loss, _ = steps.loss_fn(leaves, cfg.replace(use_kernels=use), batch)
        grads[use] = torch.autograd.grad(loss, adamw.tree_leaves(leaves))
    assert len(grads[True]) == len(adamw.tree_leaves(params))
    for a, b in zip(grads[True], grads[False]):
        assert _rel(a, b) <= 3e-4
    native.reset_launches()
    steps.train_step(params, adamw.init_opt_state(params), batch,
                     cfg=cfg.replace(use_kernels=True))
    torch.cuda.synchronize()
    assert {k for k, n in native.LAUNCHES.items() if n} == {
        "rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd"}


@pytest.mark.gpu
def test_kernels_without_a_backward_raise_under_grad_on_gpu(cuda):
    """decode attention, the two scans and flash at D 320 refuse a call
    under grad, naming their ROADMAP item, instead of returning an output
    with no gradient; under no_grad they run."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 8, 64, device=cuda, generator=g, requires_grad=True)
    kc = torch.randn(2, 16, 2, 64, device=cuda, generator=g)
    lens = torch.full((2,), 16, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="ROADMAP.md queue 2 item 2.4"):
        ops.decode_attention(q, kc, kc, lens, use_kernel=True)
    x, dt, A, Bm, Cm = _on(ssm_inputs(np.random.default_rng(0), 1, 32, 2, 8, 16), cuda,
                           torch.float32)
    with pytest.raises(RuntimeError, match="ROADMAP.md queue 2 item 2.2"):
        ops.ssm_scan(x.requires_grad_(), dt, A, Bm, Cm, use_kernel=True)
    qm, km, vm, li, fp = _on(mlstm_inputs(np.random.default_rng(0), 1, 32, 2, 16), cuda,
                             torch.float32)
    with pytest.raises(RuntimeError, match="ROADMAP.md queue 2 item 2.3"):
        ops.mlstm_scan(qm, km.requires_grad_(), vm, li, torch.nn.functional.logsigmoid(fp),
                       use_kernel=True)
    wide = torch.randn(1, 16, 2, 320, device=cuda, generator=g, requires_grad=True)
    with pytest.raises(ValueError, match="ROADMAP.md queue 2 item 2.1"):
        ops.flash_attention(wide, wide, wide, use_kernel=True)
    with torch.no_grad():
        ops.decode_attention(q, kc, kc, lens, use_kernel=True)
        ops.flash_attention(wide, wide, wide, use_kernel=True)
