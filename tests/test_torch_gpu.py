"""The port's CUDA / Triton kernels against their plain twins, on the card.

Marked ``gpu``: without an NVIDIA GPU every test skips.  This file imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The shapes are those of tests/test_kernels.py, which test_torch_kernels.py
also uses to hold the twins to the JAX reference; the tolerances are the
reference's (tests/test_kernels.py:17-19): 3e-4 in fp32, 2e-2 in bf16.
The backward kernels (flash attention, RMSNorm, the SSD and mLSTM scans)
are held to autograd of their twins at the same tolerances (the scans' fp32
gradients within 3e-4 of each one's largest value), and a smoke model's
gradients through the kernels to its plain path's; decode attention, which
has no backward, must raise under grad.
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
# the 320-column tile and (bf16) no whole number of 16-byte vectors;
# granite-moe's group of 3 (24 query heads over 8 kv heads, D 64), at its
# serving prefill and with a q_offset and no block dividing S; qwen2-vl's
# group of 7 (28 query heads over 4 kv heads, D 128) at its serving prefill,
# and with a q_offset and no block dividing S
FLASH_GPU_CASES = FLASH_CASES + [
    (384, 384, 28, 4, 128, 0),
    (100, 130, 14, 2, 128, 0),
    (128, 128, 24, 8, 64, 0),
    (100, 157, 6, 2, 64, 0),
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
# D 300 (bf16: the plain-load instantiation); granite-moe's group of 3 (24
# query heads over 8 kv heads, D 64) at its serving cache and across splits;
# whisper's cross-attention over its 1500 encoder rows, every row full
# (three splits), also at a tensor-parallel rank's 4 of its 8 heads, and
# its self-attention cache; qwen2-vl's group of 7 (28 over 4, D 128) at its
# serving cache and across splits
DECODE_GPU_CASES = [
    ([1500, 1500, 1500, 1500], 1500, 8, 8, 64),
    ([1500, 1500, 1500, 1500], 1500, 4, 4, 64),
    ([145, 130, 1, 145], 145, 8, 8, 64),
    ([401, 200, 1, 401], 401, 28, 4, 128),
    ([1300, 513, 2], 1300, 14, 2, 128),
    ([145, 130, 1, 145], 145, 24, 8, 64),
    ([1300, 513, 2], 1300, 6, 2, 64),
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
# tile and no 16-byte vector divides; a tensor-parallel rank's heads of
# zamba2 on a model axis of 2 (16 of 32)
SSM_TC_CASES = [(4, 128, 32, 128, 64), (1, 1000, 32, 128, 64), (2, 40, 4, 8, 16),
                (2, 70, 4, 16, 16), (2, 20, 2, 64, 16), (1, 100, 2, 100, 12),
                (4, 128, 16, 128, 64)]
# (b, s, h, d, logi scale, forget-gate offset, q and k drawn positive) for
# the mLSTM's own chunk: xlstm's D 512 with S no chunk divides; strongly
# negative logf with large input gates, so the stabiliser drops and rises
# within and across chunks (q and k positive: with a memory a few tokens
# long, random signs let |n . q| cancel until fp32 summation order alone
# parts kernel and twin by 1e-3); S below one chunk; a D that no 16-byte
# vector divides; a tensor-parallel rank's heads of xlstm on a model axis of 2
# (2 of 4) at the serving batch
MLSTM_TC_CASES = [(1, 300, 2, 512, 0.5, 2.0, False), (2, 200, 2, 64, 4.0, -4.0, True),
                  (2, 30, 1, 128, 0.5, 2.0, False), (1, 150, 2, 36, 0.5, 2.0, False),
                  (4, 128, 2, 512, 0.5, 2.0, False)]


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


# (sq, skv, hq, hkv, d): whisper's non-causal calls, its encoder's
# self-attention over 1500 frames (neither tile divides 1500) and its
# decoder's 128 queries over them; the smoke config's; and a cross-length
# call with a group of 2 where no block divides either length
FLASH_NONCAUSAL_GPU_CASES = [(1500, 1500, 8, 8, 64), (128, 1500, 8, 8, 64),
                             (30, 30, 4, 4, 16), (100, 333, 4, 2, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv,hq,hkv,d", FLASH_NONCAUSAL_GPU_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_non_causal_on_gpu(cuda, sq, skv, hq, hkv, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    q = torch.randn(2, sq, hq, d, device=cuda, generator=g).to(td)
    k = torch.randn(2, skv, hkv, d, device=cuda, generator=g).to(td)
    v = torch.randn(2, skv, hkv, d, device=cuda, generator=g).to(td)
    got = ops.flash_attention(q, k, v, causal=False, use_kernel=True)
    _close(got, ref.flash_attention_ref(q, k, v, causal=False), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [128, 1000])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_mla_shape_on_gpu(cuda, s, dtype):
    """deepseek's MLA call: q and k at D 192 (nope 128 + rope 64), v of 128
    zero-padded to 192, ``scale = 192^-0.5`` passed, causal MHA; the
    output's first 128 columns against the twin on the unpadded v, and the
    padded columns zero."""
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    q, k = (torch.randn(2, s, 16, 192, device=cuda, generator=g).to(td) for _ in range(2))
    v = torch.randn(2, s, 16, 128, device=cuda, generator=g).to(td)
    v_p = torch.nn.functional.pad(v, (0, 64))
    got = ops.flash_attention(q, k, v_p, causal=True, scale=192 ** -0.5, use_kernel=True)
    _close(got[..., :128], ref.flash_attention_ref(q, k, v, causal=True), dtype)
    assert not bool(got[..., 128:].any())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "deepseek_v2_lite_16b"])
def test_moe_layer_routes_on_the_card_as_on_the_cpu(cuda, arch):
    """One MoE layer in fp32 (a smoke config widened to 8 experts, top 4, so
    capacity drops): the card's routing (ids, dispatch order, slots,
    keep) equals the CPU's on the same weights and inputs, and so do the
    output (3e-4) and the aux loss."""
    from repro_torch.configs import registry
    from repro_torch.models import moe
    cfg = registry.get_smoke_config(arch).replace(n_experts=8, top_k=4)
    params = moe.moe_init(cfg, torch.float32, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 40, cfg.d_model),
                                                                  dtype=np.float32))
    on = {"cpu": (params, x), "cuda": ({k: v.to(cuda) for k, v in params.items()},
                                       x.to(cuda))}
    out = {}
    for dev, (p, xx) in on.items():
        cap = moe.capacity(cfg, xx.shape[1])
        _, route, _ = moe._route_group(xx, moe.router_logits(p, xx), cfg, cap)
        out[dev] = (route, *moe.moe_forward(p, xx, cfg))
    assert not bool(out["cpu"][0].keep.all())           # some assignments drop
    for name in ("ids", "order", "slot", "keep", "tok_idx"):
        assert torch.equal(getattr(out["cuda"][0], name).cpu(),
                           getattr(out["cpu"][0], name)), name
    _close(out["cuda"][1], out["cpu"][1], "float32")
    assert abs(float(out["cuda"][2]) - float(out["cpu"][2])) <= 3e-4 * float(out["cpu"][2])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite_3_8b", "deepseek_v2_lite_16b"])
def test_stacked_decode_writes_the_group_in_place_on_gpu(cuda, arch):
    """``slot_decode_stacked`` on the card (granite: the decode kernel on
    group g's view of the stacked cache; deepseek: the absorbed MLA decode)
    gives ``lm.decode_step``'s logits and cache, fp32 at 3e-4."""
    from repro_torch.configs import registry
    from repro_torch.models import blocks, lm, steps
    cfg = registry.get_smoke_config(arch).replace(use_kernels=True)
    params = lm.init_params(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    _, cache = steps.prefill(params, {"tokens": tokens[:, :-1]}, cfg=cfg, cache_len=20)
    stacked = {k: {s: {n: t.clone() for n, t in c.items()} for s, c in pc.items()}
               for k, pc in cache.items()}
    pos = torch.full((2,), 16, dtype=torch.int32, device=cuda)
    want, _ = lm.decode_step(params, cfg, tokens[:, -1:], pos, cache)
    x = lm._embed(params, cfg, tokens[:, -1:])
    for pi, phase in enumerate(blocks.build_plan(cfg)):
        for g in range(phase.n_groups):
            gp = lm._at(params[f"phase{pi}"], g)
            for j, (kind, ffn) in enumerate(zip(phase.kinds, phase.ffns)):
                x, _ = blocks.slot_decode_stacked(gp[f"slot{j}"], x,
                                                  stacked[f"phase{pi}"][f"slot{j}"], g, pos,
                                                  cfg, kind, ffn)
    _close(lm._head(params, cfg, x[:, 0]), want, "float32")
    for k, pc in cache.items():
        for s, c in pc.items():
            for n, t in c.items():
                _close(stacked[k][s][n], t, "float32")


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
                               "rmsnorm_bwd": 0, "ssm_scan_bwd": 0, "mlstm_scan_bwd": 0}
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
                                  "h2o_danube_3_4b", "minitron_4b", "gemma3_4b",
                                  "granite_moe_3b_a800m", "deepseek_v2_lite_16b",
                                  "whisper_base", "qwen2_vl_7b"])
def test_smoke_model_kernel_path_matches_plain_path_on_gpu(cuda, arch):
    """Smoke configs (fp32): prefill and a decode step through the kernels
    agree with the plain path on the same weights (granite, minitron:
    attention and norms; zamba2: the SSD scan and the shared attention
    block's kernels; xlstm: norms, and below its scoring forward through the
    mLSTM scan; h2o_danube: a window of 16 that binds in prefill, then decode
    on the wrapped ring; gemma3: its local ring beside a global cache, and
    the tied, scaled embeddings; granite-moe: attention at a group of 2
    beside the MoE layers; deepseek: MLA's padded-v flash call, its
    absorbed decode on no kernel, a dense layer 0; whisper: the encoder's
    and the cross sub-layer's non-causal flash, decode over the encoder
    rows; qwen2-vl: M-RoPE, its vision rows, a group of 2), each with the
    inputs ``make_lm_predictor`` builds (``steps.batch_inputs``)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, steps
    cfg = registry.get_smoke_config(arch)
    params = lm.init_params(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    batch = steps.batch_inputs(cfg, tokens[:, :-1])
    out = {}
    for use in (True, False):
        c = cfg.replace(use_kernels=use)
        last, cache = steps.prefill(params, batch, cfg=c, cache_len=30)
        step, _ = lm.decode_step(params, c, tokens[:, -1:],
                                 steps.start_positions(cfg, 2, 23, cuda), cache)
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


# (sq, skv, hq, hkv, d) for the flash backward without a causal mask
# (whisper's training): its encoder's 1500 frames (a multiple of no tile),
# its decoder's 128 queries over them, both also at a tensor-parallel
# rank's 4 of its 8 heads, the smoke config's, and a cross-length call with
# a group of 2
FLASH_BWD_NONCAUSAL_CASES = [(1500, 1500, 8, 8, 64), (128, 1500, 8, 8, 64),
                             (1500, 1500, 4, 4, 64), (128, 1500, 4, 4, 64),
                             (30, 30, 4, 4, 16), (100, 333, 4, 2, 64)]


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


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv,hq,hkv,d", FLASH_BWD_NONCAUSAL_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_backward_kernel_non_causal_on_gpu(cuda, sq, skv, hq, hkv, d, dtype):
    """The same without a causal mask: every query sees every key."""
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    q = torch.randn(2, sq, hq, d, device=cuda, generator=g).to(td)
    k, v = (torch.randn(2, skv, hkv, d, device=cuda, generator=g).to(td) for _ in range(2))
    do = torch.randn(2, sq, hq, d, device=cuda, generator=g).to(td)
    native.reset_launches()
    out, got = _flash_grads(q, k, v, do, True, causal=False)
    torch.cuda.synchronize()
    assert native.LAUNCHES["flash_attention"] == native.LAUNCHES["flash_attention_bwd"] == 1
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=False)
    for a, b in zip(got, want):
        assert a.dtype == td
        _close(a, b, dtype)
        assert rule_share(a, b) <= 1.0
    _close(out.detach(), ref.flash_attention_ref(q, k, v, causal=False), dtype)


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
@pytest.mark.parametrize("d", [16, 64, 120, 128, 192, 320])
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
@pytest.mark.parametrize("dtype,d", [pytest.param(t, 128, id=t) for t in DTYPES]
                         + [pytest.param(t, d, id=f"{t}-{d}") for d in (192, 320) for t in DTYPES])
def test_flash_backward_kernel_repeats_bit_for_bit_on_gpu(cuda, dtype, d):
    """Each gradient has one owner block and sums in a fixed order (no
    atomics; past head dim 128 one column chunk of one head's keys owns a
    dK/dV element): two calls give the same bits."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(2)
    td = DTYPES[dtype]
    q = torch.randn(2, 300, 8, d, device=cuda, generator=g).to(td)
    k, v = (torch.randn(2, 300, 2, d, device=cuda, generator=g).to(td) for _ in range(2))
    do = torch.randn(2, 300, 8, d, device=cuda, generator=g).to(td)
    _, lse, o32 = fa.forward_for_training(q, k, v, True, 100, d ** -0.5)
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


# (d, dv, window) past head dim 128: gemma3's 320 (global, and under a
# window that binds), MLA's 192 with v zero-padded from 128 (the scale of
# 192), 200 (no 16-byte vector: plain loads) and 192 under a window
FLASH_WIDE_CASES = [(320, 0, 0), (320, 0, 40), (192, 128, 0), (192, 0, 40), (200, 0, 0)]


def _wide_inputs(cuda, td, d, dv, s=150, hq=4, hkv=2, seed=5):
    """q, k, v, dO (B 2, ``s`` rows, GQA 2:1): with ``dv`` < d, v and dO are
    MLA's, zero past dv (v padded, the output cut there)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(2, s, hq, d, device=cuda, generator=g).to(td)
    k = torch.randn(2, s, hkv, d, device=cuda, generator=g).to(td)
    v = torch.randn(2, s, hkv, dv or d, device=cuda, generator=g).to(td)
    do = torch.randn(2, s, hq, dv or d, device=cuda, generator=g).to(td)
    pad = d - (dv or d)
    return q, k, torch.nn.functional.pad(v, (0, pad)), torch.nn.functional.pad(do, (0, pad))


@pytest.mark.gpu
@pytest.mark.parametrize("d,dv,window", FLASH_WIDE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_backward_kernel_wide_matches_twin_on_gpu(cuda, d, dv, window, dtype):
    """Past head dim 128 autograd runs the training forward and the backward
    kernel (their 192- and 320-column tiles: 32-row ring tiles, the output
    columns in chunks a block): dq, dk, dv against the twin's gradient, in
    bf16 under the rule chip_smoke.py holds the backward kernel to, in fp32
    within 3e-4; MLA's padded columns of dv come out zero."""
    td = DTYPES[dtype]
    q, k, v, do = _wide_inputs(cuda, td, d, dv)
    native.reset_launches()
    out, got = _flash_grads(q, k, v, do, True, causal=True, window=window, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert native.LAUNCHES["flash_attention"] == native.LAUNCHES["flash_attention_bwd"] == 1
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=True, window=window)
    for a, b in zip(got, want):
        assert a.dtype == td and bool(torch.isfinite(a).all())
        if dtype == "bfloat16":
            assert rule_share(a, b) <= 1.0
        else:
            _close(a, b, dtype)
    if dv:
        assert not got[2][..., dv:].any()
    _close(out.detach(), ref.flash_attention_ref(q, k, v, causal=True, window=window), dtype)


@pytest.mark.gpu
def test_flash_past_the_widest_tile_raises_on_gpu(cuda):
    """Head dim 321 has no tile, forward or backward: the wrappers raise
    (under grad too) instead of launching."""
    from repro_torch.kernels import flash_attention as fa
    x = torch.randn(1, 16, 2, 321, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="head_dim 321 unsupported"):
        ops.flash_attention(x, x, x, use_kernel=True)
    lse = torch.zeros(1, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="head_dim 321 unsupported"):
        fa.flash_attention_bwd(x, x, x, x, lse, x.detach().float())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 64, 120, 128, 192, 320])
def test_flash_training_forward_o32_matches_twin_on_gpu(cuda, d):
    """The bf16 training forward's O32 (the output before rounding, over
    the rounded P's own sum): against the twin's output in fp32 within the
    rule the forward is held to (it carries P's bf16 rounding: an H100 read
    0.29-0.35 of it); over rows of V that are all ones, 1 to fp32 rounding
    (its weights sum to one, where l, the fp32 P's sum, leaves ~1e-3); its
    bf16 output stays the serving output's bits.  Past head dim 128 the
    backward reads no O32, and none is made."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(2, 150, 8, d, device=cuda, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(2, 150, 2, d, device=cuda, generator=g).to(torch.bfloat16)
            for _ in range(2))
    for window in (0, 40):
        out, _, o32 = fa.forward_for_training(q, k, v, True, window, d ** -0.5)
        serve, _ = fa._forward(q, k, v, True, window, d ** -0.5, 0, False)
        torch.cuda.synchronize()
        assert torch.equal(out, serve)
        if d > fa.O32_MAX_HEAD_DIM:
            assert o32 is None
            continue
        assert o32.dtype == torch.float32 and o32.shape == q.shape
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
@pytest.mark.parametrize("arch,wide", [
    *(pytest.param(a, {}, id=a) for a in ("granite_3_8b", "h2o_danube_3_4b", "minitron_4b",
                                          "whisper_base", "qwen2_vl_7b")),
    pytest.param("gemma3_4b", {"head_dim": 320}, id="gemma3_4b_d320"),
    pytest.param("deepseek_v2_lite_16b", {"n_layers": 1, "qk_nope_dim": 128, "qk_rope_dim": 64,
                                          "v_head_dim": 128}, id="deepseek_mla_d192")])
def test_smoke_model_gradients_kernel_path_match_plain_path_on_gpu(cuda, arch, wide):
    """fp32 smoke config, 2 layers: every parameter leaf gets a gradient
    through the kernels (attention and norms both ways), within 3e-4 of the
    plain path's, and a training step launches the four kernels and no other
    (whisper: the encoder's and the cross sub-layer's non-causal flash both
    ways, over frames drawn from the seed; qwen2-vl: M-RoPE and its vision
    rows, drawn too; ``wide``: the full archs' head dims on the smoke widths,
    gemma3's 320 over a windowed and a global layer, deepseek's MLA 192 with
    v 128 in its dense layer alone, so no routing can flip)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, steps
    from repro_torch.optim import adamw
    cfg = registry.get_smoke_config(arch).replace(**wide)
    params = lm.init_params(cfg, seed=0, device=cuda, dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), device=cuda, generator=gen)
    batch = {**steps.batch_inputs(cfg, toks), "labels": toks}
    for name in ("frames", "vision_embeds"):
        if name in batch:
            batch[name] = torch.randn(batch[name].shape, device=cuda, generator=gen)
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


# (b, s, h, p, n, extreme) for the scan's backward kernel: a ragged S with
# H 3, P 8, N 16; P 64 and N 64 across chunks; one head; S below a chunk at
# N 64; extreme decay (A = -16, dt ~ 5: every decay underflows); a P no
# 16-byte vector divides with N 12 (plain loads); zamba2's widths (P 128,
# N 64) across chunks; a tensor-parallel rank's 16 heads at those widths
SSM_BWD_GPU_CASES = [(2, 100, 3, 8, 16, False), (1, 130, 4, 64, 64, False),
                     (2, 64, 1, 64, 16, False), (2, 40, 4, 8, 64, False),
                     (1, 128, 4, 8, 16, True), (1, 100, 2, 100, 12, False),
                     (2, 300, 4, 128, 64, False), (2, 200, 16, 128, 64, False)]


def ssm_bwd_inputs(seed: int, b: int, s: int, h: int, p: int, n: int, extreme: bool = False):
    """``ssm_inputs`` (with ``extreme``: A = -16 and dt ~ 5 on every head)
    and the cotangents dy (B,S,H,P) and dh_final (B,H,P,N), fp32 numpy:
    ``tests/test_torch_ssm_bwd.py``'s draw."""
    rng = np.random.default_rng(seed)
    x, dt, A, Bm, Cm = ssm_inputs(rng, b, s, h, p, n)
    if extreme:
        dt = 5.0 + 0.1 * rng.standard_normal((b, s, h), dtype=np.float32)
        A = np.full(h, -16.0, dtype=np.float32)
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dh = rng.standard_normal((b, h, p, n), dtype=np.float32)
    return x, dt, A, Bm, Cm, dy, dh


def _ssm_bwd_on(arrays, device, dtype):
    """x, dt, B, C, dy in ``dtype``; A and dh_final fp32."""
    x, dt, A, Bm, Cm, dy, dh = arrays
    x, dt, Bm, Cm, dy = _on((x, dt, Bm, Cm, dy), device, dtype)
    A, dh = _on((A, dh), device, torch.float32)
    return x, dt, A, Bm, Cm, dy, dh


def _close_bwd(got, want, dtype):
    """bf16: the reference's 2e-2 + 2e-2 |t|; fp32: within 3e-4 of each
    gradient's largest value (dA and dB, dC sum over many positions and
    heads: the twin's own fp32 error there is ~2e-5 of the largest value,
    the kernel's smaller), a largest value below 1e-20 taken as 1e-20 (it
    moves no weight; extreme decay's dA is ~1e-33, which the twin rounds to
    0), as ``tests/test_torch_ssm_bwd.py`` holds them."""
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if dtype == "bfloat16":
            _close(g, w, dtype)
        else:
            err = float((g.float() - w.float()).abs().max())
            assert err <= 3e-4 * max(float(w.float().abs().max()), 1e-20), err


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,extreme", SSM_BWD_GPU_CASES)
@pytest.mark.parametrize("with_dh", [False, True], ids=["dh_none", "dh_final"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_scan_backward_kernel_matches_twin_on_gpu(cuda, b, s, h, p, n, extreme, with_dh,
                                                      dtype):
    """The backward kernel against ``ref.ssm_scan_bwd_ref`` (autograd of the
    chunked twin at the inputs' fp32 values), with and without h_final's
    gradient; no value is lost to overflow under extreme decay."""
    x, dt, A, Bm, Cm, dy, dh = _ssm_bwd_on(ssm_bwd_inputs(9, b, s, h, p, n, extreme), cuda,
                                           DTYPES[dtype])
    dh = dh if with_dh else None
    native.reset_launches()
    got = ops.ssm_scan_bwd(x, dt, A, Bm, Cm, dy, dh, use_kernel=True)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ssm_scan_bwd"] == 1
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close_bwd(got, ref.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dh), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_scan_backward_kernel_repeats_bit_for_bit_on_gpu(cuda, dtype):
    """Two calls on the same inputs give bit-equal gradients: every sum
    (dB and dC over heads, dA over rows and chunks) runs in a fixed order."""
    x, dt, A, Bm, Cm, dy, dh = _ssm_bwd_on(ssm_bwd_inputs(10, 2, 300, 4, 128, 64), cuda,
                                           DTYPES[dtype])
    first = ops.ssm_scan_bwd(x, dt, A, Bm, Cm, dy, dh, use_kernel=True)
    again = ops.ssm_scan_bwd(x, dt, A, Bm, Cm, dy, dh, use_kernel=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_ssm_scan_backward_kernel_repeats_bit_for_bit_at_the_training_shape_on_gpu(cuda):
    """zamba2's training shape, x (4,1024,32,128) N 64 in bf16: two calls
    give bit-equal gradients (the head groups' and chunks' sums in order,
    no atomics)."""
    x, dt, A, Bm, Cm, dy, _ = _ssm_bwd_on(ssm_bwd_inputs(13, 4, 1024, 32, 128, 64), cuda,
                                          torch.bfloat16)
    first = ops.ssm_scan_bwd(x, dt, A, Bm, Cm, dy, use_kernel=True)
    again = ops.ssm_scan_bwd(x, dt, A, Bm, Cm, dy, use_kernel=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_ssm_scan_backward_kernel_long_row_with_dh_final_on_gpu(cuda):
    """One row of 4096 tokens (64 chunks: the walks' length) at zamba2's
    widths in bf16, with h_final's gradient, against the twin."""
    x, dt, A, Bm, Cm, dy, dh = _ssm_bwd_on(ssm_bwd_inputs(14, 1, 4096, 32, 128, 64), cuda,
                                           torch.bfloat16)
    got = ops.ssm_scan_bwd(x, dt, A, Bm, Cm, dy, dh, use_kernel=True)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close_bwd(got, ref.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dh), "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n", [(2, 300, 3, 128, 64), (1, 200, 5, 64, 128)])
@pytest.mark.parametrize("with_dh", [False, True], ids=["dh_none", "dh_final"])
def test_ssm_scan_backward_kernel_short_head_group_on_gpu(cuda, b, s, h, p, n, with_dh):
    """Head counts no group of four divides (3: one short group; 5: a
    second group of one head) in bf16, against the twin."""
    x, dt, A, Bm, Cm, dy, dh = _ssm_bwd_on(ssm_bwd_inputs(15, b, s, h, p, n), cuda,
                                           torch.bfloat16)
    dh = dh if with_dh else None
    got = ops.ssm_scan_bwd(x, dt, A, Bm, Cm, dy, dh, use_kernel=True)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close_bwd(got, ref.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dh), "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n", [(1, 100, 2, 256, 16), (2, 130, 3, 136, 16)])
@pytest.mark.parametrize("with_dh", [False, True], ids=["dh_none", "dh_final"])
def test_ssm_scan_backward_kernel_past_the_wgmma_widths_on_gpu(cuda, b, s, h, p, n, with_dh):
    """bf16 head widths past the wgmma passes' 128 (P 256; P 136, ragged,
    across chunks) take the mma.sync passes and their shared sums pass;
    against the twin, one counted launch."""
    x, dt, A, Bm, Cm, dy, dh = _ssm_bwd_on(ssm_bwd_inputs(16, b, s, h, p, n), cuda,
                                           torch.bfloat16)
    dh = dh if with_dh else None
    native.reset_launches()
    got = ops.ssm_scan_bwd(x, dt, A, Bm, Cm, dy, dh, use_kernel=True)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ssm_scan_bwd"] == 1
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close_bwd(got, ref.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dh), "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("use_h_final", [False, True], ids=["y_only", "y_and_h_final"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_scan_autograd_through_the_kernels_on_gpu(cuda, use_h_final, dtype):
    """``torch.autograd.grad`` through ``ops.ssm_scan(use_kernel=True)``: the
    outputs carry a ``grad_fn``, one forward and one backward launch, each
    gradient in its input's dtype and within the tolerance of autograd
    through the twin (``ops.ssd_chunked``) on the same leaves; with h_final
    unused its gradient enters as None."""
    td = DTYPES[dtype]
    x, dt, A, Bm, Cm, gy, gh = _ssm_bwd_on(ssm_bwd_inputs(11, 2, 150, 4, 64, 16), cuda, td)
    grads = {}
    for use in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        native.reset_launches()
        y, hf = ops.ssm_scan(*leaves, chunk=64, use_kernel=use)
        assert y.grad_fn is not None and hf.grad_fn is not None
        loss = (y.float() * gy.float()).sum() + ((hf * gh).sum() if use_h_final else 0.0)
        grads[use] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        if use:
            assert native.LAUNCHES["ssm_scan"] == native.LAUNCHES["ssm_scan_bwd"] == 1
    assert [g.dtype for g in grads[True]] == [td, td, torch.float32, td, td]
    _close_bwd(grads[True], grads[False], "float32" if dtype == "float32" else "bfloat16")


@pytest.mark.gpu
def test_ssm_scan_backward_raises_past_its_tiles_on_gpu(cuda):
    """Off the card, and at a head width and state size whose chunk-pass
    tiles exceed a block's shared memory, the wrapper raises before any
    launch: no path falls back to the twin."""
    from repro_torch.kernels import ssm_scan as sk
    x, dt, A, Bm, Cm, dy, _ = _ssm_bwd_on(ssm_bwd_inputs(12, 1, 64, 2, 256, 64), cuda,
                                          torch.bfloat16)
    native.reset_launches()
    with pytest.raises(ValueError, match="head width P 256 with state size 64"):
        sk.ssm_scan_bwd(x, dt, A, Bm, Cm, dy)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        sk.ssm_scan_bwd(*(t.cpu() for t in (x, dt, A, Bm, Cm, dy)))
    assert native.LAUNCHES["ssm_scan_bwd"] == 0


@pytest.mark.gpu
def test_zamba2_smoke_gradients_through_the_scan_kernels_on_gpu(cuda):
    """zamba2's fp32 smoke config (4 Mamba2 layers, the shared attention
    block after every second): every parameter leaf's gradient through the
    kernels within 3e-4 of the plain path's, and a training step launches
    RMSNorm, flash attention and ``ssm_scan``, each both ways, and no other."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, steps
    from repro_torch.optim import adamw
    cfg = registry.get_smoke_config("zamba2_1_2b")
    params = lm.init_params(cfg, seed=0, device=cuda, dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), device=cuda, generator=gen)
    batch = {**steps.batch_inputs(cfg, toks), "labels": toks}
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
        "rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd", "ssm_scan",
        "ssm_scan_bwd"}


# (b, s, d): S around one chunk of 64 and a ragged 1000 (the last chunk 40
# rows), at D 16 (the smoke configs) and 512 (xlstm's)
MLSTM_BWD_GPU_CASES = [(2, s, d) for s in (1, 63, 64, 65, 1000) for d in (16, 512)]


def mlstm_bwd_inputs(seed: int, b: int, s: int, h: int, d: int):
    """q, k, v, logi, logf (log-sigmoid of the preactivation) and dy, fp32
    numpy; head 0's logi shifted by -30, so the denominator's floor binds in
    its rows (|n . q| far below exp(-m_row))."""
    rng = np.random.default_rng(seed)
    q, k, v, logi, fpre = mlstm_inputs(rng, b, s, h, d)
    logi[:, :, 0] -= 30.0
    logf = -np.logaddexp(0.0, -fpre).astype(np.float32)
    dy = rng.standard_normal((b, s, h, d), dtype=np.float32)
    return q, k, v, logi, logf, dy


def _mlstm_bwd_on(arrays, device, dtype):
    """q, k, v, dy in ``dtype``; the gates fp32."""
    q, k, v, logi, logf, dy = arrays
    q, k, v, dy = _on((q, k, v, dy), device, dtype)
    logi, logf = _on((logi, logf), device, torch.float32)
    return q, k, v, logi, logf, dy


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d", MLSTM_BWD_GPU_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_scan_backward_kernel_matches_twin_on_gpu(cuda, b, s, d, dtype):
    """The backward kernel against ``ref.mlstm_scan_bwd_ref`` (autograd of
    the chunked twin at the inputs' fp32 values), one head's rows under the
    floor, a padded last chunk where S is no multiple of 64; one counted
    launch a call."""
    q, k, v, li, lf, dy = _mlstm_bwd_on(mlstm_bwd_inputs(20, b, s, 3, d), cuda, DTYPES[dtype])
    native.reset_launches()
    got = ops.mlstm_scan_bwd(q, k, v, li, lf, dy, use_kernel=True)
    torch.cuda.synchronize()
    assert native.LAUNCHES["mlstm_scan_bwd"] == 1
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close_bwd(got, ref.mlstm_scan_bwd_ref(q, k, v, li, lf, dy, chunk=64), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 300, 4, 512), (4, 512, 4, 512)],
                         ids=["ragged", "training_shape"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_scan_backward_kernel_repeats_bit_for_bit_on_gpu(cuda, shape, dtype):
    """Two calls on the same inputs give bit-equal gradients: every sum (the
    slabs', the chunks', dlogf's reverse sum) runs in a fixed order."""
    q, k, v, li, lf, dy = _mlstm_bwd_on(mlstm_bwd_inputs(21, *shape), cuda, DTYPES[dtype])
    first = ops.mlstm_scan_bwd(q, k, v, li, lf, dy, use_kernel=True)
    again = ops.mlstm_scan_bwd(q, k, v, li, lf, dy, use_kernel=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_mlstm_scan_backward_kernel_long_row_on_gpu(cuda):
    """One row of 4096 tokens at xlstm's widths (4 heads of 512; 64 chunks,
    the walks' length and dlogf's longest reverse sum) in bf16, against the
    twin."""
    q, k, v, li, lf, dy = _mlstm_bwd_on(mlstm_bwd_inputs(22, 1, 4096, 4, 512), cuda,
                                        torch.bfloat16)
    got = ops.mlstm_scan_bwd(q, k, v, li, lf, dy, use_kernel=True)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close_bwd(got, ref.mlstm_scan_bwd_ref(q, k, v, li, lf, dy), "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_scan_autograd_through_the_kernels_on_gpu(cuda, dtype):
    """``torch.autograd.grad`` through ``ops.mlstm_scan(use_kernel=True)``:
    the output carries a ``grad_fn``, one forward and one backward launch,
    each gradient in its input's dtype and within the tolerance of autograd
    through the twin (``ops.mlstm_chunked``) on the same leaves."""
    td = DTYPES[dtype]
    q, k, v, li, lf, gy = _mlstm_bwd_on(mlstm_bwd_inputs(23, 2, 150, 4, 64), cuda, td)
    grads = {}
    for use in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, li, lf)]
        native.reset_launches()
        y = ops.mlstm_scan(*leaves, chunk=64, use_kernel=use)
        assert y.grad_fn is not None
        grads[use] = torch.autograd.grad((y.float() * gy.float()).sum(), leaves)
        torch.cuda.synchronize()
        if use:
            assert native.LAUNCHES["mlstm_scan"] == native.LAUNCHES["mlstm_scan_bwd"] == 1
    assert [g.dtype for g in grads[True]] == [td, td, td, torch.float32, torch.float32]
    _close_bwd(grads[True], grads[False], "float32" if dtype == "float32" else "bfloat16")


@pytest.mark.gpu
def test_mlstm_scan_backward_raises_off_its_shapes_on_gpu(cuda):
    """Off the card, and at a head dim past the kernels' 1024, the wrapper
    raises before any launch: no path falls back to the twin."""
    from repro_torch.kernels import mlstm_scan as mk
    q, k, v, li, lf, dy = _mlstm_bwd_on(mlstm_bwd_inputs(24, 1, 64, 2, 1025), cuda,
                                        torch.bfloat16)
    native.reset_launches()
    with pytest.raises(ValueError, match="head_dim 1025"):
        mk.mlstm_scan_bwd(q, k, v, li, lf, dy)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        mk.mlstm_scan_bwd(*(t[..., :16].cpu() if t.ndim == 4 else t.cpu()
                            for t in (q, k, v, li, lf, dy)))
    assert native.LAUNCHES["mlstm_scan_bwd"] == 0


@pytest.mark.gpu
def test_xlstm_smoke_gradients_through_the_scan_kernels_on_gpu(cuda):
    """xlstm's fp32 smoke config: every parameter leaf's gradient through the
    kernels within 1e-3 of the plain path's (the training legs' fp32 leaf
    limit: random-weight xlstm amplifies rounding), a leaf whose gradient is
    below 1e-6 of the tree's largest on the plain path below that floor on
    the kernel path too (the sLSTM's input-gate bias: ~7e-10, rounding
    alone; ``chip_smoke.py``'s ZERO_LEAF), and a training step launches
    RMSNorm and ``mlstm_scan``, each both ways, and no other."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, steps
    from repro_torch.optim import adamw
    cfg = registry.get_smoke_config("xlstm_1_3b")
    params = lm.init_params(cfg, seed=0, device=cuda, dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), device=cuda, generator=gen)
    batch = {**steps.batch_inputs(cfg, toks), "labels": toks}
    grads = {}
    for use in (True, False):
        leaves = adamw.tree_map(lambda p: p.clone().requires_grad_(), params)
        loss, _ = steps.loss_fn(leaves, cfg.replace(use_kernels=use), batch)
        grads[use] = torch.autograd.grad(loss, adamw.tree_leaves(leaves))
    assert len(grads[True]) == len(adamw.tree_leaves(params))
    floor = 1e-6 * max(float(b.abs().max()) for b in grads[False])
    for a, b in zip(grads[True], grads[False]):
        if float(b.abs().max()) < floor:
            assert float(a.abs().max()) < floor
        else:
            assert _rel(a, b) <= 1e-3
    native.reset_launches()
    steps.train_step(params, adamw.init_opt_state(params), batch,
                     cfg=cfg.replace(use_kernels=True))
    torch.cuda.synchronize()
    assert {k for k, n in native.LAUNCHES.items() if n} == {
        "rmsnorm", "rmsnorm_bwd", "mlstm_scan", "mlstm_scan_bwd"}


@pytest.mark.gpu
def test_kernels_without_a_backward_raise_under_grad_on_gpu(cuda):
    """decode attention refuses a call under grad, naming its ROADMAP item,
    instead of returning an output with no gradient; under no_grad it runs.
    Flash attention at D 320 and the SSD and mLSTM scans have their
    backward kernels: under grad their outputs carry the gradient
    function."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 8, 64, device=cuda, generator=g, requires_grad=True)
    kc = torch.randn(2, 16, 2, 64, device=cuda, generator=g)
    lens = torch.full((2,), 16, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="ROADMAP.md queue 2 item 2.4"):
        ops.decode_attention(q, kc, kc, lens, use_kernel=True)
    x, dt, A, Bm, Cm = _on(ssm_inputs(np.random.default_rng(0), 1, 32, 2, 8, 16), cuda,
                           torch.float32)
    y, hf = ops.ssm_scan(x.requires_grad_(), dt, A, Bm, Cm, use_kernel=True)
    assert y.grad_fn is not None and hf.grad_fn is not None
    qm, km, vm, li, fp = _on(mlstm_inputs(np.random.default_rng(0), 1, 32, 2, 16), cuda,
                             torch.float32)
    ym = ops.mlstm_scan(qm, km.requires_grad_(), vm, li, torch.nn.functional.logsigmoid(fp),
                        use_kernel=True)
    assert ym.grad_fn is not None
    wide = torch.randn(1, 16, 2, 320, device=cuda, generator=g, requires_grad=True)
    assert ops.flash_attention(wide, wide, wide, use_kernel=True).grad_fn is not None
    with torch.no_grad():
        ops.decode_attention(q, kc, kc, lens, use_kernel=True)
        ops.flash_attention(wide, wide, wide, use_kernel=True)
        assert ops.ssm_scan(x, dt, A, Bm, Cm, use_kernel=True)[0].grad_fn is None
        assert ops.mlstm_scan(qm, km, vm, li, fp, use_kernel=True).grad_fn is None


@pytest.mark.gpu
def test_the_card_has_a_hardware_spec_on_gpu(cuda):
    """The card's reported name resolves to its HardwareSpec, whose memory
    is within 8 % of what the card reports (chip_smoke.py's gate)."""
    from repro_torch.clouds.profiles import hardware_for
    hw = hardware_for(torch.cuda.get_device_name(0))
    memory = torch.cuda.get_device_properties(0).total_memory
    assert abs(hw.hbm_bytes - memory) <= 0.08 * memory
    assert hw.peak_flops_bf16 > hw.peak_flops_fp32 > 0 and hw.hbm_bw > 0


def _dp_rank_on_card(rank, batch):
    """One data-parallel step of granite's fp32 smoke config on the kernel
    path, this rank's rows of ``batch``, over a gloo group on ``cuda:0``:
    the global loss and gradients, the launches, and the update twice from
    the same gradients, plain and ZeRO-1, compared bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.launch import shardings
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm, steps
    from repro_torch.models import sharding as msh
    from repro_torch.optim import adamw
    mesh = make_local_mesh("cuda")
    cfg = registry.get_smoke_config("granite_3_8b").replace(use_kernels=True)
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    whole = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    specs = shardings.batch_shardings(whole, mesh)
    rows = {k: msh.local_slice(v, specs[k], mesh) for k, v in whole.items()}
    native.reset_launches()
    loss, _, grads = steps.dp_grads(params, rows, cfg=cfg)
    torch.cuda.synchronize()
    launches = {k for k, n in native.LAUNCHES.items() if n}
    runs = {}
    for zero1 in (False, True):
        p = adamw.tree_map(torch.clone, params)
        mu_specs = shardings.opt_shardings(None, p, mesh, zero1=zero1)["mu"]
        with msh.use_mesh(mesh):
            opt = steps.dp_opt_state(p, mu_specs)
            steps.dp_update_(p, grads, opt, specs=mu_specs)
        runs[zero1] = {"params": p, **{k: adamw.tree_map(
            lambda b, s: msh.gather_leaf(b, s, mesh), opt[k], mu_specs)
            for k in ("mu", "nu")}}
        if zero1:
            split = sum(bool(msh.splits(s, mesh)) for s in adamw.tree_leaves(mu_specs))
    differ = [i for i, (a, b) in enumerate(zip(*(adamw.tree_leaves(runs[z]) for z in runs)))
              if not torch.equal(a, b)]
    return {"loss": float(loss), "grads": [g.cpu() for g in adamw.tree_leaves(grads)],
            "launches": launches, "differ": differ, "split": split}


@pytest.fixture(scope="module")
def dp_on_card(tmp_path_factory):
    """Two gloo ranks sharing the card, each on 2 of 4 rows, against the
    one-process step on the same masters and batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA / Triton kernels run only on the card")
    from repro_torch.configs import registry
    from repro_torch.data.tokens import lm_batches
    from _ranks import spawn_ranks
    from repro_torch.models import lm, steps
    from repro_torch.optim import adamw
    cfg = registry.get_smoke_config("granite_3_8b").replace(use_kernels=True)
    batch = next(lm_batches(cfg, 4, 64, seed=1))
    batch["labels"][:2, 10:] = -1                  # the ranks' masks differ
    ranks = spawn_ranks(_dp_rank_on_card, 2, batch, out_dir=tmp_path_factory.mktemp("dp"),
                        timeout_s=300)
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    leaves = adamw.tree_map(lambda p: p.requires_grad_(), params)
    loss, _ = steps.loss_fn(leaves, cfg, {k: torch.as_tensor(v, device="cuda")
                                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, adamw.tree_leaves(leaves))
    return ranks, float(loss.detach()), [g.cpu() for g in grads]


@pytest.mark.gpu
def test_data_parallel_step_on_two_ranks_matches_one_process_on_gpu(cuda, dp_on_card):
    """chip_smoke.py's gate (a) at a small width: the loss within 1e-5, every
    all-reduced gradient leaf within 1e-4 (max |diff| / max |one| per
    leaf), through the four training kernels."""
    ranks, loss, grads = dp_on_card
    for r in ranks:
        assert abs(r["loss"] - loss) <= 1e-5 * abs(loss)
        assert len(r["grads"]) == len(grads)
        assert max(_rel(a, b) for a, b in zip(r["grads"], grads)) <= 1e-4
        assert r["launches"] == {"rmsnorm", "rmsnorm_bwd", "flash_attention",
                                 "flash_attention_bwd"}


@pytest.mark.gpu
def test_zero1_update_is_bitwise_plain_data_parallelism_on_gpu(cuda, dp_on_card):
    """chip_smoke.py's gate (b): from the same all-reduced gradients, the
    parameters and the gathered moments with ZeRO-1 equal plain DP's bit
    for bit, and ZeRO-1 split moments."""
    for r in dp_on_card[0]:
        assert r["split"] > 0 and r["differ"] == []


@pytest.mark.gpu
def test_launcher_mesh_local_defaults_to_a_one_rank_nccl_group_on_gpu(cuda, tmp_path,
                                                                      monkeypatch):
    """``launch.train --mesh local`` run plainly on the card, with no
    ``--dist-backend``: a one-rank nccl group on ``cuda:0``, whose losses are
    the one-process launcher's (the first bit for bit: one rank's sums are
    its own; the last within the trajectory tolerance, 1e-3)."""
    import torch.distributed as dist
    from repro_torch.launch import train
    backends = []
    join = dist.init_process_group
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: (backends.append(backend), join(backend, **kw)))
    args = ["--arch", "granite_3_8b", "--smoke", "--steps", "3"]
    dp = train.main(args + ["--mesh", "local", "--store", str(tmp_path / "dp")])
    assert backends == ["nccl"] and not dist.is_initialized()
    one = train.main(args + ["--store", str(tmp_path / "one")])
    assert dp["history"][0] == one["history"][0]
    assert abs(dp["loss"] - one["loss"]) <= 1e-3 * abs(one["loss"])
    assert dp["params"]["embed"].device == torch.device("cuda", 0)


# (b, s, local query heads, kv heads whole, head dim, kv heads sliced for the
# local query heads): a tensor-parallel rank's flash calls where the kv heads
# do not divide the model axis (granite's smoke config on 4 ranks, qwen2-vl's
# full width on 4 ranks: one kv head for 7 query heads), and granite's and
# granite-moe's full widths on 2 ranks, whose kv heads split with the query
# heads (granite-moe's 12 query heads over 4 kv heads: a local group of 3)
FLASH_TP_CASES = [(2, 64, 2, 2, 16, (0,)), (1, 256, 7, 4, 128, (1,)),
                  (1, 256, 16, 8, 128, (4, 5, 6, 7)), (1, 256, 12, 8, 64, (4, 5, 6, 7))]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,hq,hkv,d,kv", FLASH_TP_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_on_a_ranks_local_heads_on_gpu(cuda, b, s, hq, hkv, d, kv, dtype):
    """The flash forward and backward kernels on a tensor-parallel rank's
    heads: q at the local query heads, k and v the kv heads they read,
    sliced from the whole (``index_select``, as ``attention._local_kv``
    does); the output and the gradients of q and of the whole k and v
    against the twin's."""
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    q = torch.randn(b, s, hq, d, device=cuda, generator=g).to(td)
    k, v = (torch.randn(b, s, hkv, d, device=cuda, generator=g).to(td) for _ in range(2))
    do = torch.randn(b, s, hq, d, device=cuda, generator=g).to(td)
    idx = torch.tensor(kv, device=cuda)

    def run(use_kernel):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(leaves[0], *(torch.index_select(t, 2, idx) for t in leaves[1:]),
                                  use_kernel=use_kernel, causal=True)
        return out, torch.autograd.grad(out, leaves, do)

    native.reset_launches()
    out, got = run(True)
    torch.cuda.synchronize()
    assert native.LAUNCHES["flash_attention"] == native.LAUNCHES["flash_attention_bwd"] == 1
    q32, k32, v32 = (t.float().detach().requires_grad_() for t in (q, k, v))
    want_out = ops.flash_attention(q32, *(torch.index_select(t, 2, idx) for t in (k32, v32)),
                                   use_kernel=False, causal=True)
    want = torch.autograd.grad(want_out, (q32, k32, v32), do.float())
    _close(out.detach(), want_out.detach().to(td), dtype)
    for a, w in zip(got, want):
        _close(a, w.to(td), dtype)


def _tp_rank_on_card(rank, arch, batch, remat):
    """One tensor-parallel step of ``arch``'s fp32 smoke config on the
    kernel path (``remat``: each group checkpointed, so the backward reruns
    it on the autograd engine's own thread), over a gloo group of 2 ranks
    sharing ``cuda:0`` on a (1, 2) mesh: the loss, the gradients gathered
    whole, and the launches."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, steps
    from repro_torch.models import sharding as msh
    from repro_torch.optim import adamw
    mesh = make_mesh((1, 2), ("data", "model"), "cuda")
    cfg = registry.get_smoke_config(arch).replace(use_kernels=True, remat=remat)
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    whole = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    with msh.use_mesh(mesh):
        specs = msh.param_shardings(params, mesh)
        local = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone(), params, specs)
        native.reset_launches()
        loss, _, grads = steps.dp_grads(local, whole, cfg=cfg)
        torch.cuda.synchronize()
        launches = {k for k, n in native.LAUNCHES.items() if n}
        grads = adamw.tree_map(lambda g_, s: msh.gather_leaf(g_, s, mesh), grads, specs)
    return {"loss": float(loss), "grads": [g_.cpu() for g_ in adamw.tree_leaves(grads)],
            "launches": launches}


@pytest.mark.gpu
def test_tensor_parallel_step_on_two_ranks_matches_one_process_on_gpu(cuda, tmp_path):
    """chip_smoke.py's tensor-parallel gate (a) at a small width: 2 gloo
    ranks on the card, each on its shards and the whole batch, the loss
    within 1e-5 and every gradient leaf, gathered whole, within 1e-4 of one
    process, through the four training kernels."""
    _tp_on_card_matches_one_process(tmp_path, remat=False)


@pytest.mark.gpu
def test_tensor_parallel_step_with_remat_on_two_ranks_matches_one_process_on_gpu(cuda, tmp_path):
    """The same with each group checkpointed: on the card the backward
    reruns a group on the autograd engine's own thread, which must shard
    as the forward did (no active mesh there would give the same shapes
    and other values, silently)."""
    _tp_on_card_matches_one_process(tmp_path, remat=True)


@pytest.mark.gpu
def test_moe_tensor_parallel_step_on_two_ranks_matches_one_process_on_gpu(cuda, tmp_path):
    """The same for granite-moe: each rank on half of the experts, its
    flash calls at a local GQA group (4 query over 2 kv heads), the loss
    within 1e-5 and every gathered gradient leaf within 1e-4 of one
    process, through the four training kernels."""
    _tp_on_card_matches_one_process(tmp_path, remat=False, arch="granite_moe_3b_a800m")


def _tp_on_card_matches_one_process(tmp_path, *, remat, arch="granite_3_8b"):
    from repro_torch.configs import registry
    from repro_torch.data.tokens import lm_batches
    from _ranks import spawn_ranks
    from repro_torch.models import lm, steps
    from repro_torch.optim import adamw
    cfg = registry.get_smoke_config(arch).replace(use_kernels=True)
    batch = next(lm_batches(cfg, 4, 64, seed=1))
    ranks = spawn_ranks(_tp_rank_on_card, 2, arch, batch, remat, out_dir=tmp_path,
                        timeout_s=300)
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    leaves = adamw.tree_map(lambda p: p.requires_grad_(), params)
    loss, _ = steps.loss_fn(leaves, cfg, {k: torch.as_tensor(v, device="cuda")
                                          for k, v in batch.items()})
    grads = [g.cpu() for g in torch.autograd.grad(loss, adamw.tree_leaves(leaves))]
    loss = float(loss.detach())
    for r in ranks:
        assert abs(r["loss"] - loss) <= 1e-5 * abs(loss)
        assert len(r["grads"]) == len(grads)
        assert max(_rel(a, b) for a, b in zip(r["grads"], grads)) <= 1e-4
        assert r["launches"] == {"rmsnorm", "rmsnorm_bwd", "flash_attention",
                                 "flash_attention_bwd"}


# a range of a cache's kv heads, read in place by the decode kernel: (rows,
# heads a row holds, first head, heads read, query heads, D); the serving
# shapes of a tensor-parallel rank (granite on 16 ranks: 2 query heads over
# one of 8 kv heads) and a split cache
DECODE_RANGE_CASES = [(145, 8, 3, 1, 2, 128), (145, 8, 4, 4, 16, 128), (1300, 4, 1, 2, 14, 128),
                      (700, 4, 2, 1, 8, 320)]


@pytest.mark.gpu
@pytest.mark.parametrize("s,hs,first,n,hq,d", DECODE_RANGE_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_reads_a_range_of_cache_heads_in_place_on_gpu(cuda, s, hs, first, n, hq,
                                                                     d, dtype):
    """Decode attention over a ``narrow`` of a contiguous cache's heads (a
    tensor-parallel rank's kv heads in a cache whole on every rank): the
    wrapper passes the view as it is (its row holds ``hs`` heads) and the
    result is the twin's on the same view."""
    from repro_torch.kernels import decode_attention as dec
    g = torch.Generator(device=cuda).manual_seed(0)
    td = DTYPES[dtype]
    q = torch.randn(3, hq, d, device=cuda, generator=g).to(td)
    kc, vc = (torch.randn(3, s, hs, d, device=cuda, generator=g).to(td).narrow(2, first, n)
              for _ in range(2))
    assert dec._row_heads(kc) == dec._row_heads(vc) == hs
    lens = torch.tensor([s, s // 2, 1], dtype=torch.int32, device=cuda)
    _close(ops.decode_attention(q, kc, vc, lens, use_kernel=True),
           ref.decode_attention_ref(q, kc, vc, lens), dtype)


def _tp_decode_rank_on_card(rank, arch, inputs, nxt):
    """Prefill and one decode step of ``arch``'s fp32 smoke config on the
    kernel path, over a gloo group of 2 ranks sharing ``cuda:0`` on a (1, 2)
    mesh: each rank on its shards, its heads and its block of the cache;
    the whole logits, the launches and the shapes of the first slot's
    cache blocks."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, steps
    from repro_torch.models import sharding as msh
    from repro_torch.optim import adamw
    mesh = make_mesh((1, 2), ("data", "model"), "cuda")
    cfg = registry.get_smoke_config(arch).replace(use_kernels=True)
    params = lm.init_params(cfg, seed=0, device="cuda")
    inputs = {k: torch.as_tensor(v, device="cuda") for k, v in inputs.items()}
    b, s = inputs["tokens"].shape
    with msh.use_mesh(mesh):
        specs = msh.param_shardings(params, mesh)
        local = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone(), params, specs)
        native.reset_launches()
        last, cache = steps.prefill(local, inputs, cfg=cfg, cache_len=s + 1)
        logits, cache = steps.serve_step(local, cache, torch.as_tensor(nxt, device="cuda"),
                                         steps.start_positions(cfg, b, s, "cuda"), cfg=cfg)
        torch.cuda.synchronize()
    return {"prefill": last.cpu(), "decode": logits.cpu(),
            "launches": {k for k, n in native.LAUNCHES.items() if n},
            "cache": {k: tuple(t.shape) for k, t in cache["phase0"]["slot0"].items()}}


def _tp_decode_on_card(tmp_path, arch, launches):
    """``_tp_decode_rank_on_card`` on 2 ranks against one process: a
    seeded prompt (4 x 16; whisper also seeded frames), both ranks'
    whole logits within 1e-4 of one process's (fp32) and their launch set
    ``launches``.  Returns the ranks' results and the smoke config."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, steps
    from _ranks import spawn_ranks
    cfg = registry.get_smoke_config(arch).replace(use_kernels=True)
    gen = np.random.default_rng(3)
    inputs = {"tokens": gen.integers(0, cfg.vocab_size, (4, 16), dtype=np.int32)}
    nxt = gen.integers(0, cfg.vocab_size, (4, 1), dtype=np.int32)
    if cfg.family == "audio":
        inputs["frames"] = gen.standard_normal((4, cfg.encoder_len, cfg.d_model),
                                               dtype=np.float32)
    ranks = spawn_ranks(_tp_decode_rank_on_card, 2, arch, inputs, nxt, out_dir=tmp_path,
                        timeout_s=300)
    params = lm.init_params(cfg, seed=0, device="cuda")
    last, cache = steps.prefill(params, {k: torch.as_tensor(v, device="cuda")
                                         for k, v in inputs.items()}, cfg=cfg, cache_len=17)
    logits, _ = steps.serve_step(params, cache, torch.as_tensor(nxt, device="cuda"),
                                 steps.start_positions(cfg, 4, 16, "cuda"), cfg=cfg)
    for r in ranks:
        assert r["launches"] == set(launches)
        assert _rel(r["prefill"], last.cpu()) <= 1e-4
        assert _rel(r["decode"], logits.cpu()) <= 1e-4
    return ranks, cfg


@pytest.mark.gpu
def test_tensor_parallel_decode_on_two_ranks_matches_one_process_on_gpu(cuda, tmp_path):
    """Tensor-parallel serving on the card: 2 gloo ranks, each on its
    shards, its kv head of granite's smoke config (2 over 2 ranks) and its
    block of the cache, run a prefill and one decode step through flash
    attention, decode attention and RMSNorm; both ranks' whole logits
    within 1e-4 of one process (fp32)."""
    ranks, cfg = _tp_decode_on_card(tmp_path, "granite_3_8b",
                                    ("rmsnorm", "flash_attention", "decode_attention"))
    for r in ranks:
        assert r["cache"]["k"][3] == cfg.n_kv_heads // 2


@pytest.mark.gpu
def test_zamba2_tensor_parallel_decode_on_two_ranks_matches_one_process_on_gpu(cuda, tmp_path):
    """Tensor parallelism of Mamba2 on the card: 2 gloo ranks, each on 2 of
    the smoke config's 4 heads, 144 of its 288 conv channels and its block
    of every state, run a prefill and one decode step through ``ssm_scan``,
    flash attention, decode attention (the shared block) and RMSNorm; both
    ranks' whole logits within 1e-4 of one process (fp32)."""
    ranks, cfg = _tp_decode_on_card(tmp_path, "zamba2_1_2b", ("rmsnorm", "flash_attention",
                                                               "decode_attention", "ssm_scan"))
    conv = cfg.d_inner + 2 * cfg.ssm_state
    for r in ranks:
        assert r["cache"]["ssm"][2] == cfg.n_heads // 2 and r["cache"]["conv"][3] == conv // 2


@pytest.mark.gpu
def test_whisper_tensor_parallel_decode_on_two_ranks_matches_one_process_on_gpu(cuda, tmp_path):
    """Tensor parallelism of enc-dec on the card: 2 gloo ranks, each on 2 of
    the smoke config's 4 heads in the encoder, the self-attention and the
    cross-attention, and on its block of the cache (``cross_k``/``cross_v``
    included), run a prefill over seeded frames and one decode step through
    flash attention, decode attention and RMSNorm; both ranks' whole logits
    within 1e-4 of one process (fp32)."""
    ranks, cfg = _tp_decode_on_card(tmp_path, "whisper_base",
                                    ("rmsnorm", "flash_attention", "decode_attention"))
    for r in ranks:
        assert r["cache"]["cross_k"] == (cfg.n_layers, 4, cfg.encoder_len, cfg.n_kv_heads // 2,
                                         cfg.head_dim)
        assert r["cache"]["k"][3] == cfg.n_kv_heads // 2
