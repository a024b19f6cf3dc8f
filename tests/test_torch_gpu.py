"""The port's CUDA / Triton kernels against their plain twins, on the card.

Marked ``gpu``: without an NVIDIA GPU every test skips.  This file imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The shapes are those of tests/test_kernels.py, which test_torch_kernels.py
also uses to hold the twins to the JAX reference; the tolerances are the
reference's (tests/test_kernels.py:17-19): 3e-4 in fp32, 2e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import native, ops, ref  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RMSNORM_SHAPES = [(4, 64), (3, 17, 128), (2, 5, 7, 96)]
# (sq, skv, hq, hkv, d, window); q_offset = skv - sq
FLASH_CASES = [
    (64, 64, 4, 4, 32, 0),        # MHA causal
    (100, 100, 4, 2, 32, 0),      # GQA, Sq no block divides
    (64, 64, 8, 2, 64, 24),       # sliding window
    (33, 128, 4, 4, 32, 0),       # cross-length, q_offset 95
]
# (s, hq, hkv, d, reference block_k); lengths [s, s//2, 1]
DECODE_CASES = [(128, 4, 4, 32, 64), (200, 8, 2, 64, 64), (64, 4, 1, 128, 32)]
# (s, h, p, n, chunk): tests/test_kernels.py:70-72, then zamba2's P 128 and
# N 64 with S not a multiple of the chunk
SSM_CASES = [(64, 2, 8, 16, 16), (96, 3, 16, 8, 32), (50, 1, 4, 4, 16)]
SSM_GPU_CASES = SSM_CASES + [(300, 4, 128, 64, 256)]
# (s, h, d, chunk): tests/test_kernels.py:131-132, then xlstm's D 512
MLSTM_CASES = [(37, 3, 8, 8), (64, 2, 16, 16), (50, 1, 32, 37)]
MLSTM_GPU_CASES = MLSTM_CASES + [(300, 2, 512, 256)]


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
@pytest.mark.parametrize("sq,skv,hq,hkv,d,window", FLASH_CASES)
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
def test_wrappers_count_launches_and_reject_wide_heads(cuda):
    native.reset_launches()
    q = torch.randn(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    ops.flash_attention(q, q, q, use_kernel=True)
    ops.decode_attention(q[:, 0], q, q, torch.full((1,), 8, dtype=torch.int32, device=cuda),
                         use_kernel=True)
    ops.rmsnorm(q, torch.zeros(64, device=cuda, dtype=torch.bfloat16), use_kernel=True)
    assert native.LAUNCHES == {"rmsnorm": 1, "flash_attention": 1, "decode_attention": 1,
                               "ssm_scan": 0, "mlstm_scan": 0}
    wide = torch.randn(1, 8, 2, 192, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 192"):
        ops.flash_attention(wide, wide, wide, use_kernel=True)
    assert native.LAUNCHES["flash_attention"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite_3_8b", "zamba2_1_2b", "xlstm_1_3b"])
def test_smoke_model_kernel_path_matches_plain_path_on_gpu(cuda, arch):
    """Smoke configs (fp32): prefill and a decode step through the kernels
    agree with the plain path on the same weights (granite: attention and
    norms; zamba2: the SSD scan and the shared attention block's kernels;
    xlstm: norms, and below its scoring forward through the mLSTM scan)."""
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
