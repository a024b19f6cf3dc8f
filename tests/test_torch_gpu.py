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


def tol(dtype_name):
    return dict(rtol=2e-2, atol=2e-2) if dtype_name == "bfloat16" else \
        dict(rtol=3e-4, atol=3e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA / Triton kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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


@pytest.mark.gpu
def test_wrappers_count_launches_and_reject_wide_heads(cuda):
    native.reset_launches()
    q = torch.randn(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    ops.flash_attention(q, q, q, use_kernel=True)
    ops.decode_attention(q[:, 0], q, q, torch.full((1,), 8, dtype=torch.int32, device=cuda),
                         use_kernel=True)
    ops.rmsnorm(q, torch.zeros(64, device=cuda, dtype=torch.bfloat16), use_kernel=True)
    assert native.LAUNCHES == {"rmsnorm": 1, "flash_attention": 1, "decode_attention": 1}
    wide = torch.randn(1, 8, 2, 192, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 192"):
        ops.flash_attention(wide, wide, wide, use_kernel=True)
    assert native.LAUNCHES["flash_attention"] == 1


@pytest.mark.gpu
def test_smoke_model_kernel_path_matches_plain_path_on_gpu(cuda):
    """granite-3-8b smoke config (fp32, head_dim 16): forward and a decode
    step through the kernels agree with the plain path on the same weights."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, steps
    cfg = registry.get_smoke_config("granite_3_8b")
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
