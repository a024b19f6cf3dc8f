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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import native, ops, ref  # noqa: E402
from test_torch_gpu import (DECODE_CASES, FLASH_CASES, RMSNORM_SHAPES,  # noqa: E402
                            tol)

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
    assert native.LAUNCHES == {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0}


@pytest.mark.parametrize("fn,args", [
    ("rmsnorm", lambda: (torch.empty(2, 8, device="meta"), torch.empty(8, device="meta"))),
    ("flash_attention", lambda: tuple(torch.empty(1, 4, 2, 8, device="meta")
                                      for _ in range(3))),
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
