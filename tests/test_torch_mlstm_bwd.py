"""The backward of the mLSTM scan (``mlstm_scan``'s gradient), on the CPU.

The backward kernel (``kernels/csrc/mlstm_scan_bwd.cu``) runs only on the
card (``tests/test_torch_gpu.py``, ``gpu`` marker); here its two CPU
stand-ins are held:

* the port's plain backward (``ref.mlstm_scan_bwd_ref``: autograd of the
  chunked twin ``ops.mlstm_chunked`` in fp32, the twin the card holds the
  kernel to) against ``jax.vjp`` of the reference's chunked form
  (``models/ssm._mlstm_chunked``) and of its sequential oracle
  (``ref.mlstm_scan_ref``, which takes the forget gate's preactivation),
  at a ragged S, within 3e-4 of each gradient's largest value;
* the kernel's passes (``ref.mlstm_scan_bwd_chunked_ref`` at the kernel's
  64-row chunks: the gates, the forward walk, the chunks' matrices, the
  rows' denominators, the reverse walk, the per-chunk gradients, the gates'
  sums) against the plain backward at the same tolerance: at H 1 and 3, D
  16 and 64, where the denominator's floor binds (logi near -30) and where
  it does not, under strong forgetting (logf near -10), over 18 chunks and
  over 1200 rows (dlogf's long reverse sum);
* the identities the kernel takes the gate gradients from, on autograd's
  own gradients: dlogi_s = <k_s, dk_s> and dlogf_j = sum_{t >= j} (<q_t,
  dq_t> - <k_t, dk_t>).

One xlstm training step against the reference is
``tests/test_torch_train.py``'s.  Inputs come from numpy with a seed.  Run:
``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_mlstm_bwd.py``.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models.ssm import _mlstm_chunked  # noqa: E402
from repro_torch.kernels import mlstm_scan, ops, ref  # noqa: E402

torch.set_num_threads(1)

TOL = 3e-4                      # fp32, tests/test_kernels.py:17-19, of the largest value
NAMES = ("dq", "dk", "dv", "dlogi", "dlogf")


def _draw(seed: int, b: int, s: int, h: int, d: int, *, li_shift: float = 0.0,
          f_bias: float = 2.0):
    """q, k, v, logi and the forget gate's preactivation as
    tests/test_kernels.py draws them (logi ~ 0.5 N(0, 1) + ``li_shift``,
    the preactivation N(0, 1) + ``f_bias``), and the cotangent dy, fp32
    numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, dy = (rng.standard_normal((b, s, h, d), dtype=np.float32) for _ in range(4))
    logi = rng.standard_normal((b, s, h), dtype=np.float32) * 0.5 + np.float32(li_shift)
    fpre = rng.standard_normal((b, s, h), dtype=np.float32) + np.float32(f_bias)
    return q, k, v, logi, fpre, dy


def _logf(fpre: np.ndarray) -> torch.Tensor:
    return torch.nn.functional.logsigmoid(torch.from_numpy(fpre))


def _assert_close(got, want, what: str):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        err = np.abs(g - w).max()
        assert err <= TOL * np.abs(w).max(), (what, name, err, np.abs(w).max())


@pytest.mark.parametrize("oracle", ["_mlstm_chunked", "mlstm_scan_ref"])
def test_plain_backward_matches_the_reference_vjp(oracle):
    """``ref.mlstm_scan_bwd_ref`` against ``jax.vjp`` of the reference's
    chunked mLSTM (chunk 32) and of its sequential oracle, at a ragged S.
    The oracle takes the forget gate's preactivation: its gradient is
    dlogf times log-sigmoid's derivative, sigmoid(-x)."""
    q, k, v, logi, fpre, dy = _draw(0, 2, 70, 3, 16)
    logf = _logf(fpre)
    if oracle == "_mlstm_chunked":
        fn = lambda *a: _mlstm_chunked(*a, 32)[0]  # noqa: E731
        gate = logf.numpy()
    else:
        fn = jref.mlstm_scan_ref
        gate = fpre
    _, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v, logi, gate)))
    want = vjp(jnp.asarray(dy))
    got = ref.mlstm_scan_bwd_ref(*(torch.from_numpy(t) for t in (q, k, v, logi)), logf,
                                 torch.from_numpy(dy), chunk=32)
    assert all(g.dtype == torch.float32 for g in got)
    got = [g.numpy() for g in got]
    if oracle == "mlstm_scan_ref":
        got[4] = got[4] * torch.sigmoid(-torch.from_numpy(fpre)).numpy()
    _assert_close(got, want, oracle)


# (name, b, s, h, d, li_shift, f_bias): the kernel's edge cases
CHUNKED_CASES = [
    ("ragged S 100, H 3, D 16", 2, 100, 3, 16, 0.0, 2.0),
    ("S 130, H 1, D 64", 1, 130, 1, 64, 0.0, 2.0),
    ("H 3, D 64, S below a chunk", 2, 40, 3, 64, 0.0, 2.0),
    ("the floor binds (logi near -30), D 16", 2, 100, 3, 16, -30.0, 2.0),
    ("strong forgetting (logf near -10), D 64", 1, 130, 3, 64, 0.0, -10.0),
    ("18 chunks, D 16", 1, 1152, 1, 16, 0.0, 2.0),
    ("1200 rows, H 3, D 16: dlogf's long reverse sum", 1, 1200, 3, 16, 0.0, 4.0),
]


@pytest.mark.parametrize("case", CHUNKED_CASES, ids=[c[0] for c in CHUNKED_CASES])
def test_kernel_passes_match_the_plain_backward(case):
    """The kernel's passes at its 64-row chunks against autograd of the twin
    at the config's 256: the same gradient up to rounding."""
    _, b, s, h, d, li_shift, f_bias = case
    q, k, v, logi, fpre, dy = _draw(1, b, s, h, d, li_shift=li_shift, f_bias=f_bias)
    args = [torch.from_numpy(t) for t in (q, k, v, logi)] + [_logf(fpre), torch.from_numpy(dy)]
    want = ref.mlstm_scan_bwd_ref(*args, chunk=256)
    got = ref.mlstm_scan_bwd_chunked_ref(*args, chunk=64)
    for g in got:
        assert bool(torch.isfinite(g).all())
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want], case[0])


def test_floor_binding_rows_take_no_denominator_gradient():
    """Where the floor binds in every row (logi near -30: |n . q| far below
    exp(-m_row)), y is the numerator over the floor, linear in v: the plain
    backward's dv is then exactly the product of dy with y's weights, and the
    kernel's passes agree with it."""
    q, k, v, logi, fpre, dy = _draw(2, 1, 64, 2, 16, li_shift=-30.0)
    args = [torch.from_numpy(t) for t in (q, k, v, logi)] + [_logf(fpre), torch.from_numpy(dy)]
    y = ops.mlstm_chunked(*args[:5], 64)[0]
    want = ref.mlstm_scan_bwd_ref(*args, chunk=64)
    # y is linear in v here, so <dy, y> = <dv, v>
    lhs = float((torch.from_numpy(dy) * y).sum())
    rhs = float((want[2] * args[2]).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1e-20), (lhs, rhs)
    got = ref.mlstm_scan_bwd_chunked_ref(*args, chunk=64)
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want], "floor")


@pytest.mark.parametrize("s", [100, 1100])
def test_gate_gradient_identities(s):
    """On autograd's own gradients: dlogi_s = <k_s, dk_s> and dlogf_j =
    sum_{t >= j} (<q_t, dq_t> - <k_t, dk_t>), within 3e-4 of the largest
    value (the kernel takes both gate gradients from these identities)."""
    q, k, v, logi, fpre, dy = _draw(3, 2, s, 2, 16)
    args = [torch.from_numpy(t) for t in (q, k, v, logi)] + [_logf(fpre), torch.from_numpy(dy)]
    dq, dk, _, dlogi, dlogf = ref.mlstm_scan_bwd_ref(*args, chunk=64)
    kdk = (args[1] * dk).sum(-1)
    qdq = (args[0] * dq).sum(-1)
    rev = torch.flip(torch.cumsum(torch.flip(qdq - kdk, [1]), dim=1), [1])
    for name, got, want in (("dlogi", kdk, dlogi), ("dlogf", rev, dlogf)):
        err = float((got - want).abs().max())
        assert err <= TOL * float(want.abs().max()), (name, err)


def test_dispatch_and_the_kernel_wrapper_on_the_cpu():
    """``ops.mlstm_scan_bwd`` takes the plain backward on CPU tensors, even
    with ``use_kernel=True``; the kernel's wrapper raises on them; and
    ``ops.mlstm_scan`` under grad on the CPU is autograd of the twin, the
    same gradient."""
    q, k, v, logi, fpre, dy = _draw(4, 1, 70, 2, 16)
    args = [torch.from_numpy(t) for t in (q, k, v, logi)] + [_logf(fpre), torch.from_numpy(dy)]
    want = ref.mlstm_scan_bwd_ref(*args, chunk=64)
    got = ops.mlstm_scan_bwd(*args, chunk=64, use_kernel=True)
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want], "ops")
    with pytest.raises(ValueError, match="no kernel for device"):
        mlstm_scan.mlstm_scan_bwd(*args)
    leaves = [t.clone().requires_grad_() for t in args[:5]]
    y = ops.mlstm_scan(*leaves, chunk=64, use_kernel=True)
    assert y.grad_fn is not None
    grads = torch.autograd.grad(y, leaves, args[5])
    _assert_close([g.numpy() for g in grads], [w.numpy() for w in want], "autograd")
