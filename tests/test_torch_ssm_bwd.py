"""The backward of the Mamba2 SSD scan (``ssm_scan``'s gradient), on the CPU.

The backward kernel (``kernels/csrc/ssm_scan_bwd.cu``) runs only on the card
(``tests/test_torch_gpu.py``, ``gpu`` marker); here its two CPU stand-ins
are held:

* the port's plain backward (``ref.ssm_scan_bwd_ref``: autograd of the
  chunked twin ``ops.ssd_chunked`` in fp32, the twin the card holds the
  kernel to) against ``jax.vjp`` of the reference's chunked form
  (``ops.ssd_chunked_jnp``) and of its sequential oracle
  (``ref.ssm_scan_ref``), the cotangent covering both ``y`` and
  ``h_final``, within 3e-4 of each gradient's largest value;
* the kernel's passes (``ref.ssm_scan_bwd_chunked_ref`` at the kernel's
  64-row chunks: states and local state gradients, the two carries, the
  per-chunk terms, the sums over heads) against the plain backward at the
  same tolerance, at a ragged S, with and without ``dh_final``, at N 16
  and 64, P 8 and 64, H 1, 3 and 4, under extreme decay (A = -16, dt ~ 5:
  there dA is zero to ~1e-33, held below 3e-4 of ``ZERO``),
  and on a tensor-parallel rank's block of heads with B and C whole;
* the order of the bf16 kernel's wgmma passes (``ref.ssm_scan_bwd_walk_ref``:
  the forward and reverse walks over the chunks, states stored as bf16 hi
  + lo, dB and dC summed in head groups of 4 and then over the groups)
  against the plain backward at the same tolerance, at the cases above,
  at H 3 and 5 (a group short), over 18 chunks at P 8 and N 16 (the
  walks' length), and on a rank's block of heads.

One zamba2 training step against the reference is
``tests/test_torch_train.py``'s.  Inputs come from numpy with a seed.  Run:
``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_ssm_bwd.py``.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(1)

TOL = 3e-4                      # fp32, tests/test_kernels.py:17-19, of the largest value
# a gradient whose largest value is below ZERO is held at 3e-4 of ZERO: it
# moves no weight (AdamW divides by sqrt(nu) + 1e-8).  Under extreme decay
# dA's true value is ~1e-33 (every decay but the last row's underflows),
# which the autograd twin rounds to 0 (its terms of ~10 cancel) and the
# kernel's passes keep
ZERO = 1e-20
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _draw(seed: int, b: int, s: int, h: int, p: int, n: int, extreme: bool = False):
    """x, dt, A, B, C as tests/test_kernels.py draws them (``extreme``: A =
    -16 and dt ~ 5 on every head, so a chunk's decay underflows), and the
    cotangents dy (B,S,H,P) and dh_final (B,H,P,N), fp32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    A = -np.abs(rng.standard_normal(h, dtype=np.float32)) * 4
    if extreme:
        dt = 5.0 + 0.1 * rng.standard_normal((b, s, h), dtype=np.float32)
        A = np.full(h, -16.0, dtype=np.float32)
    Bm = rng.standard_normal((b, s, n), dtype=np.float32) * 0.3
    Cm = rng.standard_normal((b, s, n), dtype=np.float32) * 0.3
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dh = rng.standard_normal((b, h, p, n), dtype=np.float32)
    return x, dt, A, Bm, Cm, dy, dh


def _assert_close(got, want, what: str):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        err = np.abs(g - w).max()
        assert err <= TOL * max(np.abs(w).max(), ZERO), (what, name, err, np.abs(w).max())


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("oracle", ["ssd_chunked_jnp", "ssm_scan_ref"])
@pytest.mark.parametrize("with_dh", [False, True], ids=["dh_none", "dh_final"])
def test_plain_backward_matches_the_reference_vjp(oracle, with_dh):
    """``ref.ssm_scan_bwd_ref`` against ``jax.vjp`` of the reference's
    chunked SSD (chunk 32) and of its sequential oracle, at a ragged S, the
    cotangent on y and (or not) on h_final."""
    x, dt, A, Bm, Cm, dy, dh = _draw(0, 2, 70, 3, 8, 16)
    if oracle == "ssd_chunked_jnp":
        fn = lambda *a: jops.ssd_chunked_jnp(*a, chunk=32)  # noqa: E731
    else:
        fn = jref.ssm_scan_ref
    (_, hf), vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (x, dt, A, Bm, Cm)))
    cot_h = jnp.asarray(dh) if with_dh else jnp.zeros_like(hf)
    want = vjp((jnp.asarray(dy), cot_h))
    got = ref.ssm_scan_bwd_ref(*_torch((x, dt, A, Bm, Cm, dy)),
                               torch.from_numpy(dh) if with_dh else None, chunk=32)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_close([g.numpy() for g in got], want, oracle)


# (name, b, s, h, p, n, extreme): the kernel's edge cases
CHUNKED_CASES = [
    ("ragged S 100, H 3, P 8, N 16", 2, 100, 3, 8, 16, False),
    ("S 130, H 4, P 64, N 64", 1, 130, 4, 64, 64, False),
    ("one head, P 64, N 16", 2, 64, 1, 64, 16, False),
    ("H 4, P 8, N 64, S below a chunk", 2, 40, 4, 8, 64, False),
    ("extreme decay, 64-row chunks", 1, 128, 4, 8, 16, True),
]


@pytest.mark.parametrize("case", CHUNKED_CASES, ids=[c[0] for c in CHUNKED_CASES])
@pytest.mark.parametrize("with_dh", [False, True], ids=["dh_none", "dh_final"])
def test_kernel_passes_match_the_plain_backward(case, with_dh):
    """The kernel's passes at its 64-row chunks against autograd of the twin
    at the config's 256: the same gradient up to rounding."""
    _, b, s, h, p, n, extreme = case
    x, dt, A, Bm, Cm, dy, dh = _torch(_draw(1, b, s, h, p, n, extreme))
    dh = dh if with_dh else None
    want = ref.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dh, chunk=256)
    got = ref.ssm_scan_bwd_chunked_ref(x, dt, A, Bm, Cm, dy, dh, chunk=64)
    for g in got:
        assert bool(torch.isfinite(g).all())
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want], case[0])


def test_kernel_passes_on_a_rank_of_heads():
    """A tensor-parallel rank's scan: x, dt, A on its block of heads (2 of
    4), B and C whole.  Its gradients match the plain backward on the same
    block; dx, ddt and dA are the whole call's block, and the two ranks' dB
    and dC (partial over the ranks, summed by the mixer's ``copy``) add up
    to the whole call's."""
    x, dt, A, Bm, Cm, dy, dh = _torch(_draw(2, 2, 100, 4, 8, 16))
    whole = ref.ssm_scan_bwd_chunked_ref(x, dt, A, Bm, Cm, dy, dh, chunk=64)
    parts = []
    for h0 in (0, 2):
        blk = slice(h0, h0 + 2)
        args = (x[:, :, blk], dt[:, :, blk], A[blk], Bm, Cm, dy[:, :, blk], dh[:, blk])
        got = ref.ssm_scan_bwd_chunked_ref(*args, chunk=64)
        _assert_close([g.numpy() for g in got],
                      [w.numpy() for w in ref.ssm_scan_bwd_ref(*args, chunk=256)],
                      f"rank block {h0}")
        for g, w in zip(got[:2], whole[:2]):
            _assert_close([g.numpy()], [w[:, :, blk].numpy()], f"rank block {h0}")
        _assert_close([got[2].numpy()], [whole[2][blk].numpy()], f"rank block {h0}")
        parts.append(got)
    for i in (3, 4):
        _assert_close([(parts[0][i] + parts[1][i]).numpy()], [whole[i].numpy()], "B, C summed")


# (name, b, s, h, p, n, extreme): the wgmma passes' head groups and walks
WALK_CASES = CHUNKED_CASES + [
    ("H 3, one short group", 2, 100, 3, 8, 16, False),
    ("H 5, a second group of one head", 1, 130, 5, 16, 16, False),
    ("18 chunks, P 8, N 16", 1, 1100, 2, 8, 16, False),
]


@pytest.mark.parametrize("case", WALK_CASES, ids=[c[0] for c in WALK_CASES])
@pytest.mark.parametrize("with_dh", [False, True], ids=["dh_none", "dh_final"])
def test_walk_order_matches_the_plain_backward(case, with_dh):
    """The wgmma passes' order (walks, head groups of 4, the operands'
    bf16 hi + lo) at 64-row chunks against autograd of the twin at 256."""
    _, b, s, h, p, n, extreme = case
    x, dt, A, Bm, Cm, dy, dh = _torch(_draw(4, b, s, h, p, n, extreme))
    dh = dh if with_dh else None
    want = ref.ssm_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dh, chunk=256)
    got = ref.ssm_scan_bwd_walk_ref(x, dt, A, Bm, Cm, dy, dh, chunk=64, heads=4)
    for g in got:
        assert bool(torch.isfinite(g).all())
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want], case[0])


def test_walk_order_on_a_rank_of_heads():
    """A rank's block of 3 of 6 heads (one group of 3) in the wgmma passes'
    order: its gradients match the plain backward on the block, and the two
    ranks' dB and dC add up to the whole call's (two groups, 4 + 2)."""
    x, dt, A, Bm, Cm, dy, dh = _torch(_draw(5, 2, 100, 6, 8, 16))
    whole = ref.ssm_scan_bwd_walk_ref(x, dt, A, Bm, Cm, dy, dh, chunk=64, heads=4)
    parts = []
    for h0 in (0, 3):
        blk = slice(h0, h0 + 3)
        args = (x[:, :, blk], dt[:, :, blk], A[blk], Bm, Cm, dy[:, :, blk], dh[:, blk])
        got = ref.ssm_scan_bwd_walk_ref(*args, chunk=64, heads=4)
        _assert_close([g.numpy() for g in got],
                      [w.numpy() for w in ref.ssm_scan_bwd_ref(*args, chunk=256)],
                      f"rank block {h0}")
        for g, w in zip(got[:2], whole[:2]):
            _assert_close([g.numpy()], [w[:, :, blk].numpy()], f"rank block {h0}")
        parts.append(got)
    for i in (3, 4):
        _assert_close([(parts[0][i] + parts[1][i]).numpy()], [whole[i].numpy()], "B, C summed")


def test_plain_backward_keeps_each_dtype():
    """bf16 x, dt, B, C and an fp32 A: each gradient in its input's dtype."""
    x, dt, A, Bm, Cm, dy, _ = _torch(_draw(3, 1, 20, 2, 8, 16))
    bf = [t.to(torch.bfloat16) for t in (x, dt, Bm, Cm, dy)]
    got = ref.ssm_scan_bwd_ref(bf[0], bf[1], A, bf[2], bf[3], bf[4])
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    assert [tuple(g.shape) for g in got] == [(1, 20, 2, 8), (1, 20, 2), (2,), (1, 20, 16),
                                             (1, 20, 16)]
