"""The flash attention backward past head dim 128 (gemma3's 320, deepseek's
MLA 192 with v zero-padded from 128), on the CPU.

The backward kernel itself runs only on the card (``tests/test_torch_gpu.py``,
``gpu`` marker); here its two CPU stand-ins are held at the wide head dims:

* the port's plain backward (``ref.flash_attention_bwd_ref``, the twin the
  card holds the kernel to) against ``jax.vjp`` of the reference's
  ``flash_attention_ref`` (``src/repro/kernels/ref.py``), fp32, within 3e-4
  of each gradient's largest value;
* the kernel's order of rounding at the wide tiles
  (``ref.flash_attention_bwd_order_ref`` with its 32-key tiles and Delta =
  sum_j P dP from the first sweep in every block) within half the card's
  rule of the fp32 gradient, on the inputs where the usual flash
  backward's orders miss (a nearly one-hot row, keys with a common part),
  where Delta from O32 loses (dP_ij near Delta_i on a key few queries
  see) and on seeded random ones;
* MLA's padded call: dq and dk as the unpadded call's, dv zero past 128.

Inputs come from numpy with a seed.  Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu
python -m pytest tests/test_torch_flash_bwd_wide.py``.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_gpu import rule_share  # noqa: E402

torch.set_num_threads(1)

MLA_QK, MLA_V = 192, 128        # deepseek-v2-lite: qk nope 128 + rope 64, v 128
GEMMA3_D = 320                  # gemma3-4b: 2560 / 8


def _draw(seed: int, s: int, hq: int, hkv: int, d: int, dv: int = 0):
    """q, k (D columns), v, dO (``dv`` columns, zero-padded to D where dv <
    D: MLA's call, whose output is cut at dv), fp32 numpy."""
    rng = np.random.default_rng(seed)
    dv = dv or d
    q = rng.standard_normal((1, s, hq, d), dtype=np.float32)
    k = rng.standard_normal((1, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((1, s, hkv, dv), dtype=np.float32)
    do = rng.standard_normal((1, s, hq, dv), dtype=np.float32)
    pad = [(0, 0)] * 3 + [(0, d - dv)]
    return q, k, np.pad(v, pad), np.pad(do, pad)


# (name, seq, query heads, kv heads, head dim, v columns, window)
VJP_CASES = [("gemma3: D 320, GQA 2:1, window 32", 96, 4, 2, GEMMA3_D, 0, 32),
             ("mla: D 192, v padded from 128", 96, 4, 4, MLA_QK, MLA_V, 0)]


@pytest.mark.parametrize("case", VJP_CASES, ids=[c[0] for c in VJP_CASES])
def test_plain_backward_matches_the_reference_vjp(case):
    """The port's plain backward (the twin of the card's kernel) against
    ``jax.vjp`` of the reference's plain attention at the same fp32 inputs:
    dq, dk, dv within 3e-4 of each gradient's largest value."""
    _, s, hq, hkv, d, dv, window = case
    q, k, v, do = _draw(0, s, hq, hkv, d, dv)
    scale = d ** -0.5                  # MLA's scale is the qk head dim's (attention._mla_scale)
    out, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, window=window,
                                                                scale=scale),
                       *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = ref.flash_attention_bwd_ref(*(torch.from_numpy(t) for t in (q, k, v, do)),
                                      window=window, scale=scale)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 3e-4 * np.abs(w).max()


def _hard(case: str, d: int):
    """bf16 causal inputs (S 16, 2 query heads on 1 kv head) at head dim
    ``d``, built as ``test_torch_gpu.bwd_inputs`` builds them at 128:
    ``one_hot`` puts all but ~1e-5 of head 0's row 1 on key 0 (its query is
    key 0 scaled so the score stands ~11 above key 1's, as at 128); in
    ``common_keys`` every key is one shared vector plus 0.1 of noise."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 16, 2, d), dtype=np.float32)
    if case == "one_hot":
        k = rng.standard_normal((1, 16, 1, d), dtype=np.float32)
        q[0, 1, 0] = k[0, 0, 0] * np.sqrt(128 / d)
    else:
        k = rng.standard_normal(d, dtype=np.float32) \
            + 0.1 * rng.standard_normal((1, 16, 1, d), dtype=np.float32)
    v = rng.standard_normal((1, 16, 1, d), dtype=np.float32)
    do = rng.standard_normal((1, 16, 2, d), dtype=np.float32)
    return q, k, v, do


def _late_one_hot(d: int):
    """``one_hot``'s row at position 330 (S 384): its band spans 11 of the
    wide kernel's 32-key tiles (the D 128 kernel would take its Delta from
    O32 there; the wide one takes it from its first sweep)."""
    q, k, v, do = _draw(0, 384, 2, 1, d)
    q[0, 330, 0] = k[0, 7, 0] * np.sqrt(128 / d)
    return q, k, v, do


def _dp_meets_delta(seed: int = 2):
    """MLA's shapes (S 384, one head of 192, v and dO zero past 128) where
    row S-2's dO is orthogonal to v_{S-2} - O_{S-2}, so dP equals Delta
    there up to dO's bf16 rounding, and row S-1's dO is 1 % of the rest:
    key S-2, seen by those two rows alone, gets a dk row that Delta's error
    dominates (what deepseek's dense MLA layer showed at its init)."""
    q, k, v, do = _draw(seed, 384, 1, 1, MLA_QK, MLA_V)
    qb, kb, vb = (torch.from_numpy(t).to(torch.bfloat16).double()[0, :, 0] for t in (q, k, v))
    i = q.shape[1] - 2
    p = torch.softmax((qb[i] @ kb[:i + 1].T) * MLA_QK ** -0.5, -1)
    u = (vb[i] - p @ vb[:i + 1]).numpy()
    g = do[0, i, 0].astype(np.float64)
    do[0, i, 0] = g - (g @ u) / (u @ u) * u
    do[0, -1] *= 1e-2
    return q, k, v, do


# name -> (inputs, window): D 320 and MLA's 192 at the wide tiles
ORDER_INPUTS = {
    "one_hot_320": (lambda: _hard("one_hot", GEMMA3_D), 0),
    "common_keys_320": (lambda: _hard("common_keys", GEMMA3_D), 0),
    "late_one_hot_320": (lambda: _late_one_hot(GEMMA3_D), 0),
    "random_window_320": (lambda: _draw(1, 384, 4, 2, GEMMA3_D), 100),
    "random_mla_192": (lambda: _draw(2, 320, 4, 4, MLA_QK, MLA_V), 0),
    "dp_meets_delta_192": (_dp_meets_delta, 0),
}


def _bf16(*arrays):
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrays)


@pytest.mark.parametrize("name", list(ORDER_INPUTS))
def test_wide_backward_order_within_half_the_rule(name):
    """The bf16 kernel's order at the wide tiles (32-key tiles; Delta = sum_j
    P dP from the first sweep in every block; the keys centred; dS in two
    bf16 halves) keeps dq, dk and dv within half the card's rule of the
    fp32 gradient, the one-hot and common-keys rows included."""
    make, window = ORDER_INPUTS[name]
    q, k, v, do = _bf16(*make())
    want = ref.flash_attention_bwd_ref(q, k, v, do, window=window)
    got = ref.flash_attention_bwd_order_ref(q, k, v, do, window=window)
    assert max(rule_share(g, w) for g, w in zip(got, want)) <= 0.5


# (input, the alternative's flags, gradient (0 dq, 1 dk), its least share)
WIDE_ALTERNATIVES = [
    ("one_hot_320", {"delta": "output", "exact_delta_tiles": 0}, 0, 1.0),
    ("common_keys_320", {"centre": "none", "exact_delta_tiles": 0}, 0, 1.0),
    ("dp_meets_delta_192", {"exact_delta_tiles": 8}, 1, 0.45)]


@pytest.mark.parametrize("name,alt,grad,least", WIDE_ALTERNATIVES)
def test_wide_backward_alternative_orders_lose(name, alt, grad, least):
    """At D 320 as at 128 the usual flash backward's orders miss the rule
    on the hard rows (Delta from the bf16 output on the one-hot row; the
    keys not centred on the common-keys one), so the inputs still test what
    the kernel's order is for; and the D 128 kernel's Delta from O32 past
    256 keys uses three times the kernel's share where dP meets Delta."""
    make, window = ORDER_INPUTS[name]
    q, k, v, do = _bf16(*make())
    want = ref.flash_attention_bwd_ref(q, k, v, do, window=window)
    got = ref.flash_attention_bwd_order_ref(q, k, v, do, window=window, **alt)
    share = rule_share(got[grad], want[grad])
    assert share > least
    kernel = ref.flash_attention_bwd_order_ref(q, k, v, do, window=window)
    assert share > 2 * rule_share(kernel[grad], want[grad])


def _unpadded_grads(q, k, v, do, scale):
    """Autograd of the plain attention with v and dO at their own dv
    columns (what MLA's call computes before the padding)."""
    with torch.enable_grad():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out = ref.flash_attention_ref(qq, kk, vv, scale=scale)
        return torch.autograd.grad(out, (qq, kk, vv), do)


@pytest.mark.parametrize("form", ["plain", "kernel_order"])
def test_mla_padded_call_matches_the_unpadded(form):
    """MLA's call pads v from 128 to 192 and cuts the output at 128, so dO
    is zero past 128: dq and dk equal the unpadded attention's, dv matches
    it on the first 128 columns and is zero past them (``F.pad``'s backward
    drops them).  In fp32, through the twin and the kernel's order."""
    q, k, v, do = (torch.from_numpy(t) for t in _draw(3, 128, 4, 4, MLA_QK, MLA_V))
    scale = MLA_QK ** -0.5
    want = _unpadded_grads(q, k, v[..., :MLA_V], do[..., :MLA_V], scale)
    bwd = ref.flash_attention_bwd_ref if form == "plain" else ref.flash_attention_bwd_order_ref
    dq, dk, dv = bwd(q, k, v, do, scale=scale)
    assert bool((dv[..., MLA_V:] == 0).all())
    for g, w in ((dq, want[0]), (dk, want[1]), (dv[..., :MLA_V], want[2])):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
