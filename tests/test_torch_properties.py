"""Hypothesis property tests on the port's invariants: twins of the
properties of tests/test_properties.py whose code the port holds (RoPE,
``softmax_xent``, attention's causality and sliding window, decode
attention's ``cache_len``, ``tree_hash``, the Katib space round trip, MoE
capacity, the sinusoid positions and ``fit_pspec``'s divisibility), and
M-RoPE on equal streams being RoPE.
Inputs are drawn with
numpy from seeds the strategies give; tolerances are the reference's.
The reference's tensors and tree leaves are numpy here; torch tensors and
their trees are hashed alike.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="dev dep: pip install -r requirements-dev.txt")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.checkpoint.store import tree_hash  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.attention import apply_mrope, apply_rope  # noqa: E402
from repro_torch.models import sharding as msh  # noqa: E402
from repro_torch.models.lm import sinusoid  # noqa: E402
from repro_torch.models.steps import softmax_xent  # noqa: E402
from repro_torch.tuning import katib  # noqa: E402


MESH = msh.abstract_mesh((4, 2), ("data", "model"))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 97), min_size=1, max_size=4),
       st.integers(0, 3))
def test_fit_pspec_always_divisible(dims, which):
    """Twin of tests/test_properties.py::test_fit_pspec_always_divisible:
    fit_pspec's output is always a legal argument sharding."""
    shape = tuple(dims)
    spec_entries = [None] * len(shape)
    spec_entries[min(which, len(shape) - 1)] = "model"
    fitted = msh.fit_pspec(shape, msh.P(*spec_entries), MESH)
    for dim, entry in zip(shape, tuple(fitted) + (None,) * len(shape)):
        if entry is not None:
            assert dim % msh.axis_size(MESH, entry) == 0


def _normal(seed: int, *shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape,
                                                                        dtype=np.float32))


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 64), st.integers(1, 1000))
def test_rope_preserves_norm(d2, pos):
    """RoPE is a rotation: vector norms are invariant."""
    x = _normal(d2, 1, 1, 1, d2 * 2)
    y = apply_rope(x, torch.full((1, 1), pos, dtype=torch.int32), 10000.0)
    np.testing.assert_allclose(float(torch.linalg.norm(y)), float(torch.linalg.norm(x)),
                               rtol=1e-4)


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 6), st.integers(3, 20), st.integers(5, 50))
def test_softmax_xent_matches_manual(b, s, v):
    logits = _normal(b * 100 + s, b, s, v)
    labels = torch.from_numpy(np.random.default_rng(1).integers(0, v, (b, s)))
    got = float(softmax_xent(logits, labels))
    logp = torch.log_softmax(logits, -1)
    want = float(-torch.gather(logp, -1, labels[..., None]).mean())
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_softmax_xent_ignores_masked_labels():
    logits = _normal(0, 2, 8, 11)
    labels = torch.full((2, 8), -1, dtype=torch.int32)
    labels[:, 0] = 3
    loss = softmax_xent(logits, labels)
    only = softmax_xent(logits[:, :1], labels[:, :1])
    np.testing.assert_allclose(float(loss), float(only), rtol=1e-6)


@settings(max_examples=10, deadline=None)
@given(st.integers(4, 24))
def test_attention_causality(s):
    """Output at position t must not depend on tokens after t."""
    q, k, v = (_normal(s * 3 + i, 1, s, 2, 16) for i in range(3))
    base = ref.flash_attention_ref(q, k, v, causal=True)
    t = s // 2
    k2, v2 = k.clone(), v.clone()
    k2[:, t + 1:] = 999.0
    v2[:, t + 1:] = -999.0
    pert = ref.flash_attention_ref(q, k2, v2, causal=True)
    np.testing.assert_allclose(base[:, :t + 1].numpy(), pert[:, :t + 1].numpy(), atol=1e-5)


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 8), st.integers(1, 32))
def test_sliding_window_masks_old_tokens(w, extra):
    s = w + extra
    q, k, v = (_normal(s * 7 + w + i, 1, s, 1, 8) for i in range(3))
    base = ref.flash_attention_ref(q, k, v, causal=True, window=w)
    # corrupt tokens older than the window of the last position
    cutoff = s - w
    k2, v2 = k.clone(), v.clone()
    k2[:, :cutoff] = 123.0
    v2[:, :cutoff] = -123.0
    pert = ref.flash_attention_ref(q, k2, v2, causal=True, window=w)
    np.testing.assert_allclose(base[:, -1].numpy(), pert[:, -1].numpy(), atol=1e-5)


def test_tree_hash_detects_changes_and_is_stable():
    t1 = {"a": np.arange(10.0), "b": {"c": np.ones((3, 3))}}
    t2 = {"a": np.arange(10.0), "b": {"c": np.ones((3, 3))}}
    assert tree_hash(t1) == tree_hash(t2)
    t2["b"]["c"][0, 0] = 2.0
    assert tree_hash(t1) != tree_hash(t2)
    # a tree of tensors hashes as its numpy twin
    tt = {"a": torch.arange(10.0, dtype=torch.float64),
          "b": {"c": torch.ones((3, 3), dtype=torch.float64)}}
    assert tree_hash(tt) == tree_hash(t1)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 64), st.integers(1, 16))
def test_decode_attention_respects_cache_len(s, valid):
    valid = min(valid, s)
    q = _normal(s + valid, 1, 2, 8)
    kc, vc = (_normal(s + valid + i, 1, s, 2, 8) for i in (1, 2))
    lens = torch.tensor([valid], dtype=torch.int32)
    base = ref.decode_attention_ref(q, kc, vc, lens)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, valid:] = 555.0
    vc2[:, valid:] = -555.0
    pert = ref.decode_attention_ref(q, kc2, vc2, lens)
    np.testing.assert_allclose(base.numpy(), pert.numpy(), atol=1e-5)


@settings(max_examples=25, deadline=None)
@given(st.floats(0.0, 1.0), st.floats(0.0, 1.0), st.integers(0, 2))
def test_katib_space_roundtrip(u1, u2, cat):
    """_from_unit/_to_unit are inverses over the search space."""
    space = {"lr": katib.Double(1e-5, 1e-1, log=True),
             "w": katib.Double(-2.0, 3.0),
             "act": katib.Categorical(("a", "b", "c"))}
    params = katib._from_unit(space, np.array([u1, u2, cat / 2.0]))
    back = katib._to_unit(space, params)
    again = katib._from_unit(space, back)
    assert abs(again["lr"] - params["lr"]) / params["lr"] < 1e-6
    assert abs(again["w"] - params["w"]) < 1e-6
    assert again["act"] == params["act"]


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 4096), st.floats(0.5, 4.0))
def test_moe_capacity_monotone_and_sufficient(tokens, cf):
    """Capacity covers at least top_k slots and grows with tokens/cf."""
    cfg = registry.get_config("granite_moe_3b_a800m").replace(capacity_factor=cf)
    c = moe.capacity(cfg, tokens)
    assert c >= cfg.top_k
    assert c >= int(cf * tokens * cfg.top_k / cfg.n_experts)
    assert moe.capacity(cfg, tokens + 1) >= c
    assert moe.capacity(cfg.replace(capacity_factor=cf * 2), tokens) >= c


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 128), st.integers(1, 8))
def test_sinusoid_positions_distinct(d2, stride):
    """Distinct positions produce distinct positional encodings."""
    enc = sinusoid(torch.tensor([[0, stride]], dtype=torch.int32), d2 * 2)
    assert float((enc[0, 0] - enc[0, 1]).abs().max()) > 1e-6


@settings(max_examples=20, deadline=None)
@given(st.integers(3, 64), st.integers(0, 5000))
def test_mrope_on_equal_streams_is_rope(d2, pos):
    """With the three streams equal, every section rotates by the one
    position: M-RoPE is RoPE (which is why the parity tests use distinct
    streams)."""
    x = _normal(d2, 1, 2, 2, d2 * 2)
    p = torch.full((1, 2), pos, dtype=torch.int32)
    torch.testing.assert_close(apply_mrope(x, p[:, None].expand(1, 3, 2), 1e6),
                               apply_rope(x, p, 1e6), rtol=0, atol=0)
