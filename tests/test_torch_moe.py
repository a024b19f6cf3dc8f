"""The port's MoE layer (``repro_torch.models.moe``) against the reference's.

Twins of tests/test_moe.py (gate normalisation, capacity semantics, the
aux loss, shared experts, dead padded experts), then parity with the
reference's ``moe_forward`` on the same parameters and inputs: outputs,
the aux loss and the routing itself (expert ids, the dispatch order, each
assignment's slot and ``keep``), at the default capacity factor where
tokens drop, with ``no_drop``, and with ``expert_pad_to``.  Parameters
come from the reference's ``moe_init`` and are transplanted; inputs are
drawn with numpy from a seed.  Tolerances are the reference's own
(rtol/atol 1e-4 on outputs, 1e-5 where padding must preserve the
function); routing must be equal.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402

KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(arch="granite_moe_3b_a800m", **kw):
    return (jreg.get_smoke_config(arch).replace(**kw),
            registry.get_smoke_config(arch).replace(**kw))


def _params(cfg_j):
    """The reference's parameters, and the port's transplant of them."""
    p = jmoe.moe_init(KEY, cfg_j, jnp.float32)
    return p, transplant(jax.tree_util.tree_map(np.asarray, p), device="cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _fwd(p, x, cfg, **kw):
    y, aux = moe.moe_forward(p, torch.from_numpy(x), cfg, **kw)
    return y.numpy(), float(aux)


# -- twins of tests/test_moe.py -------------------------------------------------

def test_moe_output_shape_and_finite():
    cfg_j, cfg = _cfgs()
    _, p = _params(cfg_j)
    x = _x((3, 16, cfg.d_model))
    y, aux = _fwd(p, x, cfg)
    assert y.shape == x.shape and np.isfinite(y).all()
    assert 0.0 < aux < 10.0 * cfg.n_experts


def test_high_capacity_equals_unlimited_dense_dispatch():
    """With cf high enough nothing drops: the dense computation that runs
    every token through its top-k experts directly."""
    cfg_j, cfg = _cfgs(capacity_factor=16.0)
    _, p = _params(cfg_j)
    xt = torch.from_numpy(_x((2, 8, cfg.d_model)))
    y, _ = moe.moe_forward(p, xt, cfg)
    probs = torch.softmax(xt @ p["router"], -1)
    gates, ids = torch.topk(probs, cfg.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    h = torch.nn.functional.silu(torch.einsum("bsd,edf->bsef", xt, p["experts_gate"])) \
        * torch.einsum("bsd,edf->bsef", xt, p["experts_up"])
    dense = torch.einsum("bsef,efd->bsed", h, p["experts_down"])
    picked = torch.gather(dense, 2, ids[..., None].expand(-1, -1, -1, cfg.d_model))
    want = (picked * gates[..., None]).sum(2)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_capacity_drops_tokens_when_overloaded():
    cfg_j, cfg = _cfgs(capacity_factor=0.25)
    _, p = _params(cfg_j)
    x = _x((1, 32, cfg.d_model))
    y_low, _ = _fwd(p, x, cfg)
    y_hi, _ = _fwd(p, x, cfg.replace(capacity_factor=16.0))
    assert np.abs(y_low - y_hi).max() > 1e-6      # drops actually happened


def test_decode_single_token_routing():
    cfg_j, cfg = _cfgs()
    _, p = _params(cfg_j)
    x = _x((4, 1, cfg.d_model))
    y, _ = _fwd(p, x, cfg)
    assert y.shape == x.shape and np.isfinite(y).all()
    # one token a group: capacity k, so none of its k distinct experts drops
    assert np.allclose(y, _fwd(p, x, cfg.replace(capacity_factor=16.0))[0], rtol=1e-6,
                       atol=1e-6)


def test_shared_experts_added():
    cfg_j, cfg = _cfgs("deepseek_v2_lite_16b", capacity_factor=16.0)
    _, p = _params(cfg_j)
    x = _x((2, 8, cfg.d_model))
    y_with, _ = _fwd(p, x, cfg)
    y_without, _ = _fwd(dict(p, shared_down=torch.zeros_like(p["shared_down"])), x, cfg)
    assert np.abs(y_with - y_without).max() > 1e-6


def test_balanced_router_aux_near_one():
    """Uniform router -> aux ~= 1 (E * E * (1/E) * (1/E))."""
    cfg_j, cfg = _cfgs()
    _, p = _params(cfg_j)
    p["router"] = torch.zeros_like(p["router"])
    _, aux = _fwd(p, _x((2, 64, cfg.d_model)), cfg)
    assert 0.5 < aux < 2.0


def test_expert_padding_is_function_preserving():
    """Padded (dead) experts change shapes, never outputs."""
    cfg_j, cfg = _cfgs(capacity_factor=16.0)
    _, p0 = _params(cfg_j)
    x = _x((2, 8, cfg.d_model))
    y0, _ = _fwd(p0, x, cfg)
    cfgp_j, cfgp = cfg_j.replace(expert_pad_to=8), cfg.replace(expert_pad_to=8)
    _, pp = _params(cfgp_j)
    for k in ("experts_gate", "experts_up", "experts_down"):
        pp[k][:cfg.n_experts] = p0[k]
    pp["router"] = p0["router"]
    yp, _ = _fwd(pp, x, cfgp)
    np.testing.assert_allclose(y0, yp, rtol=1e-5, atol=1e-5)


# -- parity with the reference ------------------------------------------------

CASES = {
    # (arch, config overrides, x shape, moe_forward kwargs)
    "drops": ("granite_moe_3b_a800m", {}, (3, 16), {}),
    "overloaded": ("granite_moe_3b_a800m", {"capacity_factor": 0.25}, (2, 32), {}),
    "no_drop": ("granite_moe_3b_a800m", {"capacity_factor": 0.25}, (2, 32),
                {"no_drop": True}),
    "decode": ("granite_moe_3b_a800m", {}, (4, 1), {}),
    "expert_pad_to": ("granite_moe_3b_a800m", {"expert_pad_to": 8}, (2, 24), {}),
    "shared": ("deepseek_v2_lite_16b", {}, (2, 20), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_forward_and_routing_match_reference(case):
    arch, over, shape, kw = CASES[case]
    cfg_j, cfg = _cfgs(arch, **over)
    pj, pt = _params(cfg_j)
    x = _x(shape + (cfg.d_model,), seed=len(case))
    want, aux_j = jmoe.moe_forward(pj, jnp.asarray(x), cfg_j, **kw)
    got, aux_t = _fwd(pt, x, cfg, **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    assert abs(aux_t - float(aux_j)) <= 1e-5 * abs(float(aux_j))

    s = shape[1]
    cap = s * cfg.top_k if kw.get("no_drop") else jmoe.capacity(cfg_j, s)
    assert cap == (s * cfg.top_k if kw.get("no_drop") else moe.capacity(cfg, s))
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), pj["router"])
    bufs_j, route_j, probs_j = jax.vmap(
        lambda xg, lg: jmoe._route_group(xg, lg, cfg_j, cap))(jnp.asarray(x), logits)
    bufs_t, route_t, probs_t = moe._route_group(
        torch.from_numpy(x), moe.router_logits(pt, torch.from_numpy(x)), cfg, cap)
    order, slot, keep, tok_idx, gates = (np.asarray(a) for a in route_j)
    ids_j = np.asarray(jax.lax.top_k(probs_j, cfg.top_k)[1])
    np.testing.assert_array_equal(route_t.ids.numpy(), ids_j)
    for name, want_a in (("order", order), ("slot", slot), ("keep", keep),
                         ("tok_idx", tok_idx)):
        np.testing.assert_array_equal(getattr(route_t, name).numpy(), want_a, err_msg=name)
    np.testing.assert_allclose(route_t.gates.numpy(), gates, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bufs_t.numpy(), np.asarray(bufs_j), rtol=0, atol=0)
    dropped = int((~keep).sum())
    if case == "overloaded":
        assert dropped > 0                        # the case really drops
    if case in ("no_drop", "decode"):
        assert dropped == 0


def test_tied_router_probabilities_pick_the_lower_expert_like_lax_top_k():
    """A uniform router ties every probability: the port's stable sort picks
    experts 0..k-1 for every token, as ``jax.lax.top_k`` does."""
    cfg_j, cfg = _cfgs()
    pj, pt = _params(cfg_j)
    pj = dict(pj, router=jnp.zeros_like(pj["router"]))
    pt = dict(pt, router=torch.zeros_like(pt["router"]))
    x = _x((2, 8, cfg.d_model))
    cap = moe.capacity(cfg, 8)
    _, route_t, _ = moe._route_group(torch.from_numpy(x), moe.router_logits(pt, torch.from_numpy(x)),
                                     cfg, cap)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x), pj["router"]), -1)
    np.testing.assert_array_equal(route_t.ids.numpy(),
                                  np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]))
    want, _ = jmoe.moe_forward(pj, jnp.asarray(x), cfg_j)
    got, _ = _fwd(pt, x, cfg)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_moe_gradients_reach_every_leaf_and_match_reference():
    """jax.grad of the reference's loss (output and aux) against autograd of
    the port's, every leaf at rel 3e-4 (tests/test_kernels.py): the router
    takes its gradient through the gates and the aux's mean probability."""
    cfg_j, cfg = _cfgs("deepseek_v2_lite_16b")
    pj, pt = _params(cfg_j)
    x = _x((2, 12, cfg.d_model))
    w = _x((2, 12, cfg.d_model), seed=5)

    def jloss(p):
        y, aux = jmoe.moe_forward(p, jnp.asarray(x), cfg_j)
        return jnp.sum(y * w) + 0.01 * aux

    want = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(pj))
    leaves = {k: v.clone().requires_grad_() for k, v in pt.items()}
    y, aux = moe.moe_forward(leaves, torch.from_numpy(x), cfg)
    got = dict(zip(leaves, torch.autograd.grad((y * torch.from_numpy(w)).sum() + 0.01 * aux,
                                               list(leaves.values()))))
    for k, g in got.items():
        scale = np.abs(want[k]).max()
        assert scale > 0, k
        assert float(np.abs(g.numpy() - want[k]).max()) <= 3e-4 * scale, k


def test_chip_smoke_routing_replay_routes_as_the_recorded_run():
    """``chip_smoke._routing(replay=...)``, which keeps routing flips out of
    the card's logit gates: the replaying run sends every token to the
    recorded run's experts, gated by its own probabilities there, and
    yields the choices it would have made, which ``_flips`` counts."""
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    cs = importlib.import_module("chip_smoke")
    cfg_j, cfg = _cfgs()
    _, pt = _params(cfg_j)
    x, x2 = (torch.from_numpy(_x((2, 8, cfg.d_model), seed=s)) for s in (1, 2))
    cap = moe.capacity(cfg, 8)
    with cs._routing() as first:
        moe.moe_forward(pt, x, cfg)
    with cs._routing(replay=first) as own:
        _, route, probs = moe._route_group(x2, moe.router_logits(pt, x2), cfg, cap)
    np.testing.assert_array_equal(route.ids.numpy(), first[0].numpy())
    gates = torch.gather(probs, -1, first[0])
    np.testing.assert_allclose(route.gates.numpy(), (gates / gates.sum(-1, keepdim=True)).numpy(),
                               rtol=1e-6)
    mine = moe._top_k(probs, cfg.top_k)[1]
    np.testing.assert_array_equal(own[0].numpy(), mine.numpy())
    differ = int((mine.sort(-1).values != first[0].sort(-1).values).any(-1).sum())
    assert 0 < differ == cs._flips(first, own)
