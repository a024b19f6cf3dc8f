"""The port's MLA attention and the layer-stacked decode variants against
the reference.

deepseek-v2-lite's smoke config (4 heads, kv_lora_rank 32, rope 16, nope
32, v 32).  ``mla_forward``'s plain path, and its kernel path (v zero-
padded to the qk dim, the qk dim's scale passed; on the CPU ``ops`` runs
the twin on those arguments) are held to the reference's non-kernel path
(the reference's own kernel path raises ``TypeError``: ROADMAP.md queue 3);
``mla_decode`` and ``mla_prefill`` (absorbed form, compressed cache) to
the reference's, output and cache; ``gqa_decode_stacked`` /
``mla_decode_stacked`` to the reference's stacked twins, and
``slot_decode_stacked`` through a whole model to ``lm.decode_step``, as
tests/test_archs.py::test_stacked_decode_variant_matches_scan_decode
holds the reference's.  Parameters come from the reference's init and are
transplanted; inputs are drawn with numpy from a seed.  Tolerance: rel <
2e-3 (tests/test_archs.py), and the reference's rtol/atol 2e-3 for the
stacked twin.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import attention, blocks, lm, steps  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402

ARCH = "deepseek_v2_lite_16b"
B, S = 2, 12
REL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def rel_err(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def mla():
    cfg_j = jreg.get_smoke_config(ARCH)
    cfg_t = registry.get_smoke_config(ARCH)
    pj = jattn.mla_init(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    pt = transplant(_np(pj), device="cpu")
    x = np.random.default_rng(0).standard_normal((B, S, cfg_t.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return cfg_j, pj, cfg_t, pt, x, pos


@pytest.mark.parametrize("use_kernels", [False, True])
def test_mla_forward_matches_reference_plain_path(mla, use_kernels):
    cfg_j, pj, cfg_t, pt, x, pos = mla
    want, cache_j = jattn.mla_forward(pj, jnp.asarray(x), jnp.asarray(pos), cfg_j,
                                      return_cache=True)
    got, cache_t = attention.mla_forward(pt, torch.from_numpy(x), torch.from_numpy(pos),
                                         cfg_t.replace(use_kernels=use_kernels),
                                         return_cache=True)
    assert got.shape == (B, S, cfg_t.d_model)
    assert rel_err(got, want) < REL
    assert cache_t.keys() == cache_j.keys()
    for k in cache_t:
        assert tuple(cache_t[k].shape) == cache_j[k].shape and rel_err(cache_t[k],
                                                                       cache_j[k]) < REL, k


def test_mla_kernel_path_pads_v_and_passes_the_qk_scale(mla, monkeypatch):
    """The kernel path hands ``ops.flash_attention`` v padded with zeros to
    the qk dim (dn + dr) and ``scale = (dn + dr)^-0.5``; the plain path v
    at its own width and no scale."""
    from repro_torch.kernels import ops
    cfg_j, pj, cfg_t, pt, x, pos = mla
    seen, real = [], ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], v.shape[-1], kw.get("scale"), kw["use_kernel"],
                     bool((v[..., cfg_t.v_head_dim:] == 0).all())))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    for use in (True, False):
        attention.mla_forward(pt, torch.from_numpy(x), torch.from_numpy(pos),
                              cfg_t.replace(use_kernels=use))
    dqk = cfg_t.qk_nope_dim + cfg_t.qk_rope_dim
    assert seen == [(dqk, dqk, dqk ** -0.5, True, True),
                    (dqk, cfg_t.v_head_dim, None, False, True)]


def test_mla_decode_matches_reference(mla):
    """Prefill S-1 rows into a cache of S + 3, decode the last token."""
    cfg_j, pj, cfg_t, pt, x, pos = mla
    _, cache_j = jattn.mla_forward(pj, jnp.asarray(x[:, :-1]), jnp.asarray(pos[:, :-1]),
                                   cfg_j, return_cache=True)
    cache_j = {k: jnp.pad(v, ((0, 0), (0, 4), (0, 0))) for k, v in cache_j.items()}
    cache_t = {k: torch.from_numpy(np.array(v)) for k, v in cache_j.items()}
    p_last = np.full((B,), S - 1, np.int32)
    want, new_j = jattn.mla_decode(pj, jnp.asarray(x[:, -1:]), cache_j, jnp.asarray(p_last),
                                   cfg_j)
    got, new_t = attention.mla_decode(pt, torch.from_numpy(x[:, -1:]), cache_t,
                                      torch.from_numpy(p_last), cfg_t)
    assert new_t is cache_t                   # written in place
    assert rel_err(got, want) < REL
    for k in new_t:
        assert rel_err(new_t[k], new_j[k]) < REL, k
    # the decode step equals the full forward's last position
    full = attention.mla_forward(pt, torch.from_numpy(x), torch.from_numpy(pos), cfg_t)
    assert rel_err(got[:, 0], full[:, -1]) < REL


@pytest.mark.parametrize("chunk", [4, S])
def test_mla_prefill_matches_reference(mla, chunk):
    cfg_j, pj, cfg_t, pt, x, pos = mla
    shape = attention.mla_cache_shape(cfg_t, B, S + 4)
    assert shape == jattn.mla_cache_shape(cfg_j, B, S + 4)
    cache_j = {k: jnp.zeros(v, jnp.float32) for k, v in shape.items()}
    cache_t = {k: torch.zeros(v) for k, v in shape.items()}
    outs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        want, cache_j = jattn.mla_prefill(pj, jnp.asarray(x[:, sl]), cache_j,
                                          jnp.asarray(pos[:, sl]), cfg_j)
        got, cache_t = attention.mla_prefill(pt, torch.from_numpy(x[:, sl]), cache_t,
                                             torch.from_numpy(pos[:, sl].copy()), cfg_t)
        assert rel_err(got, want) < REL, c0
        outs.append(got)
    for k in cache_t:
        assert rel_err(cache_t[k], cache_j[k]) < REL, k
    full = attention.mla_forward(pt, torch.from_numpy(x), torch.from_numpy(pos), cfg_t)
    assert rel_err(torch.cat(outs, 1), full) < REL


def test_mla_scores_stay_fp32_from_bf16_operands(mla):
    """bf16 operands, fp32 scores: the port's absorbed decode equals the
    reference's (``preferred_element_type=f32``) at the bf16 tolerance,
    and the cache follows the compute dtype."""
    cfg_j, pj, cfg_t, pt, x, pos = mla
    cfg_jb, cfg_tb = cfg_j.replace(dtype="bfloat16"), cfg_t.replace(dtype="bfloat16")
    pjb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), pj)
    ptb = {k: v.to(torch.bfloat16) for k, v in pt.items()}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    cache_j = {k: jnp.zeros(v, jnp.bfloat16)
               for k, v in jattn.mla_cache_shape(cfg_j, B, S).items()}
    want, _ = jattn.mla_prefill(pjb, xb, cache_j, jnp.asarray(pos), cfg_jb)
    cache_t = {k: v[0] for k, v in lm.init_cache(cfg_tb, B, S, device="cpu")["phase1"]
               ["slot0"].items()}
    assert {v.dtype for v in cache_t.values()} == {torch.bfloat16}
    got, _ = attention.mla_prefill(ptb, torch.from_numpy(np.array(xb.astype(jnp.float32)))
                                   .to(torch.bfloat16), cache_t, torch.from_numpy(pos), cfg_tb)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) < 2e-2


@pytest.mark.parametrize("kind", ["mla", "global"])
def test_decode_stacked_matches_reference(kind):
    """``mla_decode_stacked`` (deepseek) and ``gqa_decode_stacked`` (granite)
    write group g of the stacked cache in place and return what the
    reference's stacked twins return."""
    arch = ARCH if kind == "mla" else "granite_3_8b"
    cfg_j, cfg_t = jreg.get_smoke_config(arch), registry.get_smoke_config(arch)
    init = jattn.mla_init if kind == "mla" else jattn.gqa_init
    pj = init(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    pt = transplant(_np(pj), device="cpu")
    rng = np.random.default_rng(3)
    shape = blocks.slot_cache_shape(cfg_t, kind, B, S)
    stacked = {k: rng.standard_normal((3,) + v, dtype=np.float32) for k, v in shape.items()}
    x = rng.standard_normal((B, 1, cfg_t.d_model), dtype=np.float32)
    p = np.array([5, 9], np.int32)
    fn_j = jattn.mla_decode_stacked if kind == "mla" else jattn.gqa_decode_stacked
    fn_t = attention.mla_decode_stacked if kind == "mla" else attention.gqa_decode_stacked
    st_j = {k: jnp.asarray(v) for k, v in stacked.items()}
    st_t = {k: torch.from_numpy(v.copy()) for k, v in stacked.items()}
    want, new_j = fn_j(pj, jnp.asarray(x), st_j, 1, jnp.asarray(p), cfg_j)
    got, new_t = fn_t(pt, torch.from_numpy(x), st_t, 1, torch.from_numpy(p), cfg_t)
    assert new_t is st_t
    assert rel_err(got, want) < REL
    for k in st_t:
        assert rel_err(new_t[k], new_j[k]) < REL, k
        np.testing.assert_array_equal(new_t[k][[0, 2]].numpy(), stacked[k][[0, 2]])


@pytest.mark.parametrize("arch", ["h2o_danube_3_4b", ARCH])
def test_stacked_decode_variant_matches_scan_decode(arch):
    """``slot_decode_stacked`` through the whole model, group by group on
    the stacked cache, gives ``lm.decode_step``'s logits (rtol/atol 2e-3,
    the reference's test), and so does the reference's stacked variant."""
    cfg_j, cfg_t = jreg.get_smoke_config(arch), registry.get_smoke_config(arch)
    pj = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = transplant(_np(pj), device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg_t.vocab_size, (B, 16), dtype=np.int32)
    _, cache_t = steps.prefill(pt, {"tokens": torch.from_numpy(toks)}, cfg=cfg_t,
                               cache_len=20)
    _, cache_j = jsteps.prefill(pj, {"tokens": jnp.asarray(toks)}, cfg=cfg_j, cache_len=20)
    tok, pos = toks[:, :1], np.full((B,), 16, np.int32)
    stacked_cache = {k: {s: {n: t.clone() for n, t in c.items()} for s, c in pc.items()}
                     for k, pc in cache_t.items()}
    want, _ = lm.decode_step(pt, cfg_t, torch.from_numpy(tok), torch.from_numpy(pos), cache_t)
    x = lm._embed(pt, cfg_t, torch.from_numpy(tok))
    for pi, phase in enumerate(blocks.build_plan(cfg_t)):
        for g in range(phase.n_groups):
            gp = lm._at(pt[f"phase{pi}"], g)
            for j, (kind, ffn) in enumerate(zip(phase.kinds, phase.ffns)):
                x, _ = blocks.slot_decode_stacked(gp[f"slot{j}"], x,
                                                  stacked_cache[f"phase{pi}"][f"slot{j}"], g,
                                                  torch.from_numpy(pos), cfg_t, kind, ffn)
    got = lm._head(pt, cfg_t, x[:, 0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)
    for k, pc in cache_t.items():
        for s, c in pc.items():
            for n, t in c.items():
                np.testing.assert_allclose(stacked_cache[k][s][n].numpy(), t.numpy(),
                                           rtol=2e-3, atol=2e-3)
    want_j, _ = jlm.decode_step(pj, cfg_j, jnp.asarray(tok), jnp.asarray(pos), cache_j)
    assert rel_err(got, want_j) < REL
