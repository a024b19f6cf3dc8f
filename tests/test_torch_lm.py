"""Whole-slice parity of the PyTorch port with the JAX reference.

For each ported arch the reference builds the smoke parameters
(``lm.init_params(PRNGKey(0), cfg)``); ``transplant`` loads them into the
port.  Both packages then run the same token ids, drawn with numpy from a
seed: the reference with ``use_kernels=True`` (Pallas in interpret mode:
attention, decode attention, and zamba2's SSD scan and xlstm's mLSTM scan
where its model code dispatches them), the port on its plain CPU path.
Tolerance: rel < 2e-3 (tests/test_archs.py:66-67), generated tokens
identical.  zamba2's smoke window is 16 rows, so its shared attention block
runs the ring branches whenever a test's cache is 16 rows or fewer, and
the global ones above that.  h2o_danube's layers are all ``local`` (smoke
window 16): every cache of it is a ring of at most 16 rows, which the
decode tests wrap.  gemma3's smoke plan is one ``(local, global)`` group:
a 16-row ring beside a padded global cache, with tied, scaled embeddings.
granite_moe and deepseek_v2_lite route through MoE ffns (capacity drops in
the forward and decode, ``no_drop`` in chunked prefill), whose aux loss
joins the forward's output; deepseek's attention is MLA, and the
reference runs it without kernels (its MLA kernel path passes ``scale=``
to an ``ops.flash_attention`` that takes none and raises ``TypeError``).
whisper_base runs its encoder over frames drawn from the seed and
cross-attends them (chunked prefill raises for audio on both sides);
qwen2_vl_7b takes vision rows drawn from the seed and M-RoPE positions on
three distinct streams, the temporal one the sequence index (the cache
index of both packages' decode).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import lm, steps  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402

ARCHS = ["granite_3_8b", "zamba2_1_2b", "xlstm_1_3b", "h2o_danube_3_4b", "minitron_4b",
         "gemma3_4b", "granite_moe_3b_a800m", "deepseek_v2_lite_16b", "whisper_base",
         "qwen2_vl_7b"]
# the reference's kernel path is broken for MLA (ROADMAP.md queue 3)
NO_REFERENCE_KERNELS = ("deepseek_v2_lite_16b",)
B, S, GEN = 2, 12, 4
REL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size models: one intra-op thread runs them about as fast as
    many, and under a multi-process test run it keeps them from waiting on
    threads the other workers hold."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def rel_err(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _mrope(s0: int, s1: int) -> np.ndarray:
    """(B,3,s1-s0) M-RoPE positions: t the sequence index, h and w apart."""
    i = np.arange(s0, s1)
    pos = np.stack([i, i // 3 + 1, (i * 7) % 5 + 2])
    return np.broadcast_to(pos[None], (B, 3, s1 - s0)).astype(np.int32).copy()


def _stubs(cfg, s: int) -> dict:
    """The family's inputs beside s tokens, drawn with numpy from a seed:
    audio frames; a VLM's vision rows and M-RoPE positions."""
    rng = np.random.default_rng(100)
    out = {}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((B, cfg.encoder_len, cfg.d_model), dtype=np.float32)
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(0, 0.02, (B, min(cfg.n_vision_tokens, s),
                                                    cfg.d_model)).astype(np.float32)
    if cfg.use_mrope:
        out["mrope_positions"] = _mrope(0, s)
    return out


def _jbatch(cfg, tokens, **extra) -> dict:
    return {k: jnp.asarray(v) for k, v in {"tokens": tokens, **_stubs(cfg, tokens.shape[1]),
                                           **extra}.items()}


def _tbatch(cfg, tokens, **extra) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in {"tokens": tokens, **_stubs(cfg, tokens.shape[1]), **extra}.items()}


def _pos(cfg, t: int) -> np.ndarray:
    """Decode positions of the token at t: (B,), or (B,3) under M-RoPE."""
    return _mrope(t, t + 1)[:, :, 0] if cfg.use_mrope else np.full((B,), t, np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg_j = jreg.get_smoke_config(request.param).replace(
        use_kernels=request.param not in NO_REFERENCE_KERNELS)
    cfg_t = registry.get_smoke_config(request.param)
    params_j = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = transplant(jax.tree_util.tree_map(np.asarray, params_j), device="cpu",
                          dtype=cfg_t.compute_dtype)
    tokens = np.random.default_rng(0).integers(0, cfg_t.vocab_size, (B, S), dtype=np.int32)
    return cfg_j, params_j, cfg_t, params_t, tokens


def test_transplant_keeps_paths_and_layouts(models):
    _, params_j, cfg_t, params_t, _ = models
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, params_j)))
    got = dict(_leaves(params_t))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
    n_groups = cfg_t.n_layers // (cfg_t.shared_attn_every or cfg_t.slstm_every or 1)
    if cfg_t.family == "dense":
        # one group per repeat of the block pattern (gemma3: (local, global))
        assert got["phase0/slot0/mixer/wq"].shape == (
            cfg_t.n_layers // len(cfg_t.block_pattern), cfg_t.d_model, cfg_t.n_heads,
            cfg_t.head_dim)
        # SwiGLU's gate where the arch has one (minitron's squared ReLU has
        # none), and an untied head where the arch has one (gemma3's head is
        # its embedding table)
        assert ("phase0/slot0/ffn/w_gate" in got) == (cfg_t.mlp_act == "swiglu")
        if cfg_t.tie_embeddings:
            assert "lm_head" not in got
        else:
            assert got["lm_head"].shape == (cfg_t.d_model, cfg_t.vocab_size)
    elif cfg_t.family == "moe":
        # deepseek: a dense layer 0 in a phase of its own, then the MoE
        # layers; the router (d, E) and the stacked experts (E, d, f)
        moe_phase = "phase1" if cfg_t.first_layer_dense else "phase0"
        n_moe = cfg_t.n_layers - int(cfg_t.first_layer_dense)
        e, d, f = cfg_t.n_experts, cfg_t.d_model, cfg_t.moe_d_ff
        assert got[f"{moe_phase}/slot0/ffn/router"].shape == (n_moe, d, e)
        assert got[f"{moe_phase}/slot0/ffn/experts_gate"].shape == (n_moe, e, d, f)
        assert got[f"{moe_phase}/slot0/ffn/experts_down"].shape == (n_moe, e, f, d)
        assert (f"{moe_phase}/slot0/ffn/shared_up" in got) == bool(cfg_t.n_shared_experts)
        if cfg_t.first_layer_dense:
            assert got["phase0/slot0/ffn/w_up"].shape == (1, d, cfg_t.d_ff)
        if cfg_t.use_mla:
            r, hq = cfg_t.kv_lora_rank, cfg_t.n_heads
            assert got[f"{moe_phase}/slot0/mixer/w_dkv"].shape == (n_moe, d,
                                                                 r + cfg_t.qk_rope_dim)
            assert got[f"{moe_phase}/slot0/mixer/w_uv"].shape == (n_moe, r, hq,
                                                                cfg_t.v_head_dim)
        else:
            assert got[f"{moe_phase}/slot0/mixer/wk"].shape == (n_moe, d, cfg_t.n_kv_heads,
                                                              cfg_t.head_dim)
    elif cfg_t.family == "hybrid":
        assert got["shared/mixer/wq"].shape == (cfg_t.d_model, cfg_t.n_heads, cfg_t.head_dim)
        assert got["phase0/slot0/mixer/conv_w"].shape == (
            n_groups, cfg_t.ssm_conv, cfg_t.d_inner + 2 * cfg_t.ssm_state)
    elif cfg_t.family == "audio":
        # the decoder's cross sub-layer and the stacked encoder
        assert got["phase0/slot0/cross/wq"].shape == (cfg_t.n_layers, cfg_t.d_model,
                                                      cfg_t.n_heads, cfg_t.head_dim)
        assert got["encoder/norm2"].shape == (cfg_t.encoder_layers, cfg_t.d_model)
    elif cfg_t.family == "vlm":
        assert got["phase0/slot0/mixer/wk"].shape == (cfg_t.n_layers, cfg_t.d_model,
                                                      cfg_t.n_kv_heads, cfg_t.head_dim)
    else:
        hd = cfg_t.d_model // cfg_t.n_heads
        assert got[f"phase0/slot{cfg_t.slstm_every - 1}/mixer/r_i"].shape == (
            n_groups, cfg_t.n_heads, hd, hd)


def test_forward_logits_match_reference(models):
    cfg_j, params_j, cfg_t, params_t, tokens = models
    want, aux_j, _ = jlm.forward(params_j, cfg_j, _jbatch(cfg_t, tokens))
    got, aux, _ = lm.forward(params_t, cfg_t, _tbatch(cfg_t, tokens))
    assert got.shape == (B, S, cfg_t.vocab_size) and aux.dtype == torch.float32
    assert rel_err(got, want) < REL
    # the MoE aux loss summed over the MoE slots; zero without one
    assert (float(aux) > 0) == bool(cfg_t.n_experts)
    assert abs(float(aux) - float(aux_j)) <= REL * abs(float(aux_j))


def test_prefill_and_greedy_decode_match_reference(models):
    cfg_j, params_j, cfg_t, params_t, tokens = models
    cache_len = S + GEN + 1
    last_j, cache_j = jsteps.prefill(params_j, _jbatch(cfg_t, tokens), cfg=cfg_j,
                                     cache_len=cache_len)
    last_t, cache_t = steps.prefill(params_t, _tbatch(cfg_t, tokens), cfg=cfg_t,
                                    cache_len=cache_len)
    assert rel_err(last_t, last_j) < REL
    for path, leaf in _leaves(cache_t):
        assert rel_err(leaf, dict(_leaves(cache_j))[path]) < REL, path
    first_j = jnp.argmax(last_j, -1).astype(jnp.int32)[:, None]
    first_t = torch.argmax(last_t, -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(first_t.numpy(), np.asarray(first_j))
    toks_j, cache_j = jsteps.greedy_decode_loop(params_j, cache_j, first_j,
                                                jnp.asarray(_pos(cfg_t, S)), GEN, cfg=cfg_j)
    toks_t, cache_t = steps.greedy_decode_loop(params_t, cache_t, first_t,
                                               torch.from_numpy(_pos(cfg_t, S)), GEN,
                                               cfg=cfg_t)
    assert toks_t.shape == (B, GEN)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    want = dict(_leaves(cache_j))
    for path, leaf in _leaves(cache_t):
        assert rel_err(leaf, want[path]) < REL, path


def test_decode_step_matches_reference_and_forward(models):
    """Prefill S-1 tokens, decode the last: the logits match the reference's
    decode_step and the port's own full forward (the MoE archs at a
    capacity factor where nothing drops: a full forward routes the last
    token in a group of S, decode alone, so drops differ between the two,
    as the reference's ``tests/test_archs.py`` notes)."""
    cfg_j, params_j, cfg_t, params_t, tokens = models
    pos = _pos(cfg_t, S - 1)
    _, cache_j = jsteps.prefill(params_j, _jbatch(cfg_t, tokens[:, :-1]),
                                cfg=cfg_j, cache_len=S + 4)
    want, _ = jlm.decode_step(params_j, cfg_j, jnp.asarray(tokens[:, -1:]),
                              jnp.asarray(pos), cache_j)
    _, cache_t = steps.prefill(params_t, _tbatch(cfg_t, tokens[:, :-1]),
                               cfg=cfg_t, cache_len=S + 4)
    got, _ = lm.decode_step(params_t, cfg_t, torch.from_numpy(tokens[:, -1:]),
                            torch.from_numpy(pos), cache_t)
    assert rel_err(got, want) < REL
    if cfg_t.n_experts:
        cfg_t = cfg_t.replace(capacity_factor=8.0)
        _, cache_t = steps.prefill(params_t, _tbatch(cfg_t, tokens[:, :-1]),
                                   cfg=cfg_t, cache_len=S + 4)
        got, _ = lm.decode_step(params_t, cfg_t, torch.from_numpy(tokens[:, -1:]),
                                torch.from_numpy(pos), cache_t)
    full, _, _ = lm.forward(params_t, cfg_t, _tbatch(cfg_t, tokens))
    assert rel_err(got, full[:, -1]) < REL


@pytest.mark.parametrize("chunk", [4, S])
def test_prefill_chunk_matches_reference(models, chunk):
    """(audio: both packages refuse chunked prefill.)"""
    cfg_j, params_j, cfg_t, params_t, tokens = models
    cache_j = jlm.init_cache(cfg_j, B, S + 4)
    cache_t = lm.init_cache(cfg_t, B, S + 4, device="cpu")
    if cfg_t.family == "audio":
        pos = np.broadcast_to(np.arange(chunk, dtype=np.int32), (B, chunk))
        with pytest.raises(NotImplementedError, match="audio"):
            jlm.prefill_chunk(params_j, cfg_j, jnp.asarray(tokens[:, :chunk]), jnp.asarray(pos),
                              cache_j)
        with pytest.raises(NotImplementedError, match="audio"):
            lm.prefill_chunk(params_t, cfg_t, torch.from_numpy(tokens[:, :chunk]),
                             torch.from_numpy(pos.copy()), cache_t)
        return
    for c0 in range(0, S, chunk):
        pos = _mrope(c0, c0 + chunk) if cfg_t.use_mrope else \
            np.broadcast_to(np.arange(c0, c0 + chunk, dtype=np.int32), (B, chunk))
        want, cache_j = jlm.prefill_chunk(params_j, cfg_j, jnp.asarray(tokens[:, c0:c0 + chunk]),
                                          jnp.asarray(pos), cache_j)
        got, cache_t = lm.prefill_chunk(params_t, cfg_t,
                                        torch.from_numpy(tokens[:, c0:c0 + chunk]),
                                        torch.from_numpy(pos.copy()), cache_t)
        assert rel_err(got, want) < REL, c0
    want = dict(_leaves(cache_j))
    for path, leaf in _leaves(cache_t):
        assert rel_err(leaf, want[path]) < REL, path


def test_loss_fn_matches_reference(models):
    """The scoring forward (no cache; xlstm's route to the mLSTM scan)."""
    cfg_j, params_j, cfg_t, params_t, tokens = models
    labels = np.where(np.arange(S)[None] % 5 == 4, -1, tokens)      # some masked labels
    want, mj = jsteps.loss_fn(params_j, cfg_j, _jbatch(cfg_t, tokens, labels=labels))
    got, mt = steps.loss_fn(params_t, cfg_t, _tbatch(cfg_t, tokens, labels=labels))
    assert abs(float(got) - float(want)) < REL * abs(float(want))
    assert abs(float(mt["ce"]) - float(mj["ce"])) < REL * abs(float(mj["ce"]))


def test_zamba2_ring_cache_wraps_like_reference():
    """A shared-block cache of 16 rows (the smoke window) with 28 positions
    through it: chunked prefill and decode wrap the ring exactly as the
    reference does."""
    cfg_j = jreg.get_smoke_config("zamba2_1_2b").replace(use_kernels=True)
    cfg_t = registry.get_smoke_config("zamba2_1_2b")
    params_j = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = transplant(jax.tree_util.tree_map(np.asarray, params_j), device="cpu")
    size, prompt, chunk = cfg_t.sliding_window, 24, 8
    tokens = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (B, prompt + 4),
                                               dtype=np.int32)
    cache_j = jlm.init_cache(cfg_j, B, size)
    cache_t = lm.init_cache(cfg_t, B, size, device="cpu")
    assert cache_t["phase0"]["shared"]["k"].shape[2] == size
    for c0 in range(0, prompt, chunk):
        pos = np.broadcast_to(np.arange(c0, c0 + chunk, dtype=np.int32), (B, chunk))
        want, cache_j = jlm.prefill_chunk(params_j, cfg_j, jnp.asarray(tokens[:, c0:c0 + chunk]),
                                          jnp.asarray(pos), cache_j)
        got, cache_t = lm.prefill_chunk(params_t, cfg_t,
                                        torch.from_numpy(tokens[:, c0:c0 + chunk]),
                                        torch.from_numpy(pos.copy()), cache_t)
        assert rel_err(got, want) < REL, c0
    for t in range(prompt, prompt + 4):
        pos = np.full((B,), t, np.int32)
        want, cache_j = jlm.decode_step(params_j, cfg_j, jnp.asarray(tokens[:, t:t + 1]),
                                        jnp.asarray(pos), cache_j)
        got, cache_t = lm.decode_step(params_t, cfg_t, torch.from_numpy(tokens[:, t:t + 1]),
                                      torch.from_numpy(pos), cache_t)
        assert rel_err(got, want) < REL, t
    want = dict(_leaves(cache_j))
    for path, leaf in _leaves(cache_t):
        assert rel_err(leaf, want[path]) < REL, path


def test_zamba2_windowed_shared_block_prefill_names_its_item():
    """A decode budget over 64k windows the shared block (the reference's
    ``_shared_window``).  Its prefill used to raise, naming ROADMAP item
    1.2; it now places its rows in a ring of the window's size as the
    reference does, and prefill, cache and the decode steps that follow
    (the ring wraps) match the reference."""
    cfg_j = jreg.get_smoke_config("zamba2_1_2b").replace(use_kernels=True)
    cfg_t = registry.get_smoke_config("zamba2_1_2b")
    params_j = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = transplant(jax.tree_util.tree_map(np.asarray, params_j), device="cpu")
    cache_len, prompt = 65537, 20
    tokens = np.random.default_rng(2).integers(0, cfg_t.vocab_size, (B, prompt + 3),
                                               dtype=np.int32)
    last_j, cache_j = jsteps.prefill(params_j, {"tokens": jnp.asarray(tokens[:, :prompt])},
                                     cfg=cfg_j, cache_len=cache_len)
    last_t, cache_t = steps.prefill(params_t, {"tokens": torch.from_numpy(tokens[:, :prompt])},
                                    cfg=cfg_t, cache_len=cache_len)
    assert rel_err(last_t, last_j) < REL
    assert cache_t["phase0"]["shared"]["k"].shape[2] == cfg_t.sliding_window
    _assert_caches_match(cache_t, cache_j)
    for t in range(prompt, prompt + 3):
        pos = np.full((B,), t, np.int32)
        want, cache_j = jlm.decode_step(params_j, cfg_j, jnp.asarray(tokens[:, t:t + 1]),
                                        jnp.asarray(pos), cache_j)
        got, cache_t = lm.decode_step(params_t, cfg_t, torch.from_numpy(tokens[:, t:t + 1]),
                                      torch.from_numpy(pos), cache_t)
        assert rel_err(got, want) < REL, t
    _assert_caches_match(cache_t, cache_j)


def _assert_caches_match(cache_t, cache_j):
    want = dict(_leaves(cache_j))
    got = dict(_leaves(cache_t))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert rel_err(leaf, want[path]) < REL, path


@pytest.fixture(scope="module")
def h2o():
    cfg_j = jreg.get_smoke_config("h2o_danube_3_4b").replace(use_kernels=True)
    cfg_t = registry.get_smoke_config("h2o_danube_3_4b")
    params_j = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = transplant(jax.tree_util.tree_map(np.asarray, params_j), device="cpu")
    return cfg_j, params_j, cfg_t, params_t


# (prompt S, cache_len) against the smoke window of 16: S below the ring's
# size, equal to it, past it (the last 16 rows at slots p % 16), a cache_len
# below S (a ring of cache_len rows), and cache_len 0 (rows unplaced)
RING_PLACEMENTS = [(12, 64), (16, 64), (40, 64), (20, 8), (24, 0)]


@pytest.mark.parametrize("s,cache_len", RING_PLACEMENTS)
def test_local_prefill_places_rows_like_pad_cache(h2o, s, cache_len):
    """``lm.forward``'s cache for ``local`` layers equals the reference's
    ``_pad_cache`` placement, shape and rows."""
    cfg_j, params_j, cfg_t, params_t = h2o
    tokens = np.random.default_rng(s).integers(0, cfg_t.vocab_size, (B, s), dtype=np.int32)
    logits_j, _, cache_j = jlm.forward(params_j, cfg_j, {"tokens": jnp.asarray(tokens)},
                                       collect_cache=True, cache_len=cache_len)
    logits_t, _, cache_t = lm.forward(params_t, cfg_t, {"tokens": torch.from_numpy(tokens)},
                                      collect_cache=True, cache_len=cache_len)
    assert rel_err(logits_t, logits_j) < REL
    size = min(cfg_t.sliding_window, cache_len) if cache_len else s
    assert cache_t["phase0"]["slot0"]["k"].shape[2] == size
    _assert_caches_match(cache_t, cache_j)


@pytest.mark.parametrize("chunk", [5, 16])
def test_ring_prefill_across_the_wrap_matches_reference(h2o, chunk):
    """A 40-token prompt through chunked prefill on a ring of the smoke
    window (16 rows): chunks cross the wrap, so the shared per-row buffer
    (pre-chunk ring unrolled, then the chunk) meets every case of the
    reference's per-query ring; then decode continues on the ring."""
    cfg_j, params_j, cfg_t, params_t = h2o
    prompt = 40
    tokens = np.random.default_rng(3).integers(0, cfg_t.vocab_size, (B, prompt + 4),
                                               dtype=np.int32)
    cache_j = jlm.init_cache(cfg_j, B, 64)
    cache_t = lm.init_cache(cfg_t, B, 64, device="cpu")
    assert cache_t["phase0"]["slot0"]["k"].shape[2] == cfg_t.sliding_window
    for c0 in range(0, prompt, chunk):
        c = min(chunk, prompt - c0)
        pos = np.broadcast_to(np.arange(c0, c0 + c, dtype=np.int32), (B, c))
        want, cache_j = jlm.prefill_chunk(params_j, cfg_j, jnp.asarray(tokens[:, c0:c0 + c]),
                                          jnp.asarray(pos), cache_j)
        got, cache_t = lm.prefill_chunk(params_t, cfg_t, torch.from_numpy(tokens[:, c0:c0 + c]),
                                        torch.from_numpy(pos.copy()), cache_t)
        assert rel_err(got, want) < REL, c0
    _assert_caches_match(cache_t, cache_j)
    for t in range(prompt, prompt + 4):
        pos = np.full((B,), t, np.int32)
        want, cache_j = jlm.decode_step(params_j, cfg_j, jnp.asarray(tokens[:, t:t + 1]),
                                        jnp.asarray(pos), cache_j)
        got, cache_t = lm.decode_step(params_t, cfg_t, torch.from_numpy(tokens[:, t:t + 1]),
                                      torch.from_numpy(pos), cache_t)
        assert rel_err(got, want) < REL, t
    _assert_caches_match(cache_t, cache_j)


def test_ring_prefill_buffer_is_linear_in_ring_and_chunk(monkeypatch):
    """The ring branch of ``gqa_prefill`` holds one key buffer of size + C
    rows per row, never C copies of the ring: the largest tensor it makes
    is the Hq x C x (size + C) logits."""
    from repro_torch.models import attention

    cfg = registry.get_smoke_config("h2o_danube_3_4b").replace(sliding_window=64)
    params = lm.init_params(cfg, device="cpu")
    p = lm._at(params["phase0"], 0)["slot0"]["mixer"]
    c, size = 32, cfg.sliding_window
    cache = lm.init_cache(cfg, 1, size, device="cpu")
    cache = lm._at(cache["phase0"], 0)["slot0"]
    x = torch.randn(1, c, cfg.d_model)
    pos = torch.arange(100, 100 + c, dtype=torch.int32)[None]
    seen = []
    real = attention._masked_softmax_attend

    def spy(q, keys, vals, valid):
        seen.append((tuple(keys.shape), tuple(valid.shape)))
        return real(q, keys, vals, valid)

    monkeypatch.setattr(attention, "_masked_softmax_attend", spy)
    attention.gqa_prefill(p, x, cache, pos, cfg, window=size)
    assert seen == [((1, size + c, cfg.n_kv_heads, cfg.head_dim), (1, c, size + c))]


def test_bf16_scaled_embedding_matches_reference_bitwise():
    """gemma3's ``_embed`` in bf16: rows of the same transplanted table times
    sqrt(d_model) rounded to bf16 first (50.5 at the full width, not
    50.596), equal to the reference's to the bit; an unrounded factor
    parts from it."""
    cfg_j = jreg.get_smoke_config("gemma3_4b").replace(d_model=2560, dtype="bfloat16")
    cfg_t = registry.get_smoke_config("gemma3_4b").replace(d_model=2560, dtype="bfloat16")
    rng = np.random.default_rng(4)
    table = rng.standard_normal((cfg_t.vocab_size, cfg_t.d_model), dtype=np.float32)
    tokens = rng.integers(0, cfg_t.vocab_size, (B, S), dtype=np.int32)
    want = jlm._embed({"embed": jnp.asarray(table)}, cfg_j, jnp.asarray(tokens))
    params_t = transplant({"embed": table}, device="cpu", dtype=cfg_t.compute_dtype)
    got = lm._embed(params_t, cfg_t, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    unrounded = (params_t["embed"][torch.from_numpy(tokens).long()].float()
                 * cfg_t.d_model ** 0.5).to(torch.bfloat16)
    assert not torch.equal(got, unrounded)


def test_kernel_switch_is_the_plain_path_on_cpu(models):
    """use_kernels=True on CPU tensors runs the twins: same logits bit for bit."""
    _, _, cfg_t, params_t, tokens = models
    batch = _tbatch(cfg_t, tokens)
    a, _, _ = lm.forward(params_t, cfg_t, batch)
    b, _, _ = lm.forward(params_t, cfg_t.replace(use_kernels=True), batch)
    assert torch.equal(a, b)
