"""whisper-base's encoder-decoder on the port against the JAX reference.

The smoke config (2 + 2 layers, d 64, 4 heads of 16, 30 encoder rows,
fp32).  The reference builds the parameters (``lm.init_params(PRNGKey(0),
cfg)``) and runs with ``use_kernels=True`` (Pallas in interpret mode:
non-causal flash attention in the encoder and the cross sub-layer, decode
attention over the cached encoder rows); ``transplant`` loads them into the
port, which runs its plain CPU path.  Token ids and frames are drawn with
numpy from a seed.  Tolerances: the sinusoid at fp32 1e-6; one module
(cross-attention, the encoder) rel < 3e-4, the reference's fp32 kernel
tolerance (tests/test_kernels.py:17-19); whole models rel < 2e-3
(tests/test_archs.py:66-67), generated tokens identical.  Also the
reference's audio contract: decode reads the cross rows and never writes
them, chunked prefill raises, the batcher refuses audio.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch.serve import make_lm_predictor as jmake_lm_predictor  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import make_lm_predictor  # noqa: E402
from repro_torch.models import attention, lm, steps  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402
from repro_torch.serving.continuous import ContinuousBatcher  # noqa: E402

ARCH = "whisper_base"
B, S, GEN = 2, 12, 4
REL = 2e-3          # whole models, tests/test_archs.py:66-67
REL_MODULE = 3e-4   # one module in fp32, tests/test_kernels.py:17-19
SINUSOID_TOL = 1e-6


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


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def whisper():
    cfg_j = jreg.get_smoke_config(ARCH).replace(use_kernels=True)
    cfg_t = registry.get_smoke_config(ARCH)
    params_j = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = transplant(_np(params_j), device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_t.vocab_size, (B, S), dtype=np.int32)
    frames = rng.standard_normal((B, cfg_t.encoder_len, cfg_t.d_model), dtype=np.float32)
    return cfg_j, params_j, cfg_t, params_t, tokens, frames


def _batches(tokens, frames):
    return ({"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(tokens), "frames": torch.from_numpy(frames)})


@pytest.mark.parametrize("d", [64, 512])
def test_sinusoid_matches_reference(d):
    """Positions past the encoder's 1500 rows and the decoder's, both widths:
    |port - reference| <= 1e-6 + 2^-22 |p f|.  The second term is fp32's,
    not slack: XLA's fp32 ``exp`` is off the correctly rounded frequency f
    by an ulp at a few of the D/2 frequencies, which moves the angle p f by
    up to p ulps of f (1.2e-4 at p 2000); below p 8 the bound is 1e-6 to
    within 2e-7."""
    pos = np.concatenate([np.arange(1500, dtype=np.int32)[None],
                          np.random.default_rng(d).integers(0, 2000, (1, 1500),
                                                            dtype=np.int32)])
    want = np.asarray(jlm.sinusoid(jnp.asarray(pos), d))
    got = lm.sinusoid(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1500, d)
    half = d // 2
    freqs = np.exp(-np.arange(half) * np.log(10000.0) / max(half - 1, 1))
    angle = np.abs(pos[..., None] * freqs)
    allowed = SINUSOID_TOL + 2.0 ** -22 * np.concatenate([angle, angle], axis=-1)
    assert np.all(np.abs(got.numpy() - want) <= allowed)
    small = pos < 8                                     # no room for a phase error
    assert float(np.abs(got.numpy() - want)[small].max()) <= SINUSOID_TOL


def test_transplant_carries_encoder_cross_and_norm_x(whisper):
    _, params_j, cfg_t, params_t, _, _ = whisper
    want = dict(_leaves(_np(params_j)))
    got = dict(_leaves(params_t))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
    d, h, hd = cfg_t.d_model, cfg_t.n_heads, cfg_t.head_dim
    n_enc, n_dec = cfg_t.encoder_layers, cfg_t.n_layers
    assert got["encoder/mixer/wq"].shape == (n_enc, d, h, hd)
    assert got["encoder/ffn/w_up"].shape == (n_enc, d, cfg_t.d_ff)
    assert "encoder/ffn/w_gate" not in got             # gelu: one-matrix MLP
    assert got["phase0/slot0/cross/wk"].shape == (n_dec, d, cfg_t.n_kv_heads, hd)
    assert got["phase0/slot0/cross/wo"].shape == (n_dec, h, hd, d)
    assert got["phase0/slot0/norm_x"].shape == (n_dec, d)
    assert "cross" not in lm._at(params_t["encoder"], 0)


def test_cross_attention_matches_reference(whisper):
    """``cross_kv``, the non-causal ``cross_forward`` (S queries over the
    encoder rows) and ``cross_decode`` (one query a row over all of them)."""
    cfg_j, params_j, cfg_t, params_t, tokens, frames = whisper
    pj = jax.tree_util.tree_map(lambda t: t[0], params_j["phase0"]["slot0"]["cross"])
    pt = lm._at(params_t["phase0"], 0)["slot0"]["cross"]
    x = np.random.default_rng(1).standard_normal((B, S, cfg_t.d_model), dtype=np.float32)
    kv_j = jattn.cross_kv(pj, jnp.asarray(frames))
    kv_t = attention.cross_kv(pt, torch.from_numpy(frames), cfg_t)
    for got, want in zip(kv_t, kv_j):
        assert rel_err(got, want) < REL_MODULE
    want = jattn.cross_forward(pj, jnp.asarray(x), kv_j, cfg_j)
    got = attention.cross_forward(pt, torch.from_numpy(x), kv_t, cfg_t)
    assert tuple(got.shape) == (B, S, cfg_t.d_model)
    assert rel_err(got, want) < REL_MODULE
    want = jattn.cross_decode(pj, jnp.asarray(x[:, :1]), kv_j, cfg_j)
    got = attention.cross_decode(pt, torch.from_numpy(x[:, :1]), kv_t, cfg_t)
    assert tuple(got.shape) == (B, 1, cfg_t.d_model)
    assert rel_err(got, want) < REL_MODULE


def test_encoder_matches_reference(whisper):
    cfg_j, params_j, cfg_t, params_t, _, frames = whisper
    want = jlm._encoder(params_j, cfg_j, jnp.asarray(frames))
    got = lm._encoder(params_t, cfg_t, torch.from_numpy(frames))
    assert tuple(got.shape) == (B, cfg_t.encoder_len, cfg_t.d_model)
    assert rel_err(got, want) < REL_MODULE


def test_forward_logits_match_reference(whisper):
    cfg_j, params_j, cfg_t, params_t, tokens, frames = whisper
    bj, bt = _batches(tokens, frames)
    want, _, _ = jlm.forward(params_j, cfg_j, bj)
    got, aux, _ = lm.forward(params_t, cfg_t, bt)
    assert tuple(got.shape) == (B, S, cfg_t.vocab_size) and float(aux) == 0.0
    assert rel_err(got, want) < REL


def test_prefill_cache_and_decode_match_reference_and_forward(whisper):
    """Prefill S-1 tokens (the cache: K/V padded, the cross rows, enc_len),
    decode the last: the reference's decode_step and the port's own full
    forward."""
    cfg_j, params_j, cfg_t, params_t, tokens, frames = whisper
    bj, bt = _batches(tokens[:, :-1], frames)
    last_j, cache_j = jsteps.prefill(params_j, bj, cfg=cfg_j, cache_len=S + 4)
    last_t, cache_t = steps.prefill(params_t, bt, cfg=cfg_t, cache_len=S + 4)
    assert rel_err(last_t, last_j) < REL
    want = dict(_leaves(_np(cache_j)))
    got = dict(_leaves(cache_t))
    assert got.keys() == want.keys()
    assert got["phase0/slot0/cross_k"].shape == (cfg_t.n_layers, B, cfg_t.encoder_len,
                                                 cfg_t.n_kv_heads, cfg_t.head_dim)
    np.testing.assert_array_equal(got["enc_len"].numpy(), want["enc_len"])
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert rel_err(leaf, want[path]) < REL, path
    pos = np.full((B,), S - 1, np.int32)
    step_j, _ = jlm.decode_step(params_j, cfg_j, jnp.asarray(tokens[:, -1:]), jnp.asarray(pos),
                                cache_j)
    step_t, _ = lm.decode_step(params_t, cfg_t, torch.from_numpy(tokens[:, -1:]),
                               torch.from_numpy(pos), cache_t)
    assert rel_err(step_t, step_j) < REL
    full, _, _ = lm.forward(params_t, cfg_t, _batches(tokens, frames)[1])
    assert rel_err(step_t, full[:, -1]) < REL


def test_greedy_decode_matches_reference_and_keeps_the_cross_rows(whisper):
    """Tokens equal the reference's; the cross rows and enc_len come out
    of GEN in-place decode steps bit for bit as prefill wrote them."""
    cfg_j, params_j, cfg_t, params_t, tokens, frames = whisper
    bj, bt = _batches(tokens, frames)
    cache_len = S + GEN + 1
    last_j, cache_j = jsteps.prefill(params_j, bj, cfg=cfg_j, cache_len=cache_len)
    last_t, cache_t = steps.prefill(params_t, bt, cfg=cfg_t, cache_len=cache_len)
    first_j = jnp.argmax(last_j, -1).astype(jnp.int32)[:, None]
    first_t = torch.argmax(last_t, -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(first_t.numpy(), np.asarray(first_j))
    kept = {path: leaf.clone() for path, leaf in _leaves(cache_t)
            if "cross" in path or path == "enc_len"}
    toks_j, cache_j = jsteps.greedy_decode_loop(params_j, cache_j, first_j,
                                                jnp.full((B,), S, jnp.int32), GEN, cfg=cfg_j)
    toks_t, cache_t = steps.greedy_decode_loop(params_t, cache_t, first_t,
                                               torch.full((B,), S, dtype=torch.int32), GEN,
                                               cfg=cfg_t)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    got = dict(_leaves(cache_t))
    assert set(kept) == {"phase0/slot0/cross_k", "phase0/slot0/cross_v", "enc_len"}
    for path, before in kept.items():
        assert torch.equal(got[path], before), path
    want = dict(_leaves(_np(cache_j)))
    for path, leaf in got.items():
        assert rel_err(leaf, want[path]) < REL, path


def test_chunked_prefill_and_the_batcher_refuse_audio(whisper):
    """The reference's audio contract: no chunked prefill, no batcher."""
    cfg_j, params_j, cfg_t, params_t, tokens, _ = whisper
    pos = np.broadcast_to(np.arange(4, dtype=np.int32), (B, 4))
    with pytest.raises(NotImplementedError, match="audio"):
        jlm.prefill_chunk(params_j, cfg_j, jnp.asarray(tokens[:, :4]), jnp.asarray(pos),
                          jlm.init_cache(cfg_j, B, S))
    with pytest.raises(NotImplementedError, match="audio"):
        lm.prefill_chunk(params_t, cfg_t, torch.from_numpy(tokens[:, :4]),
                         torch.from_numpy(pos.copy()), lm.init_cache(cfg_t, B, S, device="cpu"))
    with pytest.raises(ValueError, match="enc-dec"):
        ContinuousBatcher(cfg_t, params_t)


def test_init_cache_mirrors_the_prefill_cache(whisper):
    cfg_j, _, cfg_t, _, _, _ = whisper
    want = {p: v.shape for p, v in _leaves(_np(jlm.init_cache(cfg_j, B, S)))}
    got = {p: tuple(v.shape) for p, v in _leaves(lm.init_cache(cfg_t, B, S, device="cpu"))}
    assert got == want
    assert lm.init_cache(cfg_t, B, S, device="cpu")["enc_len"].dtype == torch.int32


def test_predictor_matches_the_reference_predictor(whisper):
    """``make_lm_predictor`` builds the reference's inputs around the ids
    (zero frames of encoder_len rows) and gives the reference predictor's
    tokens on the same weights."""
    cfg_j, _, cfg_t, _, tokens, _ = whisper
    cfg_j = cfg_j.replace(use_kernels=False)
    want = jmake_lm_predictor(cfg_j, gen_tokens=GEN, prompt_len=S, seed=0).predict(
        jnp.asarray(tokens))
    params = transplant(_np(jlm.init_params(jax.random.PRNGKey(0), cfg_j)), device="cpu")
    pred = make_lm_predictor(cfg_t, gen_tokens=GEN, prompt_len=S, params=params, device="cpu")
    got = pred.predict(tokens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_launcher_runs_whisper_on_the_host(capsys):
    serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu", "--requests", "2",
                "--gen-tokens", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "whisper-base" and out["device"] == "cpu" and out["n"] == 2
