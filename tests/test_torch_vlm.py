"""qwen2-vl-7b's M-RoPE and vision rows on the port against the JAX reference.

The smoke config (2 layers, d 128, 4 query heads over 2 kv heads of 32,
8 vision rows, fp32).  The reference builds the parameters and runs with
``use_kernels=True`` (Pallas in interpret mode); ``transplant`` loads them
into the port's plain CPU path.  Token ids and vision embeddings are drawn
with numpy from a seed.  Every M-RoPE test runs three distinct streams:
with equal streams M-RoPE is plain RoPE, and neither a wrong section split
nor streams taken in the wrong order would show.  The forward runs a real
image grid (image rows at t 0 and h, w their grid cell; text from the
grid's side onward on all three streams).  Decode is held only where the
temporal stream equals the sequence index: the reference indexes its
cache by t (``attention._tpos``), so after a grid t falls behind the
sequence index and a decode step overwrites a prefill row (ROADMAP queue
3); ``test_decode_after_a_grid_keeps_the_references_cache_index`` holds
the port to that behaviour, not to a repair.  Tolerances: ``apply_mrope``
at fp32 1e-6; whole models rel < 2e-3 (tests/test_archs.py:66-67),
generated tokens identical.
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
from repro.serving.continuous import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import make_lm_predictor  # noqa: E402
from repro_torch.models import attention, lm, steps  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402
from repro_torch.serving.continuous import ContinuousBatcher  # noqa: E402

ARCH = "qwen2_vl_7b"
B, S, GEN = 2, 16, 4
GRID_W = 4           # the smoke's 8 vision rows as a 2 x 4 grid
REL = 2e-3
MROPE_TOL = 1e-6


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


def grid_positions(b: int, s: int, n_vis: int, width: int) -> np.ndarray:
    """(B,3,S) M-RoPE positions of n_vis image rows on a grid ``width``
    wide (t 0, h = i // width, w = i % width), then text from the grid's
    larger side onward, equal on all three streams (Qwen2-VL's layout)."""
    i = np.arange(s)
    side = max(-(-n_vis // width), width)
    text = side + i - n_vis
    pos = np.stack([np.where(i < n_vis, 0, text),
                    np.where(i < n_vis, i // width, text),
                    np.where(i < n_vis, i % width, text)])
    return np.broadcast_to(pos[None], (b, 3, s)).astype(np.int32).copy()


def tseq_positions(b: int, s0: int, s1: int) -> np.ndarray:
    """(B,3,S) positions whose temporal stream is the sequence index s0..s1-1
    (so the cache index is the reference's and a decode step's own), with
    the two spatial streams distinct from it and from each other."""
    i = np.arange(s0, s1)
    pos = np.stack([i, i // 3 + 1, (i * 7) % 5 + 2])
    return np.broadcast_to(pos[None], (b, 3, s1 - s0)).astype(np.int32).copy()


@pytest.fixture(scope="module")
def vlm():
    cfg_j = jreg.get_smoke_config(ARCH).replace(use_kernels=True)
    cfg_t = registry.get_smoke_config(ARCH)
    params_j = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = transplant(_np(params_j), device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_t.vocab_size, (B, S + GEN), dtype=np.int32)
    vision = rng.normal(0, 0.02, (B, cfg_t.n_vision_tokens, cfg_t.d_model)).astype(np.float32)
    return cfg_j, params_j, cfg_t, params_t, tokens, vision


def _batches(tokens, vision, pos):
    np_batch = {"tokens": tokens, "vision_embeds": vision, "mrope_positions": pos}
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in np_batch.items()})


@pytest.mark.parametrize("d", [32, 128])
def test_apply_mrope_matches_reference_on_distinct_streams(d):
    """The smoke's head dim (sections 6/5/5) and the full one (22/21/21),
    three unrelated random streams."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((B, S, 3, d), dtype=np.float32)
    pos = rng.integers(0, 400, (B, 3, S), dtype=np.int32)
    want = jattn.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = attention.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= MROPE_TOL


@pytest.mark.parametrize("d,sections", [(32, (6, 5, 5)), (128, (22, 21, 21))])
def test_apply_mrope_rotates_each_streams_own_section(d, sections):
    """With one stream moved, only that stream's section of the frequency
    dims rotates (both halves of the split); with all three equal, M-RoPE is
    RoPE."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 2, 1, d),
                                                                  dtype=np.float32))
    bounds = np.cumsum((0,) + sections)
    for stream in range(3):
        pos = torch.zeros((1, 3, 2), dtype=torch.int32)
        pos[0, stream] = 37
        moved = (attention.apply_mrope(x, pos, 1e4) != x)[0, 0, 0].numpy()
        want = np.zeros(d // 2, bool)
        want[bounds[stream]:bounds[stream + 1]] = True
        np.testing.assert_array_equal(moved[:d // 2], want)
        np.testing.assert_array_equal(moved[d // 2:], want)
    same = torch.full((1, 3, 2), 123, dtype=torch.int32)
    torch.testing.assert_close(attention.apply_mrope(x, same, 1e4),
                               attention.apply_rope(x, same[:, 0], 1e4), rtol=0, atol=0)


def test_forward_with_vision_rows_and_a_grid_matches_reference(vlm):
    cfg_j, params_j, cfg_t, params_t, tokens, vision = vlm
    pos = grid_positions(B, S, cfg_t.n_vision_tokens, GRID_W)
    assert len({tuple(pos[0, k]) for k in range(3)}) == 3
    bj, bt = _batches(tokens[:, :S], vision, pos)
    want, _, _ = jlm.forward(params_j, cfg_j, bj)
    got, _, _ = lm.forward(params_t, cfg_t, bt)
    assert tuple(got.shape) == (B, S, cfg_t.vocab_size)
    assert rel_err(got, want) < REL
    # the vision rows replace the embedded tokens: other ids there change nothing
    other = dict(bt, tokens=bt["tokens"].clone())
    other["tokens"][:, :cfg_t.n_vision_tokens] = 0
    np.testing.assert_array_equal(lm.forward(params_t, cfg_t, other)[0].numpy(), got.numpy())


def test_prefill_cache_and_decode_match_reference_and_forward(vlm):
    """Prefill S-1 tokens, decode the last at (B,3) positions whose t is the
    sequence index: the reference's decode_step and the port's full forward."""
    cfg_j, params_j, cfg_t, params_t, tokens, vision = vlm
    pos = tseq_positions(B, 0, S)
    bj, bt = _batches(tokens[:, :S - 1], vision, pos[:, :, :S - 1])
    last_j, cache_j = jsteps.prefill(params_j, bj, cfg=cfg_j, cache_len=S + 4)
    last_t, cache_t = steps.prefill(params_t, bt, cfg=cfg_t, cache_len=S + 4)
    assert rel_err(last_t, last_j) < REL
    want = dict(_leaves(_np(cache_j)))
    for path, leaf in _leaves(cache_t):
        assert rel_err(leaf, want[path]) < REL, path
    step_pos = pos[:, :, S - 1]                                       # (B,3)
    step_j, _ = jlm.decode_step(params_j, cfg_j, jnp.asarray(tokens[:, S - 1:S]),
                                jnp.asarray(step_pos), cache_j)
    step_t, _ = lm.decode_step(params_t, cfg_t, torch.from_numpy(tokens[:, S - 1:S]),
                               torch.from_numpy(step_pos.copy()), cache_t)
    assert rel_err(step_t, step_j) < REL
    full, _, _ = lm.forward(params_t, cfg_t, _batches(tokens[:, :S], vision, pos)[1])
    assert rel_err(step_t, full[:, -1]) < REL


def test_greedy_decode_matches_reference(vlm):
    cfg_j, params_j, cfg_t, params_t, tokens, vision = vlm
    pos = tseq_positions(B, 0, S)
    bj, bt = _batches(tokens[:, :S], vision, pos)
    cache_len = S + GEN + 1
    last_j, cache_j = jsteps.prefill(params_j, bj, cfg=cfg_j, cache_len=cache_len)
    last_t, cache_t = steps.prefill(params_t, bt, cfg=cfg_t, cache_len=cache_len)
    first_j = jnp.argmax(last_j, -1).astype(jnp.int32)[:, None]
    first_t = torch.argmax(last_t, -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(first_t.numpy(), np.asarray(first_j))
    start = tseq_positions(B, S, S + 1)[:, :, 0]          # t = S; h, w their own
    toks_j, cache_j = jsteps.greedy_decode_loop(params_j, cache_j, first_j, jnp.asarray(start),
                                                GEN, cfg=cfg_j)
    toks_t, cache_t = steps.greedy_decode_loop(params_t, cache_t, first_t,
                                               torch.from_numpy(start.copy()), GEN, cfg=cfg_t)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    want = dict(_leaves(_np(cache_j)))
    for path, leaf in _leaves(cache_t):
        assert rel_err(leaf, want[path]) < REL, path


@pytest.mark.parametrize("chunk", [5, S])
def test_prefill_chunk_matches_reference_on_distinct_streams(vlm, chunk):
    """Chunked prefill with (B,3,C) positions (t the sequence index, h and w
    apart): logits and caches as the reference's."""
    cfg_j, params_j, cfg_t, params_t, tokens, _ = vlm
    cache_j = jlm.init_cache(cfg_j, B, S + 4)
    cache_t = lm.init_cache(cfg_t, B, S + 4, device="cpu")
    for c0 in range(0, S, chunk):
        c = min(chunk, S - c0)
        pos = tseq_positions(B, c0, c0 + c)
        want, cache_j = jlm.prefill_chunk(params_j, cfg_j, jnp.asarray(tokens[:, c0:c0 + c]),
                                          jnp.asarray(pos), cache_j)
        got, cache_t = lm.prefill_chunk(params_t, cfg_t, torch.from_numpy(tokens[:, c0:c0 + c]),
                                        torch.from_numpy(pos), cache_t)
        assert rel_err(got, want) < REL, c0
    want = dict(_leaves(_np(cache_j)))
    for path, leaf in _leaves(cache_t):
        assert rel_err(leaf, want[path]) < REL, path


def test_decode_after_a_grid_keeps_the_references_cache_index(vlm):
    """After an image grid the text's t (here 4 onward) falls behind the
    sequence index: the reference's decode step writes cache row t, a
    prefill row, and attends rows 0..t.  The port keeps that semantics (a
    reference fault, ROADMAP queue 3): the same logits, the same row
    overwritten, the rows past t untouched."""
    cfg_j, params_j, cfg_t, params_t, tokens, vision = vlm
    pos = grid_positions(B, S, cfg_t.n_vision_tokens, GRID_W)
    bj, bt = _batches(tokens[:, :S], vision, pos)
    _, cache_j = jsteps.prefill(params_j, bj, cfg=cfg_j, cache_len=S + 4)
    _, cache_t = steps.prefill(params_t, bt, cfg=cfg_t, cache_len=S + 4)
    before = cache_t["phase0"]["slot0"]["k"].clone()
    step_pos = pos[:, :, -1] + 1
    t = int(step_pos[0, 0])
    assert t < S
    want, cache_j = jlm.decode_step(params_j, cfg_j, jnp.asarray(tokens[:, S:S + 1]),
                                    jnp.asarray(step_pos), cache_j)
    got, cache_t = lm.decode_step(params_t, cfg_t, torch.from_numpy(tokens[:, S:S + 1]),
                                  torch.from_numpy(step_pos.copy()), cache_t)
    assert rel_err(got, want) < REL
    after = cache_t["phase0"]["slot0"]["k"]
    changed = (after != before).flatten(3).any(-1).any(0).any(0)     # (rows,)
    assert changed.nonzero().flatten().tolist() == [t]
    assert rel_err(after, np.asarray(cache_j["phase0"]["slot0"]["k"])) < REL


def test_predictor_matches_the_reference_predictor(vlm):
    """``make_lm_predictor`` builds the reference's inputs around the ids
    (zero vision rows, equal M-RoPE streams, a (B,3) start) and gives the
    reference predictor's tokens on the same weights."""
    cfg_j, _, cfg_t, _, tokens, _ = vlm
    cfg_j = cfg_j.replace(use_kernels=False)
    want = jmake_lm_predictor(cfg_j, gen_tokens=GEN, prompt_len=S, seed=0).predict(
        jnp.asarray(tokens[:, :S]))
    params = transplant(_np(jlm.init_params(jax.random.PRNGKey(0), cfg_j)), device="cpu")
    pred = make_lm_predictor(cfg_t, gen_tokens=GEN, prompt_len=S, params=params, device="cpu")
    np.testing.assert_array_equal(pred.predict(tokens[:, :S]).numpy(), np.asarray(want))


@pytest.mark.parametrize("chunk", [0, 5])
def test_batcher_emits_the_reference_batchers_tokens(vlm, chunk):
    """Both batchers broadcast a slot's position to the three streams
    (text only); more requests than slots, teacher-forced and chunked."""
    cfg_j, params_j, cfg_t, params_t, _, _ = vlm
    cfg_j = cfg_j.replace(use_kernels=False)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg_t.vocab_size, n).tolist() for n in (3, 14, 9, 1)]
    outs = []
    for make, cfg, params in ((JaxBatcher, cfg_j, params_j),
                              (ContinuousBatcher, cfg_t, params_t)):
        b = make(cfg, params, max_slots=2, max_len=32, prefill_chunk=chunk)
        reqs = [b.submit(p, max_new=5) for p in prompts]
        b.run()
        outs.append([list(map(int, r.output)) for r in reqs])
    assert outs[1] == outs[0]


def test_serve_launcher_runs_qwen2_vl_on_the_host(capsys):
    serve.main(["--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu", "--requests", "2",
                "--gen-tokens", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "qwen2-vl-7b" and out["device"] == "cpu" and out["n"] == 2
