"""The port's continuous-batching engine and its router backend.

Twins of tests/test_continuous.py (slot reuse, admission, isolation, and
agreement with the plain prefill + greedy path), of the batcher half of
tests/test_prefill_oracle.py (the tokenwise prefill criterion, the prefill
batcher against the teacher-forced one, the unbounded-prompt guard), and of
the ``BatcherBackend`` tests of tests/test_gateway_disagg.py and
tests/test_gateway.py, up to ``generate``; plus the port's batcher against
the reference's on transplanted weights.  Smoke configs on the CPU, where
the kernels' plain twins run; tolerances are the reference's.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.continuous import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import lm, steps  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402
from repro_torch.serving.continuous import ContinuousBatcher  # noqa: E402
from repro_torch.serving.gateway import BatcherBackend  # noqa: E402


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = registry.get_smoke_config(arch)
    return cfg, lm.init_params(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def setup():
    return _setup("h2o_danube_3_4b")


def _reference_generate(cfg, params, prompt, n_new, cache_len=64):
    """Plain prefill + greedy loop on a batch of one."""
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32)}
    last, cache = steps.prefill(params, batch, cfg=cfg, cache_len=cache_len)
    tok = torch.argmax(last, -1).to(torch.int32)[:, None]
    start = torch.full((1,), len(prompt), dtype=torch.int32)
    toks, _ = steps.greedy_decode_loop(params, cache, tok, start, n_new - 1, cfg=cfg)
    return [int(tok[0, 0])] + toks[0].tolist()


# -- twins of tests/test_continuous.py ----------------------------------------

def test_single_request_matches_reference(setup):
    cfg, params = setup
    prompt = [5, 17, 99, 3]
    want = _reference_generate(cfg, params, prompt, 6)
    cb = ContinuousBatcher(cfg, params, max_slots=2, max_len=64)
    req = cb.submit(prompt, max_new=6)
    cb.run()
    assert req.done
    assert req.output == want, (req.output, want)


def test_concurrent_requests_are_isolated(setup):
    """Each request's output equals its solo run (no cross-slot leaks)."""
    cfg, params = setup
    prompts = [[5, 17, 99, 3], [200, 41], [7, 7, 7, 7, 7, 7]]
    solo = [_reference_generate(cfg, params, p, 5) for p in prompts]
    cb = ContinuousBatcher(cfg, params, max_slots=3, max_len=64)
    reqs = [cb.submit(p, max_new=5) for p in prompts]
    cb.run()
    for r, want in zip(reqs, solo):
        assert r.done and r.output == want


def test_slot_reuse_more_requests_than_slots(setup):
    cfg, params = setup
    cb = ContinuousBatcher(cfg, params, max_slots=2, max_len=64)
    reqs = [cb.submit([i + 1, i + 2], max_new=3) for i in range(5)]
    done = cb.run()
    assert len(done) == 5
    assert all(len(r.output) == 3 for r in reqs)
    # later requests were admitted after earlier ones finished
    assert max(r.admitted_step for r in reqs) > 0


def test_slot_reuse_output_independent_of_previous_occupant(setup):
    """A prompt served after slot reuse equals its solo generation."""
    cfg, params = setup
    target = [42, 43, 44]
    want = _reference_generate(cfg, params, target, 4)
    cb = ContinuousBatcher(cfg, params, max_slots=1, max_len=64)
    cb.submit([9, 8, 7, 6, 5], max_new=4)   # previous occupant
    tgt = cb.submit(target, max_new=4)
    cb.run()
    assert tgt.output == want


def test_ssm_state_reset_on_admission():
    """Recurrent-state arch: slot reuse must not inherit the carry."""
    cfg, params = _setup("zamba2_1_2b")
    target = [11, 12, 13]
    want = _reference_generate(cfg, params, target, 3)
    cb = ContinuousBatcher(cfg, params, max_slots=1, max_len=64)
    cb.submit([400, 300, 200, 100], max_new=3)
    tgt = cb.submit(target, max_new=3)
    cb.run()
    assert tgt.output == want


def test_submit_rids_stay_unique_after_admission(setup):
    """rids are monotonic: rid = len(queue) would reuse a live rid once
    admission popped the queue."""
    cfg, params = setup
    cb = ContinuousBatcher(cfg, params, max_slots=1, max_len=64)
    r1 = cb.submit([1, 2], max_new=2)
    cb.step()                        # admits r1 -> queue drains to empty
    r2 = cb.submit([3, 4], max_new=2)
    assert r1.rid != r2.rid
    done = cb.run()
    assert {r.rid for r in done} == {r1.rid, r2.rid}
    assert r1.done and r2.done


def test_run_returns_each_request_exactly_once(setup):
    """A request finished and returned by one run() is not returned again by
    the next, and stops being tracked."""
    cfg, params = setup
    cb = ContinuousBatcher(cfg, params, max_slots=1, max_len=64)
    r1 = cb.submit([1, 2], max_new=2)
    assert [r.rid for r in cb.run()] == [r1.rid]
    r2 = cb.submit([3, 4], max_new=2)
    assert [r.rid for r in cb.run()] == [r2.rid]
    assert cb.requests == []


def test_max_steps_bounds_each_run_call(setup):
    """max_steps is a per-call budget, not a lifetime cap."""
    cfg, params = setup
    cb = ContinuousBatcher(cfg, params, max_slots=1, max_len=64)
    r = cb.submit([1, 2, 3], max_new=4)          # needs 7 steps total
    assert cb.run(max_steps=4) == []             # budget exhausted mid-flight
    done = cb.run(max_steps=50)                  # fresh budget resumes
    assert [x.rid for x in done] == [r.rid] and r.done


def test_eos_frees_slot_early(setup):
    cfg, params = setup
    cb = ContinuousBatcher(cfg, params, max_slots=1, max_len=64, eos_id=None)
    r = cb.submit([1, 2, 3], max_new=50)
    cb.eos_id = None
    cb.run(max_steps=100)
    assert r.done and len(r.output) <= 50


def test_admission_is_fifo_under_backlog(setup):
    """Submission order is admission order: the queue is a deque popped
    from the head."""
    cfg, params = setup
    cb = ContinuousBatcher(cfg, params, max_slots=2, max_len=64)
    reqs = [cb.submit([i + 1, i + 2], max_new=2) for i in range(8)]
    done = cb.run()
    assert len(done) == 8
    admits = [r.admitted_step for r in reqs]     # indexed by rid order
    assert admits == sorted(admits)              # FIFO: never leapfrogged
    assert all(r.admitted_step >= 0 and r.finished_step >= r.admitted_step
               for r in reqs)


def test_eos_token_finishes_a_request_and_reuses_its_slot(setup):
    """With eos_id set to the first token a prompt generates, that request
    finishes after one token (in decode and at a prefilled admission) and
    the next request gets its slot."""
    cfg, params = setup
    first = _reference_generate(cfg, params, [1, 2, 3], 1)[0]
    for chunk in (0, 2):
        cb = ContinuousBatcher(cfg, params, max_slots=1, max_len=64, eos_id=first,
                               prefill_chunk=chunk)
        r1 = cb.submit([1, 2, 3], max_new=10)
        r2 = cb.submit([1, 2, 3], max_new=10)
        cb.run()
        assert r1.output == [first] and r2.output == [first]
        assert r2.admitted_step >= r1.finished_step


# -- twins of the batcher half of tests/test_prefill_oracle.py ----------------

def _teacher_forced(cfg, params, toks, cache_len):
    """One decode_step per prompt token at B=1."""
    cache = lm.init_cache(cfg, 1, cache_len, device="cpu")
    logits = []
    for t in range(toks.shape[1]):
        lg, cache = lm.decode_step(params, cfg, toks[:, t:t + 1],
                                   torch.tensor([t], dtype=torch.int32), cache)
        logits.append(lg)
    return torch.stack(logits, dim=1), cache


def _chunked(cfg, params, toks, cache_len, chunk):
    cache = lm.init_cache(cfg, 1, cache_len, device="cpu")
    outs, t0, n = [], 0, toks.shape[1]
    while t0 < n:
        c = min(chunk, n - t0)
        pos = torch.arange(t0, t0 + c, dtype=torch.int32)[None]
        lg, cache = lm.prefill_chunk(params, cfg, toks[:, t0:t0 + c], pos, cache)
        outs.append(lg)
        t0 += c
    return torch.cat(outs, dim=1), cache


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ["h2o_danube_3_4b", "minitron_4b", "granite_3_8b"])
def test_prefill_tokenwise_oracle(arch):
    """Chunked prefill against one decode step per token: argmax equal at
    every position, logits allclose at 1e-4, caches at 1e-3 / 1e-4."""
    cfg, params = _setup(arch)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 12),
                                                              dtype=np.int32))
    ref_logits, ref_cache = _teacher_forced(cfg, params, toks, 64)
    pf_logits, pf_cache = _chunked(cfg, params, toks, 64, chunk=5)
    assert torch.equal(torch.argmax(pf_logits, -1), torch.argmax(ref_logits, -1))
    np.testing.assert_allclose(pf_logits.numpy(), ref_logits.numpy(), rtol=1e-4, atol=1e-4)
    want = dict(_leaves(ref_cache))
    for k, leaf in _leaves(pf_cache):
        np.testing.assert_allclose(want[k].float().numpy(), leaf.float().numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=f"{arch}: cache leaf {k}")


def _batcher_outputs(arch, prompts, max_new, max_slots, chunk):
    cfg, params = _setup(arch)
    out = {}
    for pc in (0, chunk):
        b = ContinuousBatcher(cfg, params, max_slots=max_slots, max_len=64, prefill_chunk=pc)
        for p in prompts:
            b.submit(list(p), max_new)
        done = b.run()
        out[pc] = sorted((r.rid, tuple(r.output)) for r in done)
    return out


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_batcher_prefill_equals_teacher_forced_seeded(seed):
    """The scenario draws of the reference's test, on h2o_danube (its other
    arm, gemma3, is not ported): random prompt mixes, chunk sizes and slot
    counts give the prefill batcher the teacher-forced batcher's tokens."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 2)                       # the reference's arch draw
    arch = "h2o_danube_3_4b"
    cfg, _ = _setup(arch)
    n_req = int(rng.integers(1, 5))
    prompts = [list(rng.integers(0, cfg.vocab_size, int(rng.integers(1, 14))))
               for _ in range(n_req)]
    max_new = int(rng.integers(1, 6))
    max_slots = int(rng.integers(1, 4))
    chunk = int(rng.integers(1, 8))
    out = _batcher_outputs(arch, prompts, max_new, max_slots, chunk)
    assert out[0] == out[chunk], (
        f"{arch}: prefill batcher diverged from the teacher-forced one "
        f"(slots={max_slots}, chunk={chunk}, prompts={prompts})")


@pytest.mark.parametrize("chunk", [0, 4])
def test_unbounded_prompt_rejected(chunk):
    """A prompt of len >= max_len is refused at submit; the longest
    admissible one still produces output."""
    cfg, params = _setup("h2o_danube_3_4b")
    b = ContinuousBatcher(cfg, params, max_slots=1, max_len=16, prefill_chunk=chunk)
    with pytest.raises(ValueError, match="max_len"):
        b.submit(list(range(1, 17)), max_new=4)
    with pytest.raises(ValueError, match="max_len"):
        b.submit(list(range(1, 40)), max_new=4)
    req = b.submit(list(range(1, 16)), max_new=4)
    done = b.run()
    assert [r.rid for r in done] == [req.rid] and len(req.output) >= 1


# -- the port's batcher against the reference's -------------------------------

@pytest.mark.parametrize("chunk", [0, 5])
def test_batcher_emits_the_reference_batchers_tokens(chunk):
    """Transplanted h2o_danube smoke weights, the same prompt mix (prompts
    past the 16-row window, so the rings wrap, and more requests than
    slots): the same tokens from both packages' batchers."""
    cfg_j = jreg.get_smoke_config("h2o_danube_3_4b")
    cfg_t = registry.get_smoke_config("h2o_danube_3_4b")
    params_j = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = transplant(jax.tree_util.tree_map(np.asarray, params_j), device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg_t.vocab_size, n).tolist() for n in (3, 22, 9, 30, 1)]
    outs = []
    for make in (JaxBatcher, ContinuousBatcher):
        b = make(cfg_j if make is JaxBatcher else cfg_t,
                 params_j if make is JaxBatcher else params_t,
                 max_slots=2, max_len=48, prefill_chunk=chunk)
        reqs = [b.submit(p, max_new=6) for p in prompts]
        b.run()
        outs.append([list(map(int, r.output)) for r in reqs])
    assert outs[1] == outs[0]


# -- BatcherBackend (tests/test_gateway_disagg.py, tests/test_gateway.py) ------

def test_batcher_backend_cost_split(setup):
    cfg, params = setup
    b = ContinuousBatcher(cfg, params, max_slots=2, max_len=64, prefill_chunk=8)
    be = BatcherBackend("llm", b, prompt_len=16, gen_tokens=4)
    assert be.disaggregated
    pf, dec = be.prefill_time(16), be.decode_time(4)
    assert pf > 0 and dec > 0
    # chunked ingest of a 16-token prompt is 2 prefill calls; the
    # teacher-forced equivalent would be 16 decode steps
    assert be.prefill_time(16) == 2 * be.prefill_time(8)
    assert be.decode_time(8) == 2 * be.decode_time(4)
    assert be.service_time(1) == pytest.approx(pf + dec)
    assert be.service_time(2) == pytest.approx(2 * pf + dec)
    assert be.service_time(3) == pytest.approx(3 * pf + 2 * dec)


def test_batcher_backend_blended_fallback():
    class FakeBatcher:
        prefill_chunk = 0
        max_slots = 2
        step_count = 0

        def submit(self, prompt, max_new):
            self._work = len(prompt) + max_new

        def run(self):
            self.step_count += self._work
            return []

    be = BatcherBackend("m", FakeBatcher(), prompt_len=8, gen_tokens=4)
    assert not be.disaggregated
    # blended: prefill is priced as P teacher-forced steps
    assert be.prefill_time(8) == pytest.approx(8 * be.decode_time(1))


def test_batcher_backend_service_time_and_generation(setup):
    cfg, params = setup
    cb = ContinuousBatcher(cfg, params, max_slots=2, max_len=64)
    be = BatcherBackend("llm", cb, prompt_len=4, gen_tokens=3)
    t1 = be.service_time(2)          # one slot wave
    t2 = be.service_time(3)          # two waves
    assert t1 > 0
    assert abs(t2 / t1 - 2.0) < 1e-6
    outs = be.generate([[5, 17, 99], [7, 7]], max_new=3)
    assert len(outs) == 2 and all(len(o) == 3 for o in outs)
