"""Router backends: counterpart of ``repro.serving.gateway.router``.

Only ``BatcherBackend`` is ported: it adapts a ``ContinuousBatcher``
(``serving/continuous.py``) as a backend whose service times are MEASURED
by draining real requests through the batcher.  The rest of the reference
module (the ``Gateway`` event simulation, routing, admission, autoscaling
and migration) is plain Python that meets model compute only through
``service_time``; it is ported with the ``kserve`` strategy (ROADMAP.md
queue 1 item 1.3).

The timing is sound on the card because every batcher step and prefill
pulls its argmax to the host, so ``run()`` returns only when the device
work it queued has finished.
"""
from __future__ import annotations

import math
import time
from typing import Optional


class BatcherBackend:
    """Adapt a ContinuousBatcher as a router backend.

    An LLM's unit of work is decode steps, not one call: a request costs
    ``prompt_len + gen_tokens`` steps (teacher-forced catch-up, then
    generation), and b concurrent requests run in ``ceil(b / max_slots)``
    slot waves.  The per-step wall time is measured once by draining a real
    request through the batcher (after a warm-up drain).

    With a disaggregated batcher (``prefill_chunk > 0``) the estimate splits
    into two measured cost models: ``prefill_time(P)``, ceil(P / chunk)
    prefill calls at the measured per-chunk latency (prompt ingest is serial
    per request, on a one-row cache at admission), and
    ``decode_time(steps)``, the per-step decode latency times steps, shared
    by every occupied slot.  The two are separated by timing two workload
    points (a prompt_len-token prompt and a 1-token prompt, both generating
    gen_tokens) and solving the 2x2 system in (chunk, step) counts read back
    from the batcher's own counters.
    """

    def __init__(self, name: str, batcher, *, prompt_len: int = 8,
                 gen_tokens: int = 8):
        self.name = name
        self.batcher = batcher
        self.prompt_len = prompt_len
        self.gen_tokens = gen_tokens
        self._step_time: Optional[float] = None
        self._chunk_time: Optional[float] = None

    @property
    def disaggregated(self) -> bool:
        return getattr(self.batcher, "prefill_chunk", 0) > 0

    def _timed_run(self, prompt: list) -> tuple:
        """One timed submit + drain; returns (wall_s, chunks, steps) deltas."""
        b = self.batcher
        c0 = b.prefill_stats["chunks"] if self.disaggregated else 0
        s0 = b.step_count
        b.submit(prompt, self.gen_tokens)
        t0 = time.perf_counter()
        b.run()
        dt = time.perf_counter() - t0
        c1 = b.prefill_stats["chunks"] if self.disaggregated else 0
        return dt, c1 - c0, b.step_count - s0

    def _measure(self) -> None:
        prompt = [1 + (i % 97) for i in range(self.prompt_len)]
        self.batcher.submit(prompt, self.gen_tokens)
        self.batcher.run()                       # warm-up
        if not self.disaggregated:
            dt, _, steps = self._timed_run(prompt)
            self._step_time = dt / max(steps, 1)
            self._chunk_time = self._step_time
            return
        self.batcher.submit([1], self.gen_tokens)
        self.batcher.run()                       # warm the short-chunk shape
        dt_a, ch_a, st_a = self._timed_run(prompt)
        dt_b, ch_b, st_b = self._timed_run([1])
        det = ch_a * st_b - ch_b * st_a
        if abs(det) > 1e-12:
            chunk = (dt_a * st_b - dt_b * st_a) / det
            step = (ch_a * dt_b - ch_b * dt_a) / det
        else:            # the prompt fits one chunk: phases indistinguishable
            chunk = step = (dt_a + dt_b) / max(ch_a + st_a + ch_b + st_b, 1)
        self._chunk_time = max(chunk, 1e-9)
        self._step_time = max(step, 1e-9)

    def _ensure_measured(self) -> None:
        if self._step_time is None:
            self._measure()

    def prefill_time(self, prompt_tokens: Optional[int] = None) -> float:
        """Measured prompt-ingest cost for ONE request: ceil(P / chunk)
        prefill calls when disaggregated, P teacher-forced decode steps
        otherwise."""
        self._ensure_measured()
        p = self.prompt_len if prompt_tokens is None else int(prompt_tokens)
        if not self.disaggregated:
            return p * self._step_time
        chunk = max(self.batcher.prefill_chunk, 1)
        return math.ceil(p / chunk) * self._chunk_time

    def decode_time(self, steps: Optional[int] = None) -> float:
        """Measured generation cost: per-step decode latency x steps (every
        occupied slot advances together, so a wave shares this)."""
        self._ensure_measured()
        n = self.gen_tokens if steps is None else int(steps)
        return n * self._step_time

    def service_time(self, b: int) -> float:
        self._ensure_measured()
        waves = math.ceil(b / self.batcher.max_slots)
        if not self.disaggregated:
            return waves * (self.prompt_len + self.gen_tokens) * self._step_time
        # prompt ingest is serial per request (one-row prefill cache at
        # admission); generation advances whole slot waves per step
        return (b * self.prefill_time(self.prompt_len)
                + waves * self.decode_time(self.gen_tokens))

    def generate(self, prompts: list, max_new: int) -> list:
        """Real generation passthrough (not simulated)."""
        reqs = [self.batcher.submit(list(p), max_new) for p in prompts]
        self.batcher.run()
        return [r.output for r in reqs]
