"""Pipeline runs: retry policy, per-run records, and the Runs / Recurring
Runs manager (the paper's Kubeflow-UI concept).

A ``RunRecord`` is the orchestrator's answer for ONE execution of a
compiled ``PipelineSpec``: per-step status / cloud / attempts / simulated
timing / simulated dollars, with the exactly-once contract -- every step
ends in exactly one of ``done`` / ``failed`` / ``skipped``, a ``done`` step
has exactly one successful attempt, and a ``failed`` step exhausted its
``RetryPolicy`` (each failed attempt either logged ``pipeline:retry`` and
backed off, or logged ``pipeline:fail`` and permanently failed, cascading
``skipped`` to every descendant).

``PipelineRuns`` keeps the run history: one-shot ``submit`` and
``recurring`` (fire every ``every_s`` of simulated time; a run that
overruns its period delays the next trigger -- catch-up, never overlap).
Recurring runs share the orchestrator's ArtifactCache, so an unchanged
step is a cache hit on every run after the first.  The port's copy of
``repro.pipelines.runs``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff over simulated time: attempt k (0-based) that
    fails re-enters the ready queue after ``backoff_s * backoff_mult**k``,
    up to ``max_retries`` retries (so at most ``max_retries + 1`` attempts
    total) before the step permanently fails."""
    max_retries: int = 2
    backoff_s: float = 0.5
    backoff_mult: float = 2.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_s <= 0:
            raise ValueError("backoff_s must be > 0")
        if self.backoff_mult < 1.0:
            raise ValueError("backoff_mult must be >= 1")

    def delay_s(self, attempt: int) -> float:
        return self.backoff_s * self.backoff_mult ** attempt


@dataclasses.dataclass
class StepRecord:
    """One step's bookkeeping inside a run.  ``attempts`` holds one dict
    per attempt: {cloud, start_s, end_s, status, cost_usd} with status one
    of "ok" (completed), "outage" (killed by a failure window, retryable),
    "exception" (the fn raised) or "infeasible" (deploy plan did not fit)
    -- the latter two fail fast, zero-cost, no retries.  ``cost_usd``
    totals every attempt's worker-seconds x price plus egress; outage
    attempts are charged too (the pod ran until the cloud died)."""
    name: str
    status: str = "pending"              # done | failed | skipped
    cloud: Optional[str] = None          # cloud of the deciding attempt
    cached: bool = False
    start_s: float = 0.0                 # first attempt start (sim)
    end_s: float = 0.0                   # deciding attempt end (sim)
    compute_s: float = 0.0               # measured (or sim_s) compute
    transfer_s: float = 0.0
    transfer_cost_usd: float = 0.0
    cost_usd: float = 0.0
    attempts: list = dataclasses.field(default_factory=list)
    span_id: Optional[int] = None        # pipeline.step span (tracer runs)

    @property
    def retries(self) -> int:
        return max(len(self.attempts) - 1, 0)

    @property
    def duration_s(self) -> float:
        """Simulated wall of the whole step (first start -> deciding end),
        backoff gaps included."""
        return max(self.end_s - self.start_s, 0.0)


@dataclasses.dataclass
class RunRecord:
    run_id: str
    pipeline: str
    status: str                          # succeeded | failed
    t0: float                            # simulated submit time
    finished_s: float                    # simulated completion time
    steps: dict                          # name -> StepRecord
    outputs: dict                        # name -> value (done steps only)
    cost_usd: float = 0.0
    cache_hits: int = 0
    span_id: Optional[int] = None        # pipeline.run span (tracer runs):
    # the handle telemetry/analyze.py run_critical_path / run_table take

    @property
    def makespan_s(self) -> float:
        return max(self.finished_s - self.t0, 0.0)

    def stage_s(self) -> dict:
        """Per-step simulated duration (Tables 4/5 row shape)."""
        return {n: round(r.duration_s, 6) for n, r in self.steps.items()
                if r.status == "done"}

    def summary(self) -> dict:
        return {"run_id": self.run_id, "status": self.status,
                "makespan_s": round(self.makespan_s, 6),
                "sim_cost_usd": round(self.cost_usd, 8),
                "cache_hits": self.cache_hits,
                "steps": {n: {"status": r.status, "cloud": r.cloud,
                              "cached": r.cached,
                              "sim_s": round(r.duration_s, 6),
                              "attempts": len(r.attempts),
                              "cost_usd": round(r.cost_usd, 8)}
                          for n, r in self.steps.items()}}


class PipelineRuns:
    """Run history + triggers over one Orchestrator (its ArtifactCache and
    EventLog persist across runs, so recurring runs cache-hit and the
    ``pipeline:*`` event stream covers the whole history)."""

    def __init__(self, orchestrator):
        self.orchestrator = orchestrator
        self.history: list = []          # RunRecord, submit order

    def _next_id(self, spec) -> str:
        return f"{spec.name}-{len(self.history):03d}"

    def submit(self, spec, *, at_s: float = 0.0, failures: Optional[list] = None,
               gateway=None) -> RunRecord:
        """One-shot run at simulated time ``at_s`` (FailureSpec windows are
        absolute simulated times, shared across the whole history)."""
        rec = self.orchestrator.execute(spec, t0=at_s, failures=failures,
                                        gateway=gateway,
                                        run_id=self._next_id(spec))
        self.history.append(rec)
        return rec

    def recurring(self, spec, *, every_s: float, runs: int,
                  failures: Optional[list] = None, gateway=None,
                  start_s: float = 0.0) -> list:
        """Fire ``runs`` runs, one every ``every_s`` of simulated time from
        ``start_s``; a run overrunning its period delays the next trigger
        (catch-up semantics: runs never overlap -- they share the cache)."""
        if every_s <= 0:
            raise ValueError("every_s must be > 0")
        if runs < 1:
            raise ValueError("runs must be >= 1")
        out = []
        t = float(start_s)
        for k in range(runs):
            t = max(t, start_s + k * every_s)
            self.orchestrator.log.record("pipeline:recurring", 0.0,
                                         pipeline=spec.name, index=k,
                                         t_sim=round(t, 6))
            rec = self.submit(spec, at_s=t, failures=failures,
                              gateway=gateway)
            out.append(rec)
            t = rec.finished_s
        return out

    def summary(self) -> dict:
        return {r.run_id: {"status": r.status,
                           "makespan_s": round(r.makespan_s, 6),
                           "sim_cost_usd": round(r.cost_usd, 8),
                           "cache_hits": r.cache_hits}
                for r in self.history}
