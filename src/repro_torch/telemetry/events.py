"""Structured event log + stage timing (the Istio-metrics analog): the
port's copy of ``repro.telemetry.events``, without its legacy shared
sink ``GLOBAL_LOG`` (every port run owns its log).

Every pipeline run / serving session records stage events; benchmarks read
these to build the paper's Tables 4/5 (per-stage pipeline timing).  The
log is one leg of the observability plane (DESIGN.md S5): events are the
flat audit stream, ``telemetry/trace.py`` holds the span tree,
``telemetry/metrics.py`` the counter/histogram series derived from both.

Determinism contract: ``record`` stamps a monotonic per-log ``seq`` --
never the wall clock -- and simulated timestamps ride in ``t_sim`` meta,
so ``dump()`` is byte-stable under a fixed seed.  Wall-clock measurements
(the hardware-gate side of DESIGN.md S1) are confined to two places:
``stage(...)`` events (marked ``wall=True``) and explicit ``wall_s`` meta
keys.  ``dump()`` strips both by default; ``dump(include_wall=True)``
keeps them for profiling.

Gateway event vocabulary (serving/gateway/router.py, DESIGN.md S3):
  gateway:run                the whole simulation (duration = simulated
                             makespan; wall_s meta carries the real wall)
  gateway:scale_up/down      replica launched / retired (cloud-stamped)
  gateway:scale_to_zero      every pool of a deployment emptied
  gateway:cold_start         first batch on a weightless replica
  gateway:scale_denied       launch refused (capacity or cloud_down)
  gateway:capacity_exceeded  documented scale-from-zero CLOUD budget breach
  gateway:budget_exceeded    documented scale-from-zero breach of a
                             deployment's max_replicas (queued work is
                             pinned to a pool; starving it would stall)
  gateway:preempt            latency-class batch evicted an in-flight batch
  gateway:shed               admission control dropped a request whose
                             expected completion already breached its
                             class deadline (exactly once per request;
                             carries model/cloud/cls/idx and at=enqueue
                             or at=dispatch; sheddable classes only --
                             batch work is deferred, never shed)
  gateway:split              a model's live split weights changed (carries
                             the normalized {cloud: weight} map, which sums
                             to 1 unless every cloud is down; reasons:
                             fail / recover / migrate)
  gateway:migrate            a re-planning decision: an explicit
                             MigrationSpec step (reason=plan) or an
                             auto-replan shift (reason=overload /
                             miss_rate / shed_rate / slo_burn / cost,
                             with src/dst/delta)
  gateway:failover/recover   outage edge as seen by one deployment -- the
                             degenerate split (dead cloud's weight -> 0,
                             restored on recovery)
  gateway:prefill            prompt-ingest accounting (DisaggSpec models
                             only).  staged=True: a prefill-pool batch
                             finished and its requests moved to the decode
                             pool (duration = the prefill batch service
                             time, n = batch size).  staged=False: a
                             unified ("both"-pool) dispatch's prefill
                             share, priced but not separately scheduled
  gateway:cache_shed         projected KV-block demand for a pool's queue
                             exceeded shed_margin x its kv_blocks budget;
                             the request is dropped BEFORE enqueue with a
                             paired gateway:shed at=cache (carries
                             kv_used / kv_projected / kv_total; physical
                             limit, so it fires even with admission
                             control off -- sheddable classes only)
  gateway:observed           measured arrival rate + realized service time
                             per model (placement.replan input)
  gateway:alert              SLO burn-rate alert edge (telemetry/slo.py):
                             a (model, class) pair is consuming error
                             budget faster than ``threshold`` x the
                             sustainable rate over BOTH the short and long
                             windows (state=firing), or stopped
                             (state=resolved); carries burn_short /
                             burn_long / objective

Observability vocabulary (telemetry/, DESIGN.md S5):
  metrics:scrape             a simulated-time MetricsRegistry snapshot was
                             taken (t_sim, number of live series); the
                             snapshot itself lives in
                             MetricsRegistry.scrapes
  trace:materialize          the gateway's deferred collector flushed: the
                             request span forest was built in bulk AFTER
                             the event loop from the per-batch records
                             (spans; wall_s meta carries the flush cost,
                             reported next to gateway:run's hot-loop wall
                             and excluded from it)
  trace:export               a Tracer span tree was exported (path, spans)

Pipeline-orchestrator vocabulary (pipelines/scheduler.py + runs.py,
DESIGN.md S4; t_sim stamps are simulated seconds):
  pipeline:run               one orchestrated run (duration = simulated
                             makespan; carries run_id / status / cost and
                             the real wall_s the step fns took)
  pipeline:schedule          a step attempt took a worker on a cloud
                             (step / cloud / attempt number)
  pipeline:step              a step completed exactly once (simulated
                             duration, cloud, cached flag, attempt count,
                             accumulated cost)
  pipeline:cache_hit         the control plane reused a content-hash
                             artifact without starting a pod (step / key /
                             resident cloud)
  pipeline:transfer          an input artifact moved cross-cloud
                             (src / dst / bytes; duration = simulated
                             transfer seconds, cost = simulated egress $)
  pipeline:retry             an outage killed an attempt and the step
                             backed off (attempt number, next_s)
  pipeline:fail              a step permanently failed (retries exhausted,
                             an exception, or an infeasible deploy plan)
  pipeline:skip              a step never ran because an ancestor failed
  pipeline:deploy            the terminal deploy step handed a model to
                             the serving gateway (model / weights /
                             replicas / cost_hr)
  pipeline:recurring         a recurring-run trigger fired (pipeline,
                             index, t_sim)

Model-CI vocabulary (modelci/ + telemetry/drift.py, DESIGN.md S9):
  modelci:profile            a measured ModelProfile artifact was committed
                             to a ProfileStore (model / cloud / key /
                             service_time_s) -- the profiling DAG's
                             terminal side effect, one per profile step
  modelci:reprofile          sustained profile-vs-observed drift armed a
                             re-profile run for a model (the DriftMonitor
                             is a controller: consumers re-run the
                             profiling DAG for the named model)
  profile:drift              drift edge between the profile a placement
                             was planned from and the scraped serving
                             metrics: state=firing when the observed /
                             profiled service-time ratio leaves the
                             tolerance band for ``sustain`` consecutive
                             scrapes (carries ratio / expected_s /
                             observed_s), state=resolved on recovery

Capacity-market vocabulary (clouds/capacity.py, DESIGN.md S8; recorded
only when a CapacityMarket is shared between the Gateway and the
Orchestrator -- shared_capacity=None emits none of these):
  capacity:lease             a slot lease was granted on a cloud ledger
                             (cloud, kind=serving|training, model/step)
  capacity:preempt           serving demand truncated the youngest
                             training lease (spot semantics), or a
                             recorded serving rise-edge killed a running
                             training attempt, which re-enters the
                             RetryPolicy backoff path
  capacity:handoff           a relaunched serving pool migrated its model
                             state over the interconnect instead of
                             paying a cold load (src / dst / replicas /
                             transfer_s / saved_s)
  capacity:speculate         an outage window threatened a running
                             training attempt and a backup attempt
                             launched on a second cloud (the loser is
                             cancelled through the ledger)
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Optional

# meta keys that carry wall-clock measurements; dump() gates them so the
# default export is byte-stable under a fixed seed
_WALL_KEYS = ("wall_s",)

# The machine-readable registry of every event kind documented above.
# ``unregistered(log)`` is the bench-side gate: a run emitting an event
# name missing from this set is recording vocabulary nobody documented
# (or typo'd a name), which the suites treat as a failure.
EVENT_KINDS = frozenset({
    # gateway (DESIGN.md S3)
    "gateway:run", "gateway:scale_up", "gateway:scale_down",
    "gateway:scale_to_zero", "gateway:cold_start", "gateway:scale_denied",
    "gateway:capacity_exceeded", "gateway:budget_exceeded",
    "gateway:preempt", "gateway:shed", "gateway:split", "gateway:migrate",
    "gateway:failover", "gateway:recover", "gateway:prefill",
    "gateway:cache_shed", "gateway:observed", "gateway:alert",
    # observability plane (DESIGN.md S5)
    "metrics:scrape", "trace:materialize", "trace:export",
    # pipeline orchestrator (DESIGN.md S4)
    "pipeline:run", "pipeline:schedule", "pipeline:step",
    "pipeline:cache_hit", "pipeline:transfer", "pipeline:retry",
    "pipeline:fail", "pipeline:skip", "pipeline:deploy",
    "pipeline:recurring",
    # model-CI profiling plane (DESIGN.md S9)
    "modelci:profile", "modelci:reprofile", "profile:drift",
    # capacity market (DESIGN.md S8)
    "capacity:lease", "capacity:preempt", "capacity:handoff",
    "capacity:speculate",
})


def unregistered(log: "EventLog") -> set:
    """Event names recorded in ``log`` that are absent from EVENT_KINDS.
    Stage events (``wall=True``) are exempt: their names are free-form
    wall-clock labels, not simulation vocabulary."""
    out = set()
    for e in log.events:
        if e.get("wall"):
            continue
        if e["name"] not in EVENT_KINDS:
            out.add(e["name"])
    return out


class EventLog:
    def __init__(self):
        self.events: list[dict] = []
        self._by_name: dict[str, list] = {}  # name -> events (same dicts)
        self._seq = 0                        # monotonic per-log sequence

    def record(self, name: str, duration_s: float, **meta):
        e = {"name": name, "duration_s": duration_s, "seq": self._seq,
             **meta}
        self._seq += 1
        self.events.append(e)
        self._by_name.setdefault(name, []).append(e)

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        """Wall-clock a code block (the hardware-measurement primitive,
        DESIGN.md S1: serial pipeline stages / train jobs are timed on
        this host).  The event is marked ``wall=True`` so ``dump()`` can
        gate its non-deterministic duration."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0, wall=True, **meta)

    def named(self, name: str) -> list:
        """All events with this name, in record order (indexed: O(1) per
        call, not a scan -- the invariant suites call this O(events)
        times)."""
        return list(self._by_name.get(name, ()))

    def count(self, name: str) -> int:
        return len(self._by_name.get(name, ()))

    def totals(self) -> dict:
        out: dict = {}
        for e in self.events:
            out[e["name"]] = out.get(e["name"], 0.0) + e["duration_s"]
        return out

    def dump(self, path: Optional[str] = None, *,
             include_wall: bool = False) -> str:
        """JSON export.  By default every wall-clock field is stripped
        (``wall_s`` meta everywhere; ``duration_s`` on ``wall=True`` stage
        events), so two seeded simulated runs dump byte-identical text.
        ``include_wall=True`` keeps the measurements."""
        events = self.events
        if not include_wall:
            events = []
            for e in self.events:
                drop = _WALL_KEYS + (("duration_s",) if e.get("wall")
                                     else ())
                events.append({k: v for k, v in e.items() if k not in drop}
                              if any(k in e for k in drop) else e)
        s = json.dumps(events, indent=1, default=str)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

