"""Model-mesh serving gateway: the port's trimmed copy of
``repro.serving.gateway.router``, under the reference's names.

A Gateway owns per-model Deployments -- each a backend (``Predictor`` or
``BatcherBackend``), one replica pool per cloud (``{cloud: _Pool}``), a
weighted traffic split over those pools, and an Autoscaler -- and runs a
mixed multi-model workload (per-model burst / Poisson TrafficSpecs) through
one discrete-event simulation with shared per-cloud replica capacity.
InferenceService (serving/kserve.py) is its single-model client.

The simulation contract is the repo-wide hardware gate (DESIGN.md): compute
service times are MEASURED (``Predictor.service_time`` times real predicts
and waits for the card before it reads the clock; ``BatcherBackend`` drains
real requests through the batcher); network RTT / load-balancer /
model-load constants are SIMULATED from the CloudProfile.  The router
itself is plain Python and numpy and meets model compute only through a
backend's ``.name`` and ``.service_time(b)``.

Ported: queue-aware weighted-JSQ routing over a static split
(RoutingConfig), per-class admission control and shedding
(AdmissionConfig), SLO classes with class-weighted-age dispatch and
latency-preempts-batch, canary versions, the KPA autoscaler with
scale-to-zero and cold starts, shared per-cloud capacity, and both engines
(``run(engine="scalar" | "vector")``, equal to the last bit).  Failover,
migration, re-planning, disaggregation, the capacity market and the
telemetry plane (tracer, metrics, SLO burn, drift) come with ROADMAP.md
queue 1 item 1.3's second slice: passing one of their arguments raises
NotImplementedError.

Event kinds: "arr" request arrival (scalar engine), "up" replica joins a
pool after the control-plane delay, "free" replica finishes a batch,
"idle" idle-window expiry check (scale-down / scale-to-zero).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ...clouds.profiles import CloudProfile
from ...sim.engine import EventHeap, IndexQueue, Ledger
from ...telemetry.events import EventLog
from .autoscaler import Autoscaler, AutoscalerConfig

# the reference's arguments that arrive with the second slice, per call
SECOND_SLICE = {
    "Gateway": ("replan", "tracer", "metrics", "slo_burn", "drift",
                "scrape_every_s", "shared_capacity"),
    "deploy": ("standby", "trace_link", "disagg", "planned_from"),
    "run": ("failures", "migrations"),
}


def _refuse_second_slice(call: str, kw: dict) -> None:
    """Raise for every argument of ``call`` that the port takes only with
    the second slice (None is the reference's own "off"); a name the
    reference does not know either is a TypeError, as for any call."""
    unknown = sorted(set(kw) - set(SECOND_SLICE[call]))
    if unknown:
        raise TypeError(f"{call}() got unexpected keyword arguments {unknown}")
    given = sorted(k for k, v in kw.items() if v is not None)
    if given:
        raise NotImplementedError(
            f"{call}({', '.join(given)}=...) is not ported yet: ROADMAP.md "
            f"queue 1 item 1.3, second slice")


# -- SLO classes -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A traffic priority class.

    weight scales queue age in dispatch scoring (higher = served sooner);
    deadline_mult sets the per-request deadline as a multiple of the
    deployment's warm single-request path (rtt + lb + service_time(1)), so
    the same class means the same *relative* promise on any backend.
    ``preempts`` classes may evict an in-flight ``preemptible`` batch when
    no replica is idle.  ``sheddable=False`` work is never dropped by
    admission control, only deferred (batch: finishing late beats never).
    """
    name: str
    weight: float
    deadline_mult: float
    preempts: bool = False
    preemptible: bool = False
    sheddable: bool = True


SLO_CLASSES = {
    "latency": SLOClass("latency", weight=8.0, deadline_mult=4.0,
                        preempts=True),
    "standard": SLOClass("standard", weight=1.0, deadline_mult=20.0),
    "batch": SLOClass("batch", weight=0.25, deadline_mult=math.inf,
                      preemptible=True, sheddable=False),
}


def resolve_slo(slo) -> SLOClass:
    if isinstance(slo, SLOClass):
        return slo
    try:
        return SLO_CLASSES[slo]
    except KeyError:
        raise ValueError(f"unknown SLO class {slo!r}; "
                         f"known: {sorted(SLO_CLASSES)}") from None


@dataclasses.dataclass(frozen=True)
class RoutingConfig:
    """How `_route` picks a pool within a live split (Gateway(routing=...)).

    policy="queue_aware" (default): weighted join-shortest-expected-queue.
    Every live pool is scored with the expected-completion estimate
    (`Gateway._expected_wait`: queue depth x amortized service estimate +
    RTT/LB + cold-start risk); pools scoring within ``slack`` (relative)
    of the best stay in the candidate band, and the request's pre-drawn
    uniform resolves a weighted draw over the band -- so balanced pools
    split by the declared weights, while a backlogged or cold pool falls
    out of the band and gets no new traffic until it recovers.  Fully
    deterministic under the run seed.

    policy="weights": the pure weighted draw.
    """
    policy: str = "queue_aware"
    slack: float = 0.25

    def __post_init__(self):
        if self.policy not in ("queue_aware", "weights"):
            raise ValueError(f"unknown routing policy {self.policy!r}")
        if self.slack < 0:
            raise ValueError("slack must be >= 0")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Per-class admission control (Gateway(admission=...), off when None).

    A request is shed -- exactly once, `gateway:shed` -- when its expected
    completion already exceeds ``margin x`` its class deadline, measured
    against the SERVING pool's own warm path (rtt + lb + service_time(1)):
    at enqueue via the routing estimate, and (``recheck_at_dispatch``)
    again when its queue reaches a replica, using the then-known best-case
    completion.  ``sheddable=False`` classes and infinite deadlines are
    exempt: deferred, never dropped.
    """
    margin: float = 1.0
    recheck_at_dispatch: bool = True

    def __post_init__(self):
        if self.margin <= 0:
            raise ValueError("margin must be > 0")


# -- results / backends (kserve.py re-exports them) --------------------------

def _class_stats(lats: list, misses: int, shed: int = 0) -> dict:
    """Per-class stats: percentiles/miss over SERVED requests only; shed
    requests are reported separately (shed_rate is shed / offered)."""
    n = len(lats)
    return {"n": n,
            "p50_s": round(float(np.percentile(lats, 50)), 6) if n else None,
            "p99_s": round(float(np.percentile(lats, 99)), 6) if n else None,
            "miss_rate": round(misses / n, 4) if n else 0.0,
            "shed": shed,
            "shed_rate": round(shed / (n + shed), 4) if n + shed else 0.0}


@dataclasses.dataclass
class ServeResult:
    strategy: str
    n_requests: int                      # OFFERED requests (served + shed)
    total_time_s: float
    latencies_s: list                    # served requests only (shed excluded)
    replica_trace: list = dataclasses.field(default_factory=list)
    per_version: dict = dataclasses.field(default_factory=dict)
    class_latencies: dict = dataclasses.field(default_factory=dict)
    class_misses: dict = dataclasses.field(default_factory=dict)
    class_shed: dict = dataclasses.field(default_factory=dict)
    observed: dict = dataclasses.field(default_factory=dict)
    # SIMULATED dollars (CloudProfile.cost_per_s price sheet, DESIGN.md S1):
    # replica-seconds provisioned x per-cloud price, never a measurement
    cost_usd: float = 0.0
    cost_by_cloud: dict = dataclasses.field(default_factory=dict)

    # percentiles are None -- not 0.0 -- when NO request was served (empty
    # class / shed-everything pools), so "nothing served" never reads as
    # "perfect latency"
    @property
    def p50(self) -> Optional[float]:
        return float(np.percentile(self.latencies_s, 50)) \
            if self.latencies_s else None

    @property
    def p99(self) -> Optional[float]:
        return float(np.percentile(self.latencies_s, 99)) \
            if self.latencies_s else None

    @property
    def shed_total(self) -> int:
        return int(sum(self.class_shed.values()))

    @property
    def shed_rate(self) -> float:
        """Shed / offered; 0.0 with admission control off."""
        return self.shed_total / self.n_requests if self.n_requests else 0.0

    def per_class(self) -> dict:
        """Per-SLO-class p50/p99, deadline-miss rate (SERVED requests,
        against the PRIMARY cloud's warm path -- the deployment-level
        promise, see DESIGN.md S3) and shed count/rate."""
        names = sorted(set(self.class_latencies) | set(self.class_shed))
        return {c: _class_stats(self.class_latencies.get(c, []),
                                self.class_misses.get(c, 0),
                                self.class_shed.get(c, 0))
                for c in names}

    def summary(self) -> dict:
        p50, p99 = self.p50, self.p99
        return {"strategy": self.strategy, "n": self.n_requests,
                "total_s": round(self.total_time_s, 4),
                "p50_s": round(p50, 4) if p50 is not None else None,
                "p99_s": round(p99, 4) if p99 is not None else None,
                "replicas_max": max([r for _, r in self.replica_trace], default=1),
                **({"shed": self.shed_total,
                    "shed_rate": round(self.shed_rate, 4)}
                   if self.shed_total else {}),
                **({"sim_cost_usd": round(self.cost_usd, 6)}
                   if self.cost_by_cloud else {}),
                **({"per_version": self.per_version} if self.per_version else {}),
                **({"per_class": self.per_class()}
                   if self.class_latencies or self.class_shed else {})}


class Predictor:
    """A deployable model version: ``predict_fn`` maps a numpy batch of
    inputs to a tensor on ``device``."""

    def __init__(self, name: str, predict_fn: Callable, example_input: Any, *,
                 device="cuda"):
        self.name = name
        self.predict_fn = predict_fn
        self.example_input = example_input
        self.device = torch.device(device)
        self._lat_cache: dict[int, float] = {}

    def _batch_of(self, b: int):
        x = self.example_input
        return np.tile(x[:1], [b] + [1] * (np.ndim(x) - 1))

    def warmup(self, batch_sizes=(1,)):
        for b in batch_sizes:
            self.service_time(b)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def service_time(self, b: int) -> float:
        """Measured wall latency of one predict at b rounded up to its pow2
        bucket: one warm-up call, then the mean of three, each finished on
        the device before the clock is read."""
        b = _pow2(b)
        if b not in self._lat_cache:
            x = self._batch_of(b)
            self.predict_fn(x)
            self._sync()
            t0 = time.perf_counter()
            for _ in range(3):
                self.predict_fn(x)
                self._sync()
            self._lat_cache[b] = (time.perf_counter() - t0) / 3
        return self._lat_cache[b]

    def predict(self, x):
        return self.predict_fn(x)


class BatcherBackend:
    """Adapt a ContinuousBatcher (serving/continuous.py) as a router backend.

    An LLM's unit of work is decode steps, not one call: a request costs
    ``prompt_len + gen_tokens`` steps (teacher-forced catch-up, then
    generation), and b concurrent requests run in ``ceil(b / max_slots)``
    slot waves.  The per-step wall time is measured once by draining a real
    request through the batcher (after a warm-up drain).  The timing is
    sound on the card because every batcher step and prefill pulls its
    argmax to the host, so ``run()`` returns only when the device work it
    queued has finished.

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


def _pow2(b: int) -> int:
    """Service times are measured on pow2 batch buckets."""
    n = 1
    while n < b:
        n *= 2
    return n


_INF = float("inf")


class _Step:
    """Mutable per-timestep scratch shared by both engines: which models
    saw state changes (dispatch/autoscale run once per touched model at
    the end of the step) and deferred idle checks."""

    __slots__ = ("touched", "idle_checks")

    def __init__(self):
        self.touched: set = set()
        self.idle_checks: list = []


def _apportion(total: int, weights: dict) -> dict:
    """Largest-remainder split of ``total`` replicas by weight (zero-weight
    pools get zero); deterministic tie-break by remainder, weight, name.

    Whenever ``total >= len(live)`` every live-weight pool is guaranteed at
    least one replica: a 0.95/0.05 split at total=2 must not floor the 0.05
    pool at zero replicas while routing still sends it traffic."""
    live = {c: w for c, w in weights.items() if w > 0}
    out = {c: 0 for c in weights}
    if not live or total <= 0:
        return out
    s = sum(live.values())
    exact = {c: total * w / s for c, w in live.items()}
    for c in live:
        out[c] = int(math.floor(exact[c]))
    left = total - sum(out.values())
    order = sorted(live, key=lambda c: (-(exact[c] - out[c]), -live[c], c))
    for c in order[:left]:
        out[c] += 1
    if total >= len(live):               # min-1 floor for every live pool
        empty = sorted((c for c in live if out[c] == 0),
                       key=lambda c: (-live[c], c))
        for c in empty:
            donor = max((d for d in live if out[d] >= 2),
                        key=lambda d: (out[d], live[d], d))
            out[donor] -= 1
            out[c] += 1
    return out


# -- workload / deployment ---------------------------------------------------

@dataclasses.dataclass
class TrafficSpec:
    """One arrival stream for one model.  Several specs may target the same
    model (e.g. two bursts separated by more than the idle window to force
    a scale-to-zero -> cold-start cycle).  ``slo`` is an SLO_CLASSES key or
    a custom SLOClass instance applied to every request of this stream."""
    model: str
    n: int
    arrival: str = "burst"               # "burst" | "poisson"
    rate: float = 0.0                    # poisson req/s
    start_s: float = 0.0
    arrivals: Optional[Any] = None       # explicit times override generation
    slo: Any = "standard"                # str key or SLOClass

    def gen(self, rng) -> np.ndarray:
        if self.arrivals is not None:
            return np.asarray(self.arrivals, float)
        if self.arrival == "burst":
            return np.full(self.n, float(self.start_s))
        if self.arrival == "poisson":
            gaps = rng.exponential(1.0 / max(self.rate, 1e-9), self.n)
            return self.start_s + np.cumsum(gaps)
        raise ValueError(f"unknown arrival kind {self.arrival!r}")


@dataclasses.dataclass
class Deployment:
    name: str
    backend: Any                         # .name + .service_time(b) -> s
    profile: CloudProfile                # primary cloud (deadline base)
    autoscaler: Autoscaler
    max_batch: int = 32
    canary: Any = None
    canary_fraction: float = 0.0
    placements: list = dataclasses.field(default_factory=list)
    # [(CloudProfile, weight)]: the declared split
    queue_hint: dict = dataclasses.field(default_factory=dict)
    # {cloud: expected queueing wait s} planner prior, used by queue-aware
    # routing while a pool has no queue of its own yet

    @property
    def backends(self) -> list:
        return [self.backend] + ([self.canary] if self.canary is not None
                                 else [])


@dataclasses.dataclass
class _Replica:
    rid: int
    warm: bool                           # cold replicas pay model_load_s once
    busy: bool = False
    last_active: float = 0.0
    created_s: float = 0.0               # provisioned-time start (cost sheet)
    epoch: int = 0                       # bumps per assignment/preemption;
    inflight: Optional[dict] = None      # stale "free" events check it


class _Pool:
    """One per-cloud replica pool of a deployment: its own queues and
    replicas.  ``weight`` is its traffic share, ``floor`` its apportioned
    slice of min_replicas."""

    def __init__(self, profile: CloudProfile, weight: float):
        self.profile = profile
        self.weight = float(weight)
        self.floor = 0
        self.replicas: dict[int, _Replica] = {}
        self.pending: dict[tuple, IndexQueue] = {}   # FIFO request rows
        self.scheduled_up = 0
        self.replica_seconds = 0.0       # provisioned time (simulated $)
        self.shed_pressure = 0           # sheds since the last launch:
        # unmet demand the autoscaler must see as queue depth, so shedding
        # triggers scale-up instead of masking the overload

    def size(self) -> int:
        return len(self.replicas) + self.scheduled_up

    def queue_len(self) -> int:
        return sum(len(q) for q in self.pending.values())


class _ModelState:
    def __init__(self, dep: Deployment, ledger: Ledger, classes: list):
        self.dep = dep
        self.ledger = ledger             # SoA request columns (sim core)
        # column aliases: the scalar engine addresses single rows, the
        # vectorized engine whole index ranges -- same memory either way
        self.arr = ledger.arr
        self.ver = ledger.ver
        self.cls_code = ledger.cls_code  # int code into ``classes``
        self.route_u = ledger.route_u    # uniform draw per request (routing)
        self.lat = ledger.lat
        self.shed = ledger.shed
        self.classes: list[SLOClass] = classes      # code order
        self.slo_by_name: dict[str, SLOClass] = {c.name: c for c in classes}
        self.cursor = 0                  # vectorized engine: next arrival row
        self.combo_rows: Optional[dict] = None   # lazy: rows per ver x class
        self.pools: dict[str, _Pool] = {}
        for prof, w in dep.placements:
            self.pools[prof.name] = _Pool(prof, w)
        self.next_rid = 0                # rids are model-global: the batch
        self.trace: list = []            # audit keys (model, rid) stay unique
        self.cold_starts = 0
        self.per_version: dict[str, int] = {}
        self.served = 0
        self.busy_s = 0.0                # realized backend service seconds
        self.deadline_base = 0.0         # warm single-request path, primary
        # per-request shed state (ledger.shed column): shed exactly once,
        # excluded from latency percentiles, counted per class
        self.class_shed: dict[str, int] = {}
        self.svc1 = 0.0                  # service_time(1), per-pool bases
        self.svc_est = 0.0               # amortized per-request service est.
        self.base_by_cloud: dict[str, float] = {}   # pool warm paths (lazy)

    def slo(self, i: int) -> SLOClass:
        """The SLO class of request row ``i`` (ledger code -> class)."""
        return self.classes[self.cls_code[i]]

    def total_pool(self) -> int:
        return sum(p.size() for p in self.pools.values())

    def queue_len(self) -> int:
        return sum(p.queue_len() for p in self.pools.values())


@dataclasses.dataclass
class GatewayResult:
    per_model: dict                      # name -> ServeResult
    cold_starts: dict                    # name -> int
    makespan_s: float
    costs: dict = dataclasses.field(default_factory=dict)
    # model -> simulated $ for the run, INCLUDING untrafficked warm pools

    @property
    def total_cost_usd(self) -> float:
        """Simulated fleet dollars (price-sheet output, DESIGN.md S1)."""
        return float(sum(self.costs.values()))

    @property
    def shed_total(self) -> int:
        return sum(r.shed_total for r in self.per_model.values())

    def per_class(self) -> dict:
        """Fleet-wide per-SLO-class stats (latencies pooled across models,
        shed counts included)."""
        lats: dict[str, list] = {}
        miss: dict[str, int] = {}
        shed: dict[str, int] = {}
        for r in self.per_model.values():
            for c, ls in r.class_latencies.items():
                lats.setdefault(c, []).extend(ls)
                miss[c] = miss.get(c, 0) + r.class_misses.get(c, 0)
            for c, n in r.class_shed.items():
                shed[c] = shed.get(c, 0) + n
                lats.setdefault(c, [])
        return {c: _class_stats(ls, miss.get(c, 0), shed.get(c, 0))
                for c, ls in sorted(lats.items())}

    def summary(self) -> dict:
        out = {"makespan_s": round(self.makespan_s, 4),
               "cold_starts": dict(self.cold_starts),
               "models": {m: r.summary() for m, r in self.per_model.items()}}
        if self.costs:
            out["sim_cost_usd"] = round(self.total_cost_usd, 6)
        if self.shed_total:
            out["shed"] = self.shed_total
        pc = self.per_class()
        if pc:
            out["per_class"] = pc
        return out


# -- the router --------------------------------------------------------------

class Gateway:
    """Routes a mixed multi-model workload to per-model, per-cloud replica
    pools by split weight.

    capacity: optional {cloud_name: max_total_replicas} shared across every
    pool placed on that cloud.  The cap bounds ELASTIC scale-up
    (over-budget requests are denied and logged gateway:scale_denied);
    run() rejects a configuration whose baseline min_replicas floors
    already exceed it, and a scale-from-zero launch that would otherwise
    starve forever proceeds over budget with a gateway:capacity_exceeded
    event (the K8s analog: the pod pends, then preempts -- serve-and-log
    keeps the simulation complete).

    routing: RoutingConfig -- queue-aware weighted JSQ by default,
    policy="weights" for the pure pre-drawn weighted draw.

    admission: optional AdmissionConfig -- shed requests whose expected
    completion already exceeds their class deadline (None = admit all,
    the behaviour InferenceService relies on).

    record_batches=True keeps a per-batch audit trail (batch_log) and a
    per-cloud usage trace (usage_trace).  After run(), ``final_weights``
    holds each model's normalized split.
    """

    def __init__(self, *, capacity: Optional[dict] = None,
                 log: Optional[EventLog] = None,
                 routing: Optional[RoutingConfig] = None,
                 admission: Optional[AdmissionConfig] = None,
                 record_batches: bool = False, **second_slice):
        _refuse_second_slice("Gateway", second_slice)
        self.deployments: dict[str, Deployment] = {}
        self.capacity = dict(capacity or {})
        self.log = log or EventLog()
        self.routing = routing or RoutingConfig()
        self.admission = admission
        self.record_batches = record_batches
        self.batch_log: list = []        # dicts, one per dispatched batch
        self.usage_trace: list = []      # (t, cloud, replicas_incl_scheduled)
        self.final_weights: dict = {}    # model -> {cloud: weight} post-run
        self.run_stats: dict = {}        # last run's engine + throughput

    def deploy(self, name: str, backend, profile: Optional[CloudProfile] = None,
               *, split: Optional[dict] = None, autoscaler=None,
               max_batch: int = 32, canary=None, canary_fraction: float = 0.0,
               queue_hint: Optional[dict] = None, **second_slice) -> Deployment:
        """``profile`` places the model on one cloud (weight 1.0);
        ``split={CloudProfile: weight}`` places it active-active (weights
        must sum to 1).  With both, ``profile`` names the primary among the
        split clouds; with only a split, the largest weight is primary.
        ``queue_hint`` ({cloud: expected wait s}, e.g. a placement plan's
        expected queueing wait) seeds queue-aware routing before a pool has
        any queue of its own."""
        _refuse_second_slice("deploy", second_slice)
        if isinstance(autoscaler, AutoscalerConfig):
            autoscaler = Autoscaler(autoscaler)
        if split:
            placements = [(p, float(w)) for p, w in split.items()]
            names = [p.name for p, _ in placements]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate clouds in split: {names}")
            if any(w < 0 for _, w in placements):
                raise ValueError("split weights must be >= 0")
            total = sum(w for _, w in placements)
            if abs(total - 1.0) > 1e-6:
                raise ValueError(f"split weights must sum to 1, got {total}")
            if profile is None:
                profile = max(placements, key=lambda pw: pw[1])[0]
            elif profile.name not in names:
                raise ValueError("profile must be one of the split clouds")
        elif profile is not None:
            placements = [(profile, 1.0)]
        else:
            raise ValueError("deploy needs a profile or a split")
        hint = {c: float(w) for c, w in (queue_hint or {}).items()
                if math.isfinite(w)}
        dep = Deployment(name, backend, profile, autoscaler or Autoscaler(),
                         max_batch, canary, canary_fraction, placements, hint)
        self.deployments[name] = dep
        return dep

    # -- discrete-event loop ------------------------------------------------
    def run(self, traffic: list, seed: int = 0, *, engine: str = "vector",
            **second_slice) -> GatewayResult:
        """Run the workload through the discrete-event simulation.

        engine="vector" (default): the vectorized hot path -- arrivals
        stay in the sorted ledger columns (never entering the event
        heap), whole arrival spans bulk-enqueue between discrete control
        events when a conservative attention predicate proves the span
        side-effect free.  engine="scalar" is the per-request reference
        loop.  The two are BIT-COMPATIBLE: identical EventLog (kinds +
        order), ServeResult, per-class percentiles and simulated dollars on
        any seed; the vector engine falls back to scalar-style
        single-timestamp processing whenever the predicate cannot prove a
        span inert.
        """
        _refuse_second_slice("run", second_slice)
        if engine not in ("scalar", "vector"):
            raise ValueError(f"unknown engine {engine!r}")
        self.batch_log = []              # audit trails cover ONE run
        self.usage_trace = []
        self.final_weights = {}
        rng = np.random.default_rng(seed)
        by_model: dict[str, list] = {}
        for spec in traffic:
            if spec.model not in self.deployments:
                raise KeyError(f"no deployment named {spec.model!r}")
            by_model.setdefault(spec.model, []).append(spec)

        events = EventHeap()
        st: dict[str, _ModelState] = {}
        for m, dep in self.deployments.items():
            specs = by_model.get(m, [])
            times, code_chunks = [], []
            classes: list = []           # SLOClass per code, first-use order
            for spec in specs:
                ts = spec.gen(rng)
                times.append(ts)
                c = resolve_slo(spec.slo)
                code = next((k for k, kc in enumerate(classes)
                             if kc.name == c.name), None)
                if code is None:
                    classes.append(c)
                    code = len(classes) - 1
                elif classes[code] != c:  # queues are keyed by name: two
                    raise ValueError(     # defs would silently share one
                        f"conflicting SLOClass definitions named {c.name!r} "
                        f"on {m!r}: {classes[code]} vs {c}")
                code_chunks.append(np.full(len(ts), code, dtype=np.intp))
            arr = np.concatenate(times) if times else np.zeros(0)
            codes = (np.concatenate(code_chunks) if code_chunks
                     else np.zeros(0, dtype=np.intp))
            order = np.argsort(arr, kind="stable")
            arr = arr[order]
            codes = codes[order]
            ver = np.zeros(len(arr), int)
            if dep.canary is not None and dep.canary_fraction > 0:
                ver = (rng.random(len(arr)) < dep.canary_fraction).astype(int)
            route_u = rng.random(len(arr))
            s = st[m] = _ModelState(dep, Ledger(arr, codes, ver, route_u),
                                    classes)
            floors = _apportion(dep.autoscaler.cfg.min_replicas,
                                {c: p.weight for c, p in s.pools.items()})
            for c, pool in s.pools.items():
                pool.floor = floors[c]
                for _ in range(pool.floor):
                    pool.replicas[s.next_rid] = _Replica(
                        s.next_rid, warm=True)
                    s.next_rid += 1
            s.trace.append((0.0, s.total_pool()))
            s.svc1 = dep.backend.service_time(1)
            # amortized per-request service estimate for the routing /
            # admission expected-completion formula: a full batch's cost
            # split over its requests (svc(1) would overprice a batched
            # backend and over-shed)
            s.svc_est = dep.backend.service_time(dep.max_batch) / dep.max_batch
            s.deadline_base = (dep.profile.network_rtt_s
                               + dep.profile.lb_overhead_s + s.svc1)
            if engine == "scalar":
                # the vector engine keeps arrivals in the sorted ledger
                # columns and consumes them by cursor -- they never touch
                # the heap
                for i, t in enumerate(arr):
                    events.push(float(t), "arr", m, i)

        base: dict[str, int] = {}        # cloud -> baseline floors, over
        for s in st.values():            # EVERY deployment: an idle pool
            for c, pool in s.pools.items():   # still holds cloud capacity
                base[c] = base.get(c, 0) + pool.floor
        for cloud, n in base.items():
            cap = self.capacity.get(cloud)
            if cap is not None and n > cap:
                raise ValueError(
                    f"min_replicas on {cloud!r} total {n} > capacity {cap}")

        # gateway:run is recorded AFTER the loop with the SIMULATED makespan
        # as its duration (wall_s meta carries the real wall), so dump()
        # stays byte-stable under a fixed seed
        _wall0 = time.perf_counter()
        if engine == "vector":
            self._run_vector(st, events)
        else:
            self._run_scalar(st, events)
        _wall_s = time.perf_counter() - _wall0
        n_req = int(sum(len(x.arr) for x in st.values()))
        # vector-mode arrivals never enter the heap but are simulator
        # events all the same -- count them so events/sec is comparable
        sim_events = events.n_popped + (n_req if engine == "vector" else 0)
        self.run_stats = {
            "engine": engine, "requests": n_req, "sim_events": sim_events,
            "wall_s": _wall_s,
            "events_per_s": sim_events / _wall_s if _wall_s > 0 else 0.0,
            "requests_per_s": n_req / _wall_s if _wall_s > 0 else 0.0}

        results, cold, costs, makespan = {}, {}, {}, 0.0
        totals: dict[str, float] = {}
        for m, s in st.items():
            if not len(s.arr):           # deployed but untrafficked: holds
                continue                 # capacity, reports no results
            n_shed = int(s.shed.sum())
            if s.served + n_shed < len(s.arr):
                raise RuntimeError(
                    f"gateway stalled: {m} served {s.served} + shed "
                    f"{n_shed} of {len(s.arr)}")
            keep = ~s.shed
            totals[m] = (float((s.arr[keep] + s.lat[keep]).max())
                         if keep.any() else 0.0)
            makespan = max(makespan, totals[m])
        self.log.record("gateway:run", makespan, models=sorted(by_model),
                        n=n_req, wall_s=_wall_s)
        for m, s in st.items():
            # bill surviving replicas to the fleet's last completion, not to
            # the last event (replicas retired after the makespan already
            # billed their real idle-out time)
            for pool in s.pools.values():
                for r in pool.replicas.values():
                    pool.replica_seconds += max(makespan - r.created_s, 0.0)
            costs[m] = sum(self._pool_costs(s).values())
            self.final_weights[m] = self._norm_weights(s)
            if m in totals:
                results[m] = self._result(s, totals[m])
                cold[m] = s.cold_starts
        return GatewayResult(results, cold, makespan, costs)

    def _run_scalar(self, st: dict, events: EventHeap) -> None:
        """Per-request reference loop: every arrival is a heap event."""
        while events:
            t = events.peek_t()
            step = _Step()
            # apply every state change at time t before dispatching so a
            # burst admits as full batches; idle expiries run last so a
            # coincident arrival wins the replica instead of forcing a
            # retire + cold start
            while events and events.peek_t() == t:
                kind, m, data = events.pop()
                self._apply_event(st, t, kind, m, data, events, step)
            self._finish_timestep(st, t, events, step)

    def _run_vector(self, st: dict, events: EventHeap) -> None:
        """Vectorized loop: arrivals live in the sorted ledger columns and
        are consumed by per-model cursors.  Between heap events, whole
        arrival spans bulk-append to their (single) live pool when the
        attention predicate proves every skipped timestep-end a no-op;
        any timestep the predicate cannot clear runs through the exact
        same _apply_event/_finish_timestep code as the scalar engine.

        Ordering matches the scalar engine by construction: there,
        arrivals are pushed first at init (models in deploy order, rows
        ascending), so at any shared timestamp they pop before every
        other event -- here they are processed first explicitly, in the
        same model/row order, before the heap events at that time."""
        models = [m for m, s in st.items() if len(s.arr)]
        bulk_ok = self.admission is None   # per-row admit decisions (and
        # their shed side effects) force the per-row path
        while True:
            t_arr = _INF
            for m in models:
                s = st[m]
                if s.cursor < len(s.arr):
                    ta = float(s.arr[s.cursor])
                    if ta < t_arr:
                        t_arr = ta
            t_ev = events.peek_t()
            t = min(t_arr, t_ev)
            if t == _INF:
                break
            if bulk_ok and t_arr < t_ev:
                # silent span: every arrival strictly before t_cut only
                # appends to its queue -- dispatch, autoscale, logging all
                # provably idle until then
                t_cut = t_ev
                for m in models:
                    s = st[m]
                    if s.cursor < len(s.arr):
                        att = self._attention_time(s)
                        if att < t_cut:
                            t_cut = att
                if t_cut > t_arr:
                    for m in models:
                        s = st[m]
                        lo = s.cursor
                        if lo >= len(s.arr) or float(s.arr[lo]) >= t_cut:
                            continue
                        hi = lo + int(np.searchsorted(s.arr[lo:], t_cut,
                                                      side="left"))
                        self._bulk_append(s, lo, hi, self._route(s, lo))
                        s.cursor = hi
                    continue
            # one full timestep at t: arrivals first (scalar pop order),
            # then the heap events due now, then the shared step tail
            step = _Step()
            for m in models:
                s = st[m]
                lo, n = s.cursor, len(s.arr)
                if lo >= n or float(s.arr[lo]) != t:
                    continue
                hi = lo + int(np.searchsorted(s.arr[lo:], t, side="right"))
                live = sum(1 for p in s.pools.values() if p.weight > 0)
                if bulk_ok and live <= 1:
                    # routing is pinned (single live pool) and admission is
                    # off: the whole same-t burst appends in one extend
                    self._bulk_append(s, lo, hi, self._route(s, lo))
                else:
                    for i in range(lo, hi):
                        self._arrive(s, i, t)
                s.cursor = hi
                step.touched.add(m)
            while events and events.peek_t() == t:
                kind, m, data = events.pop()
                self._apply_event(st, t, kind, m, data, events, step)
            self._finish_timestep(st, t, events, step)

    def _attention_time(self, s: _ModelState) -> float:
        """Earliest pending-arrival time at which this model might do
        anything beyond appending one request to one queue.  Conservative
        by design: flagging a harmless timestep only costs the slow path,
        while the span skip is valid exactly when every skipped
        timestep-end (dispatch + autoscale) is a no-op -- the caller
        already guarantees admission is off."""
        arr = s.arr
        now = float(arr[s.cursor])
        live = [p for p in s.pools.values() if p.weight > 0]
        if len(live) != 1:
            # multi-pool: queue-aware routing shifts per request
            return now
        pool = live[0]
        for p in s.pools.values():
            if p is not pool and p.queue_len():
                return now               # a foreign queue could dispatch
        size = pool.size()
        if size == 0:
            return now                   # scale-from-zero fires immediately
        if any(not r.busy for r in pool.replicas.values()):
            return now                   # an idle replica would dispatch
        if any(c.preempts for c in s.classes) and any(
                r.busy for r in pool.replicas.values()):
            return now                   # arrival could preempt a batch
        cfg = s.dep.autoscaler.cfg
        budget = max(cfg.max_replicas, cfg.min_replicas)
        if (size < cfg.max_replicas and size < self._pool_cap(s, pool)
                and s.total_pool() < budget):
            # queue-pressure crossing: the k-th appended request tips
            # scale_up_needed (q0 + k > target_queue * size)
            need = math.floor(cfg.target_queue * max(size, 1)
                              - pool.queue_len()) + 1
            if need <= 0:
                return now
            k = s.cursor + need - 1
            if k < len(arr):
                return float(arr[k])
        return _INF

    def _bulk_append(self, s: _ModelState, lo: int, hi: int,
                     pool: _Pool) -> None:
        """Append ledger rows [lo, hi) to ``pool``'s pending queues in row
        (= arrival) order: the vectorized equivalent of per-row _arrive
        when routing is pinned to one pool and admission is off."""
        if hi <= lo:
            return
        nc = len(s.classes)
        if s.combo_rows is None:
            # the class/version columns are immutable after init, so the
            # per-combo row lists are computed once and every later span
            # split is two searchsorteds + one slice per combo present
            combo_full = s.ver * nc + s.cls_code
            s.combo_rows = {int(c): np.flatnonzero(combo_full == c)
                            for c in np.unique(combo_full)}
        if len(s.combo_rows) == 1:
            # the common case: one class, one version -> one extend
            code = next(iter(s.combo_rows))
            key = (code // nc, s.classes[code % nc].name)
            pool.pending.setdefault(key, IndexQueue()).extend(range(lo, hi))
            return
        # queues are created (and a mixed span appended) in first-row
        # order, so the pending-dict key order matches the scalar engine's
        present = []
        for code, rows_c in s.combo_rows.items():
            a = int(np.searchsorted(rows_c, lo))
            b = int(np.searchsorted(rows_c, hi))
            if b > a:
                present.append((int(rows_c[a]), code, rows_c, a, b))
        present.sort()
        for _, code, rows_c, a, b in present:
            key = (code // nc, s.classes[code % nc].name)
            pool.pending.setdefault(key, IndexQueue()).extend(
                rows_c[a:b].tolist())

    def _arrive(self, s: _ModelState, i: int, t: float) -> None:
        pool = self._route(s, i)
        if self._admit(s, pool, i, t):
            key = (int(s.ver[i]), s.slo(i).name)
            pool.pending.setdefault(key, IndexQueue()).append(i)

    def _apply_event(self, st: dict, t: float, kind: str, m: str, data,
                     events: EventHeap, step: _Step) -> None:
        s = st[m]
        if kind == "arr":                # scalar engine only
            self._arrive(s, data, t)
            step.touched.add(m)
        elif kind == "up":
            pool = s.pools[data]
            pool.scheduled_up -= 1
            pool.replicas[s.next_rid] = _Replica(
                s.next_rid, warm=not s.dep.autoscaler.cfg.cold_scale_up,
                last_active=t, created_s=t)
            if s.dep.autoscaler.tracks_idle:
                # a replica that joins after the queue drained
                # would otherwise never get an idle check
                events.push(t + s.dep.autoscaler.cfg.idle_window_s,
                            "idle", m, (data, s.next_rid, t))
            s.next_rid += 1
            step.touched.add(m)
        elif kind == "free":
            cloud, rid, epoch = data
            pool = s.pools[cloud]
            r = pool.replicas.get(rid)
            if r is not None and r.epoch == epoch:
                # real completion (preempted batches bumped the epoch)
                r.busy = False
                r.inflight = None
                r.last_active = t
                if s.dep.autoscaler.tracks_idle:
                    events.push(t + s.dep.autoscaler.cfg.idle_window_s,
                                "idle", m, (cloud, rid, t))
                step.touched.add(m)
        else:                            # "idle"
            step.idle_checks.append((m, data))

    def _finish_timestep(self, st: dict, t: float, events: EventHeap,
                         step: _Step) -> None:
        """The shared tail of one timestep: dispatch + autoscale for every
        touched model, then idle expiries."""
        # sorted: set order depends on PYTHONHASHSEED, and which model
        # dispatches first decides shared-capacity races
        for m in sorted(step.touched):
            self._dispatch(st[m], t, events)
            self._autoscale(st[m], t, events, st)
        for m, payload in step.idle_checks:
            self._maybe_retire(st[m], t, payload, st)

    def _result(self, s: _ModelState, total: float) -> ServeResult:
        dep = s.dep
        # REPORTED deadline base: the warm single-request path on the
        # PRIMARY cloud, the deployment-level promise per_class() publishes
        # (a request served by a slower split cloud that beats that cloud's
        # own path but not the primary's still counts as a miss here); the
        # in-run shedder is per-pool (_pool_base) -- DESIGN.md S3
        base = s.deadline_base
        # shed requests are excluded exactly once: reported via class_shed,
        # never in the latency percentiles
        keep = ~s.shed
        lats_arr = s.lat[keep]
        codes = s.cls_code[keep]
        lats = lats_arr.tolist()
        cls_lats: dict[str, list] = {}
        cls_miss: dict[str, int] = {}
        for code, c in enumerate(s.classes):
            mask = codes == code
            if not mask.any():
                continue
            vals = lats_arr[mask]
            cls_lats[c.name] = vals.tolist()
            miss = int((vals > c.deadline_mult * base).sum())
            if miss:
                cls_miss[c.name] = miss
        n = len(s.arr)
        window = float(s.arr.max() - s.arr.min()) if n > 1 else 0.0
        if window <= 1e-9:
            # pure burst: estimate the offered window as the (collapsed)
            # arrival span plus ONE mean service interval (the whole run
            # span would count drain time and under-report the burst's rate)
            gap = (s.busy_s / s.served if s.served
                   else max(total - float(s.arr.min()), 1e-9))
            window = max(window + gap, 1e-9)
            rate = n / window
        else:
            # n arrivals span n-1 inter-arrival gaps
            rate = (n - 1) / window
        observed = {"rate_rps": rate,
                    "service_time_s": s.busy_s / max(s.served, 1),
                    "window_s": window, "n": n,
                    "shed": int(s.shed.sum())}
        self.log.record("gateway:observed", 0.0, model=dep.name,
                        rate_rps=round(observed["rate_rps"], 4),
                        service_time_s=round(observed["service_time_s"], 8),
                        n=n, shed=observed["shed"])
        cost_by_cloud = self._pool_costs(s)
        return ServeResult(f"gateway:{dep.name}", n, total, lats,
                           s.trace, per_version=s.per_version,
                           class_latencies=cls_lats, class_misses=cls_miss,
                           class_shed=dict(s.class_shed),
                           observed=observed,
                           cost_usd=sum(cost_by_cloud.values()),
                           cost_by_cloud=cost_by_cloud)

    @staticmethod
    def _pool_costs(s: _ModelState) -> dict:
        """Simulated dollars per cloud: provisioned replica-seconds priced
        by the profile sheet.  The ONE formula behind both
        GatewayResult.costs and ServeResult.cost_by_cloud."""
        return {c: p.replica_seconds * p.profile.cost_per_s
                for c, p in s.pools.items() if p.replica_seconds > 0}

    # -- split routing ------------------------------------------------------
    @staticmethod
    def _norm_weights(s: _ModelState) -> dict:
        total = sum(p.weight for p in s.pools.values())
        if total <= 0:
            return {c: 0.0 for c in s.pools}
        return {c: p.weight / total for c, p in s.pools.items()}

    def _pool_base(self, s: _ModelState, pool: _Pool) -> float:
        """This POOL's warm single-request path (rtt + lb + svc(1)) -- the
        deadline base for in-run shedding (charging every pool against the
        PRIMARY's warm path would shed a slow split cloud's requests against
        a deadline it can never meet).  Cached lazily."""
        cloud = pool.profile.name
        base = s.base_by_cloud.get(cloud)
        if base is None:
            base = s.base_by_cloud[cloud] = (
                pool.profile.network_rtt_s + pool.profile.lb_overhead_s
                + s.svc1)
        return base

    def _expected_wait(self, s: _ModelState, pool: _Pool) -> float:
        """Expected seconds until a request joining ``pool`` NOW completes:
        queue depth x amortized service estimate over the pool's replicas,
        plus the cloud's rtt/lb constants, plus cold-start risk: a pool
        with NO replicas must first spin one up (control-plane delay +
        model load).  A provisioned-but-cold pool is NOT penalized -- its
        model_load_s is a one-time cost the first batch amortizes.  A
        deployment-supplied queue_hint (planner prior) floors the wait
        while the pool has no queue of its own.  A coarse ranking estimate,
        deliberately -- the simulation is the ground truth; this only has
        to order pools and spot hopeless deadlines."""
        size = pool.size()
        wait = (pool.queue_len() + 1) * s.svc_est / max(size, 1)
        if pool.queue_len() == 0:
            wait = max(wait, s.dep.queue_hint.get(pool.profile.name, 0.0))
        e = wait + pool.profile.network_rtt_s + pool.profile.lb_overhead_s
        if size == 0:
            e += (s.dep.autoscaler.cfg.scale_up_delay_s
                  + pool.profile.model_load_s)
        return e

    def _route(self, s: _ModelState, i: int) -> _Pool:
        """Blended queue-aware routing (RoutingConfig): live pools within
        ``slack`` of the best expected completion form the candidate band;
        the request's pre-drawn uniform resolves a weighted draw over the
        band (declared pool order), so a fixed seed stays bit-for-bit
        deterministic however queues move.  policy="weights" skips the band
        (pure weighted draw)."""
        live = [(c, p) for c, p in s.pools.items() if p.weight > 0]
        total = sum(p.weight for _, p in live)
        if self.routing.policy == "queue_aware" and len(live) > 1:
            scored = [(self._expected_wait(s, p), c, p) for c, p in live]
            band = (min(e for e, _, _ in scored)
                    * (1.0 + self.routing.slack) + 1e-12)
            live = [(c, p) for e, c, p in scored if e <= band]
            total = sum(p.weight for _, p in live)
        u = float(s.route_u[i]) * total
        acc = 0.0
        for c, p in live:
            acc += p.weight
            if u < acc:
                return p
        return live[-1][1]

    # -- admission control (shedding) ---------------------------------------
    def _admit(self, s: _ModelState, pool: _Pool, i: int, t: float) -> bool:
        """Enqueue-time admission: shed the request (exactly once) when its
        expected completion already exceeds margin x the class deadline,
        measured against the SERVING pool's own warm path."""
        adm = self.admission
        if adm is None:
            return True
        c = s.slo(i)
        if not c.sheddable or not math.isfinite(c.deadline_mult):
            return True
        deadline = adm.margin * c.deadline_mult * self._pool_base(s, pool)
        if t + self._expected_wait(s, pool) <= float(s.arr[i]) + deadline:
            return True
        self._shed(s, pool, i, t, where="enqueue")
        return False

    def _shed(self, s: _ModelState, pool: _Pool, i: int, t: float, *,
              where: str) -> None:
        c = s.slo(i)
        s.shed[i] = True
        s.class_shed[c.name] = s.class_shed.get(c.name, 0) + 1
        pool.shed_pressure += 1
        self.log.record("gateway:shed", 0.0, model=s.dep.name,
                        cloud=pool.profile.name, cls=c.name, idx=int(i),
                        t_sim=round(t, 6), at=where)

    def _prune_hopeless(self, s: _ModelState, pool: _Pool, t: float) -> None:
        """Dispatch-time re-check: shed queued requests whose BEST-CASE
        completion (dispatched right now, warm, batch of one) already
        breaches margin x deadline.  Queues are FIFO by arrival, so the
        hopeless requests form a prefix."""
        adm = self.admission
        if adm is None or not adm.recheck_at_dispatch:
            return
        base = self._pool_base(s, pool)
        best = t + base                  # rtt + lb + svc(1) from now
        for key in list(pool.pending):
            q = pool.pending[key]
            if not q:
                continue
            c = s.slo_by_name[key[1]]
            if not c.sheddable or not math.isfinite(c.deadline_mult):
                continue
            deadline = adm.margin * c.deadline_mult * base
            while q and best > float(s.arr[q.peek()]) + deadline:
                self._shed(s, pool, q.popleft(), t, where="dispatch")

    # -- dispatch -----------------------------------------------------------
    def _best_queue(self, s: _ModelState, pool: _Pool, keys: list,
                    t: float) -> tuple:
        """Class-weighted age: serve the queue maximizing weight * age of
        its oldest request; ties fall to weight then earliest arrival."""
        def rank(k):
            q = pool.pending[k]
            w = s.slo_by_name[k[1]].weight
            head = q.peek()
            return (w * (t - float(s.arr[head])), w, -head)
        return max(keys, key=rank)

    def _dispatch(self, s: _ModelState, t: float, events: EventHeap) -> None:
        for pool in s.pools.values():
            if pool.queue_len():
                self._dispatch_pool(s, pool, t, events)

    def _dispatch_pool(self, s: _ModelState, pool: _Pool, t: float,
                       events: EventHeap) -> None:
        self._prune_hopeless(s, pool, t)
        while True:
            keys = [k for k, q in pool.pending.items() if q]
            if not keys:
                return
            idle = [r for r in pool.replicas.values() if not r.busy]
            if idle:
                key = self._best_queue(s, pool, keys, t)
                r = min(idle, key=lambda x: x.rid)
            else:
                pkeys = [k for k in keys if s.slo_by_name[k[1]].preempts]
                if not pkeys:
                    return
                key = self._best_queue(s, pool, pkeys, t)
                w = s.slo_by_name[key[1]].weight
                # strict weight order prevents preemption livelock (a class
                # can never evict work of its own or a higher class)
                victims = [r for r in pool.replicas.values()
                           if r.busy and r.inflight is not None
                           and r.inflight["slo"].preemptible
                           and r.inflight["slo"].weight < w]
                if not victims:
                    return
                # evict the batch with the most remaining work (least sunk)
                r = max(victims, key=lambda x: (x.inflight["done"], x.rid))
                n_back = self._reclaim(s, pool, r, t)
                self.log.record("gateway:preempt", 0.0, model=s.dep.name,
                                t_sim=round(t, 6), rid=r.rid, requeued=n_back,
                                by=key[1], cloud=pool.profile.name)
            self._assign(s, pool, r, key, t, events)

    def _assign(self, s: _ModelState, pool: _Pool, r: _Replica, key: tuple,
                t: float, events: EventHeap) -> None:
        dep = s.dep
        v, cname = key
        take = pool.pending[key].take(dep.max_batch)
        cold = 0.0
        if not r.warm:
            cold = pool.profile.model_load_s
            r.warm = True
            s.cold_starts += 1
            self.log.record("gateway:cold_start", cold, model=dep.name,
                            cloud=pool.profile.name, t_sim=round(t, 6))
        backend = dep.backends[v]
        b = len(take)
        svc = backend.service_time(b)
        done = (t + pool.profile.network_rtt_s + pool.profile.lb_overhead_s
                + cold + svc)
        idx = np.fromiter(take, np.intp, b)
        s.lat[idx] = done - s.arr[idx]
        s.served += b
        s.per_version[backend.name] = s.per_version.get(backend.name, 0) + b
        s.busy_s += svc
        r.busy = True
        r.last_active = done
        r.epoch += 1
        rec = None
        if self.record_batches:
            rec = {"model": dep.name, "rid": r.rid,
                   "cloud": pool.profile.name,
                   "cls": cname, "version": v, "idx": tuple(take),
                   "start_s": t, "end_s": done, "preempted": False,
                   "rtt_lb_s": pool.profile.network_rtt_s
                   + pool.profile.lb_overhead_s,
                   "cold_s": cold, "service_s": svc}
            self.batch_log.append(rec)
        r.inflight = {"idx": take, "v": v, "cls": cname,
                      "slo": s.slo_by_name[cname], "backend": backend.name,
                      "service_s": svc, "done": done, "record": rec}
        events.push(done, "free", dep.name,
                    (pool.profile.name, r.rid, r.epoch))

    def _reclaim(self, s: _ModelState, pool: _Pool, r: _Replica,
                 t: float) -> int:
        """Undo an in-flight batch (SLO preemption): requests re-queue with
        their original arrival times, so they complete exactly once when
        re-dispatched.  Request index order IS arrival order (arrivals are
        sorted at init), so a sorted merge restores the queue's FIFO
        invariant."""
        fl = r.inflight
        take = fl["idx"]
        key = (fl["v"], fl["cls"])
        old = pool.pending.get(key)
        pool.pending[key] = IndexQueue(
            sorted(take + (list(old) if old else [])))
        s.lat[take] = -1.0
        s.served -= len(take)
        s.per_version[fl["backend"]] -= len(take)
        s.busy_s -= fl["service_s"]
        if fl["record"] is not None:     # the serve attempt is abandoned
            fl["record"]["end_s"] = t
            fl["record"]["preempted"] = True
        r.busy = False
        r.inflight = None
        r.epoch += 1                     # invalidate the scheduled "free"
        r.last_active = t
        return len(take)

    # -- scaling ------------------------------------------------------------
    def _pool_cap(self, s: _ModelState, pool: _Pool) -> int:
        """Max replicas this pool may hold: its ceil-share of max_replicas
        by weight (a pool holding ALL the traffic gets the whole budget),
        never below its floor."""
        total = sum(p.weight for p in s.pools.values())
        if pool.weight <= 0 or total <= 0:
            return pool.floor
        cfg = s.dep.autoscaler.cfg
        cap = max(cfg.max_replicas, cfg.min_replicas)
        return max(math.ceil(cap * pool.weight / total), pool.floor)

    def _autoscale(self, s: _ModelState, t: float, events: EventHeap,
                   st) -> None:
        cfg = s.dep.autoscaler.cfg
        budget = max(cfg.max_replicas, cfg.min_replicas)
        for pool in s.pools.values():
            # shed-pressure counts as queue depth: demand that admission
            # control dropped is still demand, and must drive scale-up
            # rather than be masked by the now-short queue
            q = s.dep.autoscaler.effective_queue(pool.queue_len(),
                                                 pool.shed_pressure)
            if q > 0 and pool.size() == 0:   # scale from zero: spin up one
                if s.total_pool() >= budget:
                    # queued work is pinned to THIS pool, so starving it
                    # would stall the run: breach the deployment budget
                    # loudly instead
                    self.log.record("gateway:budget_exceeded", 0.0,
                                    model=s.dep.name,
                                    cloud=pool.profile.name,
                                    t_sim=round(t, 6))
                self._launch(s, pool, t, events, st, from_zero=True)
                continue
            # at most ONE launch per pool per evaluation (KPA rate-limits
            # scale-up); per-pool ceil-share caps may SUM over the budget,
            # so the deployment total is enforced here too
            if (s.dep.autoscaler.scale_up_needed(q, pool.size())
                    and pool.size() < self._pool_cap(s, pool)
                    and s.total_pool() < budget):
                self._launch(s, pool, t, events, st)

    def _cloud_usage(self, st, cloud: str) -> int:
        return sum(p.size() for x in st.values()
                   for c, p in x.pools.items() if c == cloud)

    def _note_usage(self, st, cloud: str, t: float) -> None:
        if self.record_batches:
            self.usage_trace.append((t, cloud, self._cloud_usage(st, cloud)))

    def _launch(self, s: _ModelState, pool: _Pool, t: float,
                events: EventHeap, st, *, from_zero: bool = False) -> bool:
        cloud = pool.profile.name
        cap = self.capacity.get(cloud)
        if cap is not None and self._cloud_usage(st, cloud) >= cap:
            if not from_zero:
                self.log.record("gateway:scale_denied", 0.0,
                                model=s.dep.name, cloud=cloud,
                                t_sim=round(t, 6), reason="capacity")
                return False
            # a pool at size 0 would starve forever if every other pool
            # on this cloud is warm-pinned: serve over budget, loudly
            self.log.record("gateway:capacity_exceeded", 0.0,
                            model=s.dep.name, cloud=cloud,
                            t_sim=round(t, 6))
        delay = s.dep.autoscaler.cfg.scale_up_delay_s
        pool.scheduled_up += 1
        pool.shed_pressure = 0           # the overload signal did its job
        s.trace.append((t, s.total_pool()))
        self._note_usage(st, cloud, t)
        events.push(t + delay, "up", s.dep.name, cloud)
        self.log.record("gateway:scale_up", delay, model=s.dep.name,
                        t_sim=round(t, 6), pool=s.total_pool(), cloud=cloud,
                        from_zero=from_zero)
        return True

    def _retire(self, s: _ModelState, pool: _Pool, r: _Replica, t: float,
                st) -> None:
        pool.replica_seconds += max(t - r.created_s, 0.0)
        del pool.replicas[r.rid]
        s.trace.append((t, s.total_pool()))
        self._note_usage(st, pool.profile.name, t)
        self.log.record("gateway:scale_down", 0.0, model=s.dep.name,
                        t_sim=round(t, 6), pool=s.total_pool(),
                        cloud=pool.profile.name)
        if s.total_pool() == 0:
            self.log.record("gateway:scale_to_zero", 0.0, model=s.dep.name,
                            t_sim=round(t, 6))

    def _maybe_retire(self, s: _ModelState, t: float, payload, st) -> None:
        cloud, rid, stamp = payload
        pool = s.pools[cloud]
        r = pool.replicas.get(rid)
        if r is None or r.busy or r.last_active > stamp:
            return                       # reused since the check was scheduled
        if not s.dep.autoscaler.can_remove(pool.size(), pool.floor):
            return
        self._retire(s, pool, r, t, st)
