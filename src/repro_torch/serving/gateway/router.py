"""Model-mesh serving gateway: the port's copy of
``repro.serving.gateway.router``, under the reference's names.  One router
fronts MANY models, each of which may be ACTIVE-ACTIVE across several
clouds at once.

A Gateway owns per-model Deployments -- each a
backend (Predictor or BatcherBackend), one replica pool PER CLOUD
(``{cloud: _Pool}``), a weighted traffic split over those pools, and an
Autoscaler -- and runs a mixed multi-model workload (per-model burst /
Poisson TrafficSpecs) through ONE discrete-event simulation with shared
per-cloud replica capacity.

The simulation contract is the repo-wide hardware gate (DESIGN.md):
compute service times are MEASURED (``Predictor.service_time`` times real
predicts per pow2 batch bucket and waits for the card before it reads the
clock; ``BatcherBackend`` drains real requests through the batcher);
network RTT / load-balancer / model-load constants are SIMULATED from the
CloudProfile.  The router itself is plain Python and numpy and meets model
compute only through a backend's ``.name`` and ``.service_time(b)``.
InferenceService (serving/kserve.py) is a single-model client of this
router, so the paper's Table-3 stress test and the fleet simulation share
one event loop.

Splits (DESIGN.md S3): a Deployment carries per-cloud traffic weights
(``deploy(split={profile: weight})``; a plain ``profile`` is the
degenerate one-entry split).  Each arrival is routed to a pool by a
seeded uniform draw against the LIVE weights, each pool keeps its own
queues / replicas / epochs, and every latency is charged with that
pool's cloud constants.  Weights move mid-run three ways, all through
one primitive (``_set_weights``, drain-and-shift, exactly-once):

- ``gw.run(migrations=[MigrationSpec(at_s, plan)])`` applies a
  placement.MigrationPlan live (``gateway:migrate reason=plan``);
- a ReplanConfig on the Gateway probes the fleet periodically and shifts
  weight off a pool that is overloaded-but-blocked (or missing
  deadlines) toward the CHEAPEST cloud with headroom, and consolidates
  an idle fleet off its most expensive cloud (``gateway:migrate`` with
  reason overload / miss_rate / cost);
- a FailureSpec outage is a degenerate split: the dead cloud's weight
  drops to 0 (``gateway:failover``), survivors -- or the zero-weight
  standby pool -- absorb the traffic, and recovery restores the nominal
  weights (``gateway:recover``).  There is no separate failover code
  path.

Queue-aware routing (DESIGN.md S3): with the default
``RoutingConfig(policy="queue_aware")`` the split weights only set the
BIAS.  Each arrival scores every live pool with an expected-completion
estimate (queue depth x amortized service estimate + RTT/LB + cold-start
risk + scale-from-zero delay), keeps the pools within a slack band of the
best score, and resolves the request's pre-drawn uniform against the
declared weights of that band -- weighted join-shortest-expected-queue.  A
pool drowning in backlog falls out of the band and stops receiving
traffic until it drains; with balanced queues the band holds every live
pool and routing degenerates to the pure weighted draw
(``policy="weights"``, kept for A/B racing).

Admission control (Gateway(admission=AdmissionConfig(...)), off by
default): at enqueue -- and again at dispatch -- a request whose expected
completion already exceeds ``margin x`` its class deadline (measured
against the SERVING pool's own warm path, not the primary's) is SHED
exactly once: dropped with a ``gateway:shed`` event, counted per class in
ServeResult/GatewayResult, excluded from latency percentiles.  Classes
with ``sheddable=False`` (batch) or an infinite deadline are never shed,
only deferred.  Shedding is an overload signal, not a mask: each shed
adds pool shed-pressure that the autoscaler reads as queue depth (so a
shedding pool scales up / from zero) and ReplanConfig probes treat a
window shed-rate breach like a deadline-miss breach (weight shifts away,
``gateway:migrate reason=shed_rate``).

SLO layer (DESIGN.md S3): every request carries an SLOClass
(latency / standard / batch).  Dispatch serves the queue maximizing
``weight * age-of-oldest`` instead of longest-queue; a ``latency`` batch
may preempt an in-flight ``batch`` batch (the victim re-queues,
gateway:preempt).

Event kinds: "arr" request arrival, "up" replica joins a pool after the
control-plane delay, "free" replica finishes a batch, "idle" idle-window
expiry check (scale-down / scale-to-zero, autoscaler.py), "fail"/"recover"
FailureSpec window edges, "replan" a MigrationSpec firing, "probe" an
auto-replan check.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ...clouds.profiles import CloudProfile, get_profile
from ...sim.engine import EventHeap, IndexQueue, Ledger
from ...telemetry.drift import DriftConfig, DriftMonitor
from ...telemetry.events import EventLog
from ...telemetry.metrics import MetricsRegistry
from ...telemetry.slo import BurnRateConfig, BurnRateMonitor
from ...telemetry.trace import Tracer
from .autoscaler import Autoscaler, AutoscalerConfig, PoolView
from .placement import MigrationStep


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

    policy="weights": the pure weighted draw, kept for A/B
    comparison (bench_gateway races the two) and share-exact tests.
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


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """A simulated cloud outage: ``cloud`` is down over
    [at_s, at_s + duration_s).  Injected via Gateway.run(failures=[...])."""
    cloud: str
    at_s: float
    duration_s: float

    def __post_init__(self):
        if self.at_s < 0 or self.duration_s <= 0:
            raise ValueError("FailureSpec needs at_s >= 0 and duration_s > 0")


@dataclasses.dataclass(frozen=True)
class MigrationSpec:
    """Apply a placement.MigrationPlan (or a raw ``{model: {cloud:
    weight}}`` dict) at simulated time ``at_s``, mid-run, without dropping
    requests.  Injected via Gateway.run(migrations=[...])."""
    at_s: float
    plan: Any

    def __post_init__(self):
        if self.at_s < 0:
            raise ValueError("MigrationSpec needs at_s >= 0")


@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    """Continuous re-planning knobs (Gateway(replan=...)).  Every
    ``check_every_s`` of simulated time the router probes each model:

    - a pool whose queue (plus its shed-pressure: requests admission
      control dropped since the last probe/launch) exceeds
      ``overload_factor * target_queue * replicas`` while its cloud can no
      longer grow, or a model whose recent deadline-miss rate breaches
      ``max_miss_rate`` (over at least ``min_window_n`` completions), or
      whose window shed rate breaches ``max_shed_rate`` (shedding is an
      overload signal, never a mask), sustained for ``sustain``
      consecutive probes, shifts ``shift`` of the hottest pool's weight
      toward the cheapest cloud with headroom (gateway:migrate);
    - with ``consolidate``, a fully idle multi-cloud split sustained for
      ``sustain`` probes folds its most expensive pool into the cheapest
      one (weight -> 0, so the expensive replicas idle out first).
    """
    check_every_s: float = 0.25
    overload_factor: float = 2.0
    max_miss_rate: float = 0.5
    max_shed_rate: float = 0.1
    min_window_n: int = 8
    shift: float = 0.5
    sustain: int = 2
    consolidate: bool = True

    def __post_init__(self):
        if self.check_every_s <= 0:
            raise ValueError("check_every_s must be > 0")
        if not 0 < self.max_shed_rate <= 1:
            raise ValueError("max_shed_rate must be in (0, 1]")
        if not 0 < self.shift <= 1:
            raise ValueError("shift must be in (0, 1]")
        if self.sustain < 1:
            raise ValueError("sustain must be >= 1")
        if self.min_window_n < 1:     # also guards the miss-rate division
            raise ValueError("min_window_n must be >= 1")


# -- results / backends (moved from kserve.py; it re-exports them) ----------

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
    # class / shed-everything pools): 0.0 read as "perfect latency" and was
    # indistinguishable from an actually-instant pool.  _class_stats and
    # the bench schema carry the same convention.
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


# the self-rescheduling event kinds: once no work is left and only these
# remain, the periodic probe / scrape timers must stop re-arming --
# re-pushing while "events is non-empty" would let the two timers sustain
# EACH OTHER through an unbounded dead tail after the last request
# completes.  Pending "idle" checks deliberately keep the timers alive:
# they are one-shot (never re-pushed), so the tail is bounded by the idle
# window, and the probe must stay armed through it for post-traffic cost
# consolidation (idle split folds onto the cheap cloud, stragglers retire).
# The rule itself lives in the shared sim core (EventHeap.only_timers);
# this is the gateway's timer vocabulary.
_TIMER_KINDS = frozenset(("probe", "scrape"))

_INF = float("inf")


class _Step:
    """Mutable per-timestep scratch shared by both engines: which models
    saw state changes (dispatch/autoscale run once per touched model at
    the end of the step), deferred idle checks, and due timer flags."""

    __slots__ = ("touched", "idle_checks", "probe_due", "scrape_due")

    def __init__(self):
        self.touched: set = set()
        self.idle_checks: list = []
        self.probe_due = False
        self.scrape_due = False


def _apportion(total: int, weights: dict) -> dict:
    """Largest-remainder split of ``total`` replicas by weight (zero-weight
    pools get zero); deterministic tie-break by remainder, weight, name.

    Whenever ``total >= len(live)`` every live-weight pool is guaranteed at
    least one replica: a 0.95/0.05 split at total=2 must not floor the 0.05
    pool at ZERO replicas while routing still sends it traffic, parking
    those requests until the autoscaler notices."""
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
class DisaggSpec:
    """Opt-in prefill/decode disaggregation for one deployment (DESIGN.md
    §7).  All gateway disagg machinery -- pool kinds, KV-block
    accounting, the cache-residency routing term, cache-exhaustion
    shedding -- is DORMANT unless a deployment carries one of these.

    ``kv_blocks`` budgets KV-cache blocks per pool (an int for every pool
    or {cloud: blocks}; 0 = unaccounted).  A request holds
    ``ceil((prompt_tokens + gen_tokens) / block_size)`` blocks from
    dispatch to completion of its phase.  ``pool_kind`` assigns each cloud
    "prefill" / "decode" / "both" (default "both" = unified pools).  When
    both a "prefill" and a "decode" pool exist the deployment runs STAGED:
    new arrivals route to prefill pools only, a finished prefill batch
    emits ``gateway:prefill`` and re-enqueues its requests on the best
    decode pool (the KV handoff), and request latency is charged at decode
    completion.  ``shed_margin`` scales the block budget admission sheds
    against (``gateway:cache_shed``)."""
    kv_blocks: Any = 0
    block_size: int = 16
    prompt_tokens: int = 64              # expected prompt length / request
    gen_tokens: int = 16                 # expected generated tokens / request
    pool_kind: dict = dataclasses.field(default_factory=dict)
    shed_margin: float = 1.0

    def __post_init__(self):
        if self.block_size <= 0:
            raise ValueError("block_size must be > 0")
        if self.prompt_tokens < 0 or self.gen_tokens <= 0:
            raise ValueError("prompt_tokens must be >= 0, gen_tokens > 0")
        if self.shed_margin <= 0:
            raise ValueError("shed_margin must be > 0")

    @property
    def blocks_per_request(self) -> int:
        return max(1, math.ceil((self.prompt_tokens + self.gen_tokens)
                                / self.block_size))

    def kind(self, cloud: str) -> str:
        return self.pool_kind.get(cloud, "both")

    def blocks_for(self, cloud: str) -> int:
        if isinstance(self.kv_blocks, dict):
            return int(self.kv_blocks.get(cloud, 0))
        return int(self.kv_blocks)


@dataclasses.dataclass
class Deployment:
    name: str
    backend: Any                         # .name + .service_time(b) -> s
    profile: CloudProfile                # primary cloud (deadline base)
    autoscaler: Autoscaler
    max_batch: int = 32
    canary: Any = None
    canary_fraction: float = 0.0
    standby: Optional[CloudProfile] = None   # zero-weight failover pool
    placements: list = dataclasses.field(default_factory=list)
    # [(CloudProfile, weight)]: the declared split, standby appended at 0
    queue_hint: dict = dataclasses.field(default_factory=dict)
    # {cloud: expected queueing wait s} planner prior (Assignment.est_wait_s)
    # used by queue-aware routing while a pool has no queue of its own yet
    trace_link: Optional[int] = None
    # span id of the pipeline deploy step that produced this deployment
    # (telemetry/trace.py): every request root span links to it, connecting
    # the serving trace to the training trace across their sim-time axes
    disagg: Optional[DisaggSpec] = None
    # prefill/decode disaggregation opt-in; None keeps every disagg-free
    # code path bit-identical (the engine-equivalence suites rely on it)

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
    """One per-cloud replica pool of a deployment: its own queues, replicas,
    epochs and launch generation.  ``weight`` is the LIVE traffic share
    (failover zeroes it), ``nominal`` the configured share migrations edit
    and recovery restores, ``floor`` its apportioned slice of min_replicas.
    """

    def __init__(self, profile: CloudProfile, weight: float):
        self.profile = profile
        self.weight = float(weight)
        self.nominal = float(weight)
        self.floor = 0
        self.replicas: dict[int, _Replica] = {}
        self.pending: dict[tuple, IndexQueue] = {}   # FIFO request rows
        self.scheduled_up = 0
        self.generation = 0              # bumps on drain; stale "up" dropped
        self.replica_seconds = 0.0       # provisioned time (simulated $)
        self.shed_pressure = 0           # sheds since the last launch/probe:
        # unmet demand the autoscaler must see as queue depth, so shedding
        # triggers scale-up instead of masking the overload
        self.kind = "both"               # disagg stage(s) this pool serves
        self.handoff_load_s: Optional[float] = None  # warm-handoff cold
        # cost for relaunched replicas (market mode only; None keeps the
        # profile.model_load_s path bit-identical)
        self.handoff_n = 0               # relaunched replicas still owed it
        self.kv_total = 0                # KV block budget (0 = unaccounted)
        self.kv_used = 0                 # blocks held by in-flight batches
        self.kv_resident: dict = {}      # version -> blocks currently held
        self.kv_warm: set = set()        # versions whose cache rows are warm

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
        self.mult_by_code = np.array(
            [c.deadline_mult for c in classes]) if classes else np.zeros(0)
        self.slo_by_name: dict[str, SLOClass] = {c.name: c for c in classes}
        self.cursor = 0                  # vectorized engine: next arrival row
        self.combo_rows: Optional[dict] = None   # lazy: rows per ver x class
        self.pools: dict[str, _Pool] = {}
        for prof, w in dep.placements:
            self.pools[prof.name] = _Pool(prof, w)
        # -- disagg state (dormant unless dep.disagg is set) --
        self.staged = False              # prefill AND decode pools exist
        self.stage: Optional[np.ndarray] = None  # per-request phase (run())
        self.svc_prefill = 0.0           # per-request prompt-ingest estimate
        self.svc_decode = 0.0            # per-batch generation estimate
        self.kv_gauge_inst: dict = {}    # cloud -> cache-occupancy gauge
        if dep.disagg is not None:
            for c, pool in self.pools.items():
                pool.kind = dep.disagg.kind(c)
                pool.kv_total = dep.disagg.blocks_for(c)
            kinds = {p.kind for p in self.pools.values()}
            self.staged = "prefill" in kinds and "decode" in kinds
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
        self.win_n = 0                   # completions since the last probe
        self.win_miss = 0
        self.win_shed = 0                # sheds since the last probe
        self.win_epoch = 0               # bumps on probe reset: a reclaim
        self.streak = {"hot": 0, "cold": 0}   # only undoes its own window
        self.streak_why = "overload"     # what armed the hot streak
        # deferred-telemetry collector state (the sim analog of an async
        # span processor): with a Tracer attached the event loop only
        # appends per-BATCH records here (amortized ~nothing per request)
        # and the span tree is materialized in bulk after the loop; with a
        # MetricsRegistry attached, counters and latency sketches are
        # folded vectorized from the arrays below at each scrape.  All
        # None when untraced, so the bare hot path pays nothing.
        self.batch_recs: Optional[list] = None   # dispatch-order batch dicts
        self.shed_at: dict = {}          # idx -> (t, where, cloud)
        self.fold_pending: Optional[list] = None   # really-completed
        # batches awaiting the next metric fold: (idx, cls, miss threshold)
        self.fold_inst: dict = {}        # cname -> cached instruments
        self.gauge_inst: dict = {}       # cloud -> cached scrape gauges

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
    pool placed on that cloud -- the knob the placement planner
    (placement.py) sizes against.  The cap bounds ELASTIC scale-up
    (over-budget requests are denied and logged gateway:scale_denied);
    run() rejects a configuration whose baseline min_replicas floors
    already exceed it, and a scale-from-zero launch that would otherwise
    starve forever proceeds over budget with a gateway:capacity_exceeded
    event (the K8s analog: the pod pends, then preempts -- we choose
    serve-and-log so the simulation always completes).

    replan: optional ReplanConfig enabling continuous mid-run re-planning
    (periodic probes that shift split weights; see ReplanConfig).

    routing: RoutingConfig -- queue-aware weighted JSQ by default,
    policy="weights" for the pure pre-drawn weighted draw.

    admission: optional AdmissionConfig -- shed requests whose expected
    completion already exceeds their class deadline (None = admit all,
    the legacy behavior InferenceService relies on).

    tracer: optional telemetry.trace.Tracer -- every run opens a
    ``gateway.run`` root span and each request gets a ``gateway.request``
    span with ``gateway.queue`` / ``gateway.serve`` children crossing
    shed, preemption, failover and migration; request roots link to the
    deployment's ``trace_link`` (the pipeline deploy step span).

    metrics: optional telemetry.metrics.MetricsRegistry -- request /
    shed / miss counters, latency histograms (quantile sketches) and, with
    ``scrape_every_s``, periodic simulated-time scrape snapshots of queue
    depth / replicas / accrued cost gauges.

    slo_burn: optional telemetry.slo.BurnRateConfig -- a BurnRateMonitor
    (``self.burn``) watches per-(model, class) error-budget burn, emits
    ``gateway:alert`` events, arms replan probes (reason=slo_burn) and
    adds scale-up pressure via Autoscaler.effective_queue.

    drift: optional telemetry.drift.DriftConfig -- a DriftMonitor
    (``self.drift``) compares each scrape's observed per-request service
    time against the ModelProfile the deployment was planned from
    (``deploy(profile=...)``, threaded through from
    ``DeploySpec.profile``), emits ``profile:drift`` edges, arms
    re-profiling (``modelci:reprofile``) and arms replan probes
    (reason=profile_drift).  Needs ``scrape_every_s``: the scrape loop is
    the monitor's clock.

    record_batches=True keeps a per-batch audit trail (batch_log) and a
    per-cloud usage trace (usage_trace) for the invariant test suite.
    After run(), ``final_weights`` holds each model's normalized live
    split for inspection.
    """

    def __init__(self, *, capacity: Optional[dict] = None,
                 log: Optional[EventLog] = None,
                 replan: Optional[ReplanConfig] = None,
                 routing: Optional[RoutingConfig] = None,
                 admission: Optional[AdmissionConfig] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 slo_burn: Optional[BurnRateConfig] = None,
                 drift: Optional[DriftConfig] = None,
                 scrape_every_s: Optional[float] = None,
                 record_batches: bool = False,
                 shared_capacity=None):
        self.deployments: dict[str, Deployment] = {}
        self.capacity = dict(capacity or {})
        # unified capacity market (clouds/capacity.py): when a
        # CapacityMarket is shared with the Orchestrator, every replica
        # holds a serving lease on its cloud's ledger, scale-ups preempt
        # the youngest training lease (serving priority) and relaunches
        # may pay a state transfer instead of a cold model load.  None
        # (the default) keeps every market-free code path bit-identical.
        self.market = shared_capacity
        if self.market is not None:
            for c, led in self.market.ledgers.items():
                self.capacity.setdefault(c, led.slots)
        self.log = log or EventLog()
        self.replan = replan
        self.routing = routing or RoutingConfig()
        self.admission = admission
        self.tracer = tracer
        self.metrics = metrics
        self.burn = (BurnRateMonitor(slo_burn, log=self.log, metrics=metrics)
                     if slo_burn is not None else None)
        if drift is not None and (scrape_every_s is None or metrics is None):
            raise ValueError("drift detection needs metrics= and "
                             "scrape_every_s=: the scrape loop is the "
                             "monitor's clock")
        self.drift = (DriftMonitor(drift, log=self.log, metrics=metrics)
                      if drift is not None else None)
        if scrape_every_s is not None and scrape_every_s <= 0:
            raise ValueError("scrape_every_s must be > 0")
        self.scrape_every_s = scrape_every_s
        self.record_batches = record_batches
        self.batch_log: list = []        # dicts, one per dispatched batch
        self.usage_trace: list = []      # (t, cloud, replicas_incl_scheduled)
        self.final_weights: dict = {}    # model -> {cloud: weight} post-run
        self.final_kv: dict = {}         # disagg models: post-run kv_used
        self.run_stats: dict = {}        # last run's engine + throughput
        self._run_span = None            # open gateway.run span during run()
        self._leases: dict = {}          # (model, cloud) -> serving Leases

    def deploy(self, name: str, backend, profile: Optional[CloudProfile] = None,
               *, split: Optional[dict] = None, autoscaler=None,
               max_batch: int = 32, canary=None, canary_fraction: float = 0.0,
               standby: Optional[CloudProfile] = None,
               queue_hint: Optional[dict] = None,
               trace_link: Optional[int] = None,
               disagg: Optional[DisaggSpec] = None,
               planned_from=None) -> Deployment:
        """``profile`` places the model on one cloud (weight 1.0);
        ``split={CloudProfile: weight}`` places it active-active (weights
        must sum to 1).  With both, ``profile`` names the primary among the
        split clouds; with only a split, the largest weight is primary.
        ``standby`` adds a zero-weight pool that failover shifts into.
        ``queue_hint`` ({cloud: expected wait s}, e.g. the placement
        plan's Assignment.est_wait_s) seeds queue-aware routing before a
        pool has any queue of its own.  ``trace_link`` is the span id of
        the pipeline deploy step that produced this model (the orchestrator
        passes it through deploy_apply): request spans link to it, so one
        train-to-serve run yields a single connected trace.
        ``planned_from`` is the modelci.ModelProfile the placement was
        sized against (DeploySpec.profile path): with ``drift`` enabled
        the DriftMonitor watches this deployment's observed service time
        against it."""
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
        if standby is not None:
            if standby.name in [p.name for p, _ in placements]:
                raise ValueError("standby must be a different cloud")
            placements.append((standby, 0.0))
        hint = {c: float(w) for c, w in (queue_hint or {}).items()
                if math.isfinite(w)}
        if disagg is not None:
            clouds = [p.name for p, _ in placements]
            unknown = set(disagg.pool_kind) - set(clouds)
            if unknown:
                raise ValueError(f"disagg pool_kind names clouds not in the "
                                 f"placement: {sorted(unknown)}")
            kinds = {c: disagg.kind(c) for c in clouds}
            bad = {c: k for c, k in kinds.items()
                   if k not in ("prefill", "decode", "both")}
            if bad:
                raise ValueError(f"disagg pool_kind must be prefill / "
                                 f"decode / both, got {bad}")
            vals = set(kinds.values())
            if "prefill" in vals or "decode" in vals:
                # staged mode: every pool picks a side so every queue is
                # stage-homogeneous, and both stages need a live pool
                if "both" in vals:
                    raise ValueError(
                        "staged disagg needs every pool (standby included) "
                        "assigned 'prefill' or 'decode'; got a 'both' pool: "
                        f"{kinds}")
                w_by = {p.name: w for p, w in placements}
                for side in ("prefill", "decode"):
                    if not any(kinds[c] == side and w_by[c] > 0
                               for c in clouds):
                        raise ValueError(
                            f"staged disagg needs a weighted {side} pool, "
                            f"got kinds={kinds}")
        dep = Deployment(name, backend, profile, autoscaler or Autoscaler(),
                         max_batch, canary, canary_fraction, standby,
                         placements, hint, trace_link, disagg)
        self.deployments[name] = dep
        if planned_from is not None and self.drift is not None:
            self.drift.watch(name, planned_from)
        return dep

    # -- discrete-event loop ------------------------------------------------
    def run(self, traffic: list, seed: int = 0,
            failures: Optional[list] = None,
            migrations: Optional[list] = None, *,
            engine: str = "vector") -> GatewayResult:
        """Run the workload through the discrete-event simulation.

        engine="vector" (default): the vectorized hot path -- arrivals
        stay in the sorted ledger columns (never entering the event
        heap), whole arrival spans bulk-enqueue between discrete control
        events when a conservative attention predicate proves the span
        side-effect free, and per-batch folds are numpy.  engine="scalar"
        is the per-request reference loop.  The two are BIT-COMPATIBLE:
        identical EventLog (kinds + order), ServeResult, per-class
        percentiles and simulated dollars on any seed -- enforced by the
        equivalence suite (tests/test_engine_equivalence.py) and the
        bench oracle; the vector engine falls back to scalar-style
        single-timestamp processing whenever the predicate cannot prove
        a span inert, so feature coverage is identical by construction.
        """
        if engine not in ("scalar", "vector"):
            raise ValueError(f"unknown engine {engine!r}")
        self.batch_log = []              # audit trails cover ONE run
        self.usage_trace = []
        self.final_weights = {}
        self._leases = {}                # (model, cloud) -> open Leases
        if self.burn is not None:
            self.burn.reset()            # windows are run-scoped
        if self.drift is not None:
            self.drift.reset()           # counter baselines are run-scoped
        if self.tracer is not None:
            self._run_span = self.tracer.start("gateway.run", 0.0,
                                               seed=int(seed))
        rng = np.random.default_rng(seed)
        by_model: dict[str, list] = {}
        for spec in traffic:
            if spec.model not in self.deployments:
                raise KeyError(f"no deployment named {spec.model!r}")
            by_model.setdefault(spec.model, []).append(spec)

        events = EventHeap(_TIMER_KINDS)
        down: dict[str, int] = {}        # cloud -> active failure windows
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
            if self.tracer is not None:
                s.batch_recs = []
            if self.metrics is not None and len(arr):
                s.fold_pending = []
                reg = self.metrics
                s.fold_inst = {cname: (
                    reg.counter("gateway_requests_total", model=m,
                                cls=cname, outcome="served"),
                    reg.counter("gateway_deadline_miss_total", model=m,
                                cls=cname),
                    reg.histogram("gateway_request_latency_seconds",
                                  model=m, cls=cname),
                    reg.counter("gateway_requests_total", model=m,
                                cls=cname, outcome="shed"),
                ) for cname in s.slo_by_name}
            floors = _apportion(dep.autoscaler.cfg.min_replicas,
                                {c: p.weight for c, p in s.pools.items()})
            for c, pool in s.pools.items():
                pool.floor = floors[c]
                for _ in range(pool.floor):
                    pool.replicas[s.next_rid] = _Replica(
                        s.next_rid, warm=True)
                    s.next_rid += 1
                    if self.market is not None:
                        # floors are the contractual serving minimum: they
                        # always win the slot, preempting recorded training
                        # leases even with serving_priority off
                        self._market_lease(m, c, 0.0, force=True)
            s.trace.append((0.0, s.total_pool()))
            s.svc1 = dep.backend.service_time(1)
            # amortized per-request service estimate for the routing /
            # admission expected-completion formula: a full batch's cost
            # split over its requests (svc(1) would overprice a batched
            # backend and over-shed)
            s.svc_est = dep.backend.service_time(dep.max_batch) / dep.max_batch
            s.deadline_base = (dep.profile.network_rtt_s
                               + dep.profile.lb_overhead_s + s.svc1)
            if dep.disagg is not None:
                spec = dep.disagg
                s.stage = np.zeros(len(arr), np.int8)
                be = dep.backend
                if hasattr(be, "prefill_time") and hasattr(be, "decode_time"):
                    # measured two-phase cost model (BatcherBackend)
                    s.svc_prefill = float(be.prefill_time(spec.prompt_tokens))
                    s.svc_decode = float(be.decode_time(spec.gen_tokens))
                else:
                    # blended backend: split the single-request estimate so
                    # the disagg machinery still prices two phases
                    s.svc_prefill = 0.5 * s.svc1
                    s.svc_decode = s.svc1 - s.svc_prefill
            if engine == "scalar":
                # the vector engine keeps arrivals in the sorted ledger
                # columns and consumes them by cursor -- they never touch
                # the heap (the whole point of the SoA hot path)
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

        for f in failures or []:
            events.push(float(f.at_s), "fail", "", f.cloud)
            events.push(float(f.at_s + f.duration_s), "recover", "", f.cloud)
        for mig in migrations or []:
            events.push(float(mig.at_s), "replan", "", mig)
        if self.replan is not None:
            events.push(float(self.replan.check_every_s), "probe", "", None)
        if self.metrics is not None and self.scrape_every_s is not None:
            events.push(float(self.scrape_every_s), "scrape", "", None)

        # gateway:run is recorded AFTER the loop with the SIMULATED makespan
        # as its duration (wall_s meta carries the real wall), mirroring
        # pipeline:run -- so dump() stays byte-stable under a fixed seed
        _wall0 = time.perf_counter()
        if engine == "vector":
            t_last = self._run_vector(st, events, down)
        else:
            t_last = self._run_scalar(st, events, down)
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
        if self.market is not None:
            # surviving replicas occupied their slots through the fleet's
            # last completion: close the recorded serving intervals there
            for (model, cloud), leases in sorted(self._leases.items()):
                led = self.market.ledger(cloud)
                for lease in leases:
                    if lease.status == "active":
                        led.release(lease, makespan)
        self.log.record("gateway:run", makespan, models=sorted(by_model),
                        n=n_req, wall_s=_wall_s)
        if self.tracer is not None:
            # collector flush: build the request span forest in bulk from
            # the per-batch records -- off the event loop, like an async
            # span processor draining its queue.  wall_s meta reports the
            # flush cost next to gateway:run's hot-loop wall.
            _mat0 = time.perf_counter()
            self._materialize_trace(st)
            self.tracer.end(self._run_span, max(makespan, t_last),
                            models=sorted(by_model))
            self._run_span = None
            self.log.record("trace:materialize", 0.0,
                            spans=len(self.tracer.spans),
                            wall_s=time.perf_counter() - _mat0)
        for m, s in st.items():
            # bill surviving replicas to the fleet's last completion, NOT
            # to t_end: a trailing recover window or probe event on an
            # unrelated cloud must not inflate the bill (replicas retired
            # after the makespan already billed their real idle-out time)
            for pool in s.pools.values():
                for r in pool.replicas.values():
                    pool.replica_seconds += max(makespan - r.created_s, 0.0)
            costs[m] = sum(self._pool_costs(s).values())
            self.final_weights[m] = self._norm_weights(s)
            if s.dep.disagg is not None:
                # a drained run must have given every block back
                self.final_kv[m] = {c: int(p.kv_used)
                                    for c, p in s.pools.items()}
            if m in totals:
                results[m] = self._result(s, totals[m])
                cold[m] = s.cold_starts
        if self.metrics is not None:
            # closing scrape AFTER billing so the cost gauges are final
            self._scrape(st, max(makespan, t_last), live_accrual=False)
        return GatewayResult(results, cold, makespan, costs)

    def _run_scalar(self, st: dict, events: EventHeap, down: dict) -> float:
        """Per-request reference loop: every arrival is a heap event."""
        t_last = 0.0
        while events:
            t = events.peek_t()
            t_last = t
            step = _Step()
            # apply every state change at time t before dispatching so a
            # burst admits as full batches (pre-gateway sim semantics);
            # probes run after dispatch (leftover queues are real
            # pressure); idle expiries run last so a coincident arrival
            # wins the replica instead of forcing a retire + cold start
            while events and events.peek_t() == t:
                kind, m, data = events.pop()
                self._apply_event(st, t, kind, m, data, events, down, step)
            self._finish_timestep(st, t, events, down, step)
        return t_last

    def _run_vector(self, st: dict, events: EventHeap, down: dict) -> float:
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
        t_last = 0.0
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
            if bulk_ok and self.burn is None and t_arr < t_ev:
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
                if bulk_ok and live <= 1 and s.dep.disagg is None:
                    # routing is pinned (single live pool, or everything
                    # waits on the primary) and admission is off: the
                    # whole same-t burst appends in one grouped extend
                    self._bulk_append(s, lo, hi, self._route(s, lo))
                else:
                    for i in range(lo, hi):
                        self._arrive(s, i, t)
                s.cursor = hi
                step.touched.add(m)
            while events and events.peek_t() == t:
                kind, m, data = events.pop()
                self._apply_event(st, t, kind, m, data, events, down, step)
            t_last = t
            left = any(st[m].cursor < len(st[m].arr) for m in models)
            self._finish_timestep(st, t, events, down, step,
                                  arrivals_left=left)
        return t_last

    def _attention_time(self, s: _ModelState) -> float:
        """Earliest pending-arrival time at which this model might do
        anything beyond appending one request to one queue.  Conservative
        by design: flagging a harmless timestep only costs the slow path,
        while the span skip is valid exactly when every skipped
        timestep-end (dispatch + autoscale) is a no-op -- caller already
        guarantees admission and burn monitoring are off."""
        arr = s.arr
        now = float(arr[s.cursor])
        if self.market is not None:
            # market mode: scale-up decisions preempt training leases, so
            # every timestep is a potential ledger mutation -- force the
            # per-request path (same rule as disagg below)
            return now
        if s.dep.disagg is not None:
            # per-request KV accounting / cache shed / stage routing: every
            # arrival is a real decision, so the span skip never applies --
            # both engines take the identical per-request path (the disagg
            # analog of the engine-equivalence bit-compat rule)
            return now
        live = [p for p in s.pools.values() if p.weight > 0]
        if len(live) != 1:
            # multi-pool: queue-aware routing shifts per request;
            # zero-pool: autoscale logs scale_denied every timestep
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

    def _grouped_append(self, s: _ModelState, rows: np.ndarray,
                        combo: np.ndarray, pool: _Pool) -> None:
        """Append ledger ``rows`` (ascending, ``combo`` their version x
        class codes) to ``pool``'s per-key queues: rows stay in arrival
        order within each key and queues are created in first-appearance
        order, exactly like a per-row _arrive loop over the same rows."""
        codes, first = np.unique(combo, return_index=True)
        for j in np.argsort(first, kind="stable"):
            code = int(codes[j])
            sel = rows[np.nonzero(combo == code)[0]]
            key = (code // len(s.classes),
                   s.classes[code % len(s.classes)].name)
            pool.pending.setdefault(key, IndexQueue()).extend(sel.tolist())

    def _arrive(self, s: _ModelState, i: int, t: float) -> None:
        pool = self._route(s, i)
        if self._admit(s, pool, i, t):
            key = (int(s.ver[i]), s.slo(i).name)
            pool.pending.setdefault(key, IndexQueue()).append(i)

    def _apply_event(self, st: dict, t: float, kind: str, m: str, data,
                     events: EventHeap, down: dict, step: _Step) -> None:
        if kind == "fail":
            down[data] = down.get(data, 0) + 1
            if down[data] == 1:
                step.touched |= self._outage_edge(
                    st, t, down, events, reason="fail", cloud=data)
            return
        if kind == "recover":
            down[data] -= 1
            if down[data] == 0:
                del down[data]
                step.touched |= self._outage_edge(
                    st, t, down, events, reason="recover", cloud=data)
            return
        if kind == "replan":
            step.touched |= self._apply_migration(
                st, t, data.plan, events, down)
            return
        if kind == "probe":
            step.probe_due = True
            return
        if kind == "scrape":
            step.scrape_due = True
            return
        s = st[m]
        if kind == "arr":                # scalar engine only
            self._arrive(s, data, t)
            step.touched.add(m)
        elif kind == "up":
            cloud, gen, forced_cold = data
            pool = s.pools[cloud]
            if gen != pool.generation:
                return               # scheduled before a drain
            pool.scheduled_up -= 1
            warm = (not s.dep.autoscaler.cfg.cold_scale_up
                    and not forced_cold)
            pool.replicas[s.next_rid] = _Replica(
                s.next_rid, warm=warm, last_active=t, created_s=t)
            if s.dep.autoscaler.tracks_idle:
                # a replica that joins after the queue drained
                # would otherwise never get an idle check
                events.push(t + s.dep.autoscaler.cfg.idle_window_s,
                            "idle", m, (cloud, s.next_rid, t))
            s.next_rid += 1
            step.touched.add(m)
        elif kind == "free":
            cloud, rid, epoch = data
            pool = s.pools[cloud]
            r = pool.replicas.get(rid)
            if r is not None and r.epoch == epoch:
                # real completion (preempted batches bumped the
                # epoch): feed the burn monitor BEFORE the batch
                # is forgotten (spans/metrics fold off-loop)
                if r.inflight is not None:
                    fl = r.inflight
                    if fl["kv"]:            # KV blocks held dispatch->free
                        pool.kv_used -= fl["kv"]
                        pool.kv_resident[int(fl["v"])] -= fl["kv"]
                    if fl["stage"] == "prefill":
                        self._prefill_done(s, pool, fl, t)
                    else:
                        self._complete(s, pool, fl, t)
                r.busy = False
                r.inflight = None
                r.last_active = t
                if pool.weight <= 0 and pool.queue_len() == 0:
                    # drained-away pool: the last in-flight batch
                    # just finished, release the replica now
                    self._retire(s, pool, r, t, st)
                elif s.dep.autoscaler.tracks_idle:
                    events.push(t + s.dep.autoscaler.cfg.idle_window_s,
                                "idle", m, (cloud, rid, t))
                step.touched.add(m)
        else:                        # "idle"
            step.idle_checks.append((m, data))

    def _finish_timestep(self, st: dict, t: float, events: EventHeap,
                         down: dict, step: _Step,
                         arrivals_left: bool = False) -> None:
        """The shared tail of one timestep: dispatch + autoscale for every
        touched model, then due probes/scrapes, then idle expiries.
        ``arrivals_left`` keeps the periodic timers armed in vector mode,
        where pending arrivals are invisible to the heap (the dead-tail
        rule reads "no work AND only timers queued")."""
        if self.burn is not None:
            # stale alerts must resolve on the clock, not only on the next
            # observation: a post-traffic firing alert would otherwise keep
            # pressure() > 0 and sustain a scale-up/idle-retire livelock
            self.burn.age(t)
        # sorted: set order depends on PYTHONHASHSEED, and which
        # model dispatches first decides shared-capacity races --
        # invariant 4 promises cross-process determinism
        for m in sorted(step.touched):
            self._dispatch(st[m], t, events)
            self._autoscale(st[m], t, events, st, down)
        if step.probe_due:
            for m in sorted(self._probe(st, t, events, down)):
                self._dispatch(st[m], t, events)
                self._autoscale(st[m], t, events, st, down)
            if (self._work_left(st) or arrivals_left
                    or not events.only_timers()):
                events.push(t + self.replan.check_every_s,
                            "probe", "", None)
        if step.scrape_due:
            self._scrape(st, t)
            if (self._work_left(st) or arrivals_left
                    or not events.only_timers()):
                events.push(t + self.scrape_every_s, "scrape", "", None)
        for m, payload in step.idle_checks:
            self._maybe_retire(st[m], t, payload, st)

    def _complete(self, s: _ModelState, pool: _Pool, fl: dict,
                  t: float) -> None:
        """A batch really finished (its "free" matched the epoch): queue it
        for the next metric fold and feed the burn monitor with the
        per-pool deadline verdict.  The monitor is a CONTROLLER (it arms
        probes and pressures the autoscaler) so it must see completions
        live; metric series and spans are pure observers and fold off the
        hot path -- the whole per-batch cost here is one tuple append."""
        pend, burn = s.fold_pending, self.burn
        if pend is None and burn is None:
            return
        thresh = fl["slo"].deadline_mult * self._pool_base(s, pool)
        if pend is not None:
            pend.append((fl["idx"], fl["cls"], thresh))
        if burn is not None:
            m = s.dep.name
            cname = fl["cls"]
            for i in fl["idx"]:
                burn.observe(t, m, cname, float(s.lat[i]) <= thresh)

    def _prefill_done(self, s: _ModelState, pool: _Pool, fl: dict,
                      t: float) -> None:
        """A staged prefill batch finished: its KV rows hand off to the
        decode tier, the requests flip to stage 1 and re-enter routing
        (_pool_accepts narrows them to decode pools).  No latency verdict
        yet -- the clock keeps running from the ORIGINAL arrival and the
        decode completion charges the whole span."""
        take = fl["idx"]
        for i in take:
            s.stage[i] = 1
        self.log.record("gateway:prefill", fl["service_s"], model=s.dep.name,
                        cloud=pool.profile.name, n=len(take),
                        t_sim=round(t, 6), staged=True)
        key = (fl["v"], fl["cls"])
        for i in take:
            dest = self._route(s, i)
            dest.pending.setdefault(key, IndexQueue()).append(i)

    def _fold_metrics(self, st: dict, t: float) -> None:
        """Drain the really-completed batches queued by _complete into the
        request counters and latency sketches, chunked per class so the
        sketch updates are vectorized -- called at each scrape, never from
        the dispatch loop.  Completed batches are FINAL (a preemption
        invalidates its batch strictly before the completion would fire),
        so folds are incremental: total fold work is O(n) per run, and the
        closing fold reconciles exactly with ServeResult."""
        for s in st.values():
            pend = s.fold_pending
            if pend is None:
                continue
            if pend:
                byc: dict = {}
                for idx, cname, thresh in pend:
                    byc.setdefault(cname, []).append((idx, thresh))
                pend.clear()
                for cname, batches in byc.items():
                    served, missed, hist, _ = s.fold_inst[cname]
                    flat = [i for idx, _ in batches for i in idx]
                    vals = s.lat[flat]
                    thr = np.repeat([th for _, th in batches],
                                    [len(idx) for idx, _ in batches])
                    served.value += float(len(flat))
                    missed.value += float((vals > thr).sum())
                    hist.sketch.observe_many(vals)
            for cname, n_shed in s.class_shed.items():
                s.fold_inst[cname][3].value = float(n_shed)

    def _materialize_trace(self, st: dict) -> None:
        """Build each request's span tree (root > queue/serve children)
        from the batch records and shed marks the loop collected -- same
        vocabulary and attrs as if the spans had been opened live, at a
        fraction of the hot-path cost.  Creation order (models in deploy
        order, requests by index, children chronologically) is
        deterministic, so the exported trace is byte-stable per seed."""
        tracer, run = self.tracer, self._run_span
        for m, s in st.items():
            n = len(s.arr)
            if not n:
                continue
            by_req: list = [[] for _ in range(n)]
            for rec in s.batch_recs:
                for i in rec["idx"]:
                    by_req[i].append(rec)
            links = (s.dep.trace_link,) if s.dep.trace_link is not None \
                else ()
            for i in range(n):
                root = tracer.start("gateway.request", float(s.arr[i]),
                                    parent=run, links=links, model=m,
                                    idx=i, cls=s.slo(i).name)
                cursor, requeued = root.t0, False
                for rec in by_req[i]:
                    q = tracer.start("gateway.queue", cursor, parent=root,
                                     cloud=rec["cloud"])
                    if requeued:
                        q.attrs["requeued"] = True
                    q.t1 = rec["start_s"]
                    sp = tracer.start(
                        "gateway.serve", rec["start_s"], parent=root,
                        cloud=rec["cloud"], rid=rec["rid"],
                        batch=len(rec["idx"]), rtt_lb_s=rec["rtt_lb_s"],
                        cold_s=rec["cold_s"], service_s=rec["service_s"])
                    sp.t1 = rec["end_s"]
                    stage = rec.get("stage")
                    if stage is not None:
                        sp.attrs["stage"] = stage
                        if stage == "prefill" and not rec["preempted"]:
                            # handoff: the decode queue span opens when the
                            # prefill batch lands, not at arrival
                            cursor = rec["end_s"]
                    if rec["preempted"]:
                        sp.attrs["preempted"] = True
                        cursor, requeued = rec["end_s"], True
                if s.shed[i]:
                    t_shed, where, cloud = s.shed_at[i]
                    if by_req[i] or where != "enqueue":
                        # shed out of a queue (dispatch-time prune); an
                        # enqueue-time shed never queued at all
                        q = tracer.start("gateway.queue", cursor,
                                         parent=root, cloud=cloud)
                        if requeued:
                            q.attrs["requeued"] = True
                        q.t1 = t_shed
                    root.t1 = t_shed
                    root.attrs["outcome"] = "shed"
                    root.attrs["at"] = where
                else:
                    root.t1 = by_req[i][-1]["end_s"]
                    root.attrs["outcome"] = "served"
                    root.attrs["latency_s"] = float(s.lat[i])

    def _scrape(self, st: dict, t: float, *,
                live_accrual: bool = True) -> None:
        """Freeze queue-depth / replica / accrued-cost gauges and take a
        MetricsRegistry snapshot at simulated time ``t`` (the "scrape"
        event; scheduled every ``scrape_every_s`` like replan probes).
        ``live_accrual=False`` for the closing scrape: end-of-run billing
        already folded surviving replicas into replica_seconds."""
        metrics = self.metrics
        self._fold_metrics(st, t)        # counters/sketches catch up first
        for m, s in st.items():
            for c, pool in s.pools.items():
                g = s.gauge_inst.get(c)  # lazy: migration can open pools
                if g is None:
                    g = s.gauge_inst[c] = (
                        metrics.gauge("gateway_queue_depth",
                                      model=m, cloud=c),
                        metrics.gauge("gateway_replicas", model=m, cloud=c),
                        metrics.gauge("gateway_cost_usd", model=m, cloud=c))
                g[0].set(pool.queue_len())
                g[1].set(pool.size())
                accrued = pool.replica_seconds
                if live_accrual:
                    accrued += sum(max(t - r.created_s, 0.0)
                                   for r in pool.replicas.values())
                g[2].set(accrued * pool.profile.cost_per_s)
                if s.dep.disagg is not None and pool.kv_total > 0:
                    kg = s.kv_gauge_inst.get(c)
                    if kg is None:
                        kg = s.kv_gauge_inst[c] = metrics.gauge(
                            "gateway_kv_blocks_used", model=m, cloud=c)
                    kg.set(pool.kv_used)
            if self.drift is not None:
                # cumulative counters in, deltas inside the monitor -- the
                # same contract a Prometheus rate() has with a counter
                self.drift.observe(t, m, float(s.busy_s), int(s.served))
        metrics.scrape(t, self.log)

    def _result(self, s: _ModelState, total: float) -> ServeResult:
        dep = s.dep
        # REPORTED deadline base: the warm single-request path on the
        # PRIMARY cloud.  This is the deployment-level promise per_class()
        # publishes (a request served by a slower split cloud that beats
        # that cloud's own path but not the primary's still counts as a
        # miss here).  The IN-RUN accounting that drives probes and the
        # shedder is per-pool (_pool_base) so a slow-but-honest split
        # cloud cannot make replanning oscillate -- DESIGN.md S3.
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
            # arrival span plus ONE mean service interval.  The old
            # fallback used the whole run span (total - arr.min()), which
            # counts drain time: a burst that ends early looked like a
            # low trickle, under-estimating rate_rps and suppressing the
            # replan probes that overload should arm.
            gap = (s.busy_s / s.served if s.served
                   else max(total - float(s.arr.min()), 1e-9))
            window = max(window + gap, 1e-9)
            rate = n / window
        else:
            # n arrivals span n-1 inter-arrival gaps: n/window overestimates
            # the offered rate for small n and biases replan demand upward
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
        deadline base for in-run miss/shed accounting (charging every pool against the PRIMARY's warm path made a slow
        split cloud look like a miss storm and replan probes oscillate).
        Cached lazily: migrations open pools mid-run."""
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
        model_load_s is a one-time cost the first batch amortizes, and
        charging it per decision would keep a freshly migrated-to pool
        cold forever.  A deployment-supplied queue_hint (planner prior)
        floors the wait while the pool has no queue of its own.  A coarse
        ranking estimate, deliberately -- the simulation is the ground
        truth; this only has to order pools and spot hopeless deadlines."""
        size = pool.size()
        est = s.svc_est
        if s.dep.disagg is not None and pool.kind != "both":
            # the two phases price differently: prompt ingest is
            # serial per request, decode amortizes one wave over the batch
            est = (s.svc_prefill if pool.kind == "prefill"
                   else s.svc_decode / max(s.dep.max_batch, 1)) or est
        wait = (pool.queue_len() + 1) * est / max(size, 1)
        if pool.queue_len() == 0:
            wait = max(wait, s.dep.queue_hint.get(pool.profile.name, 0.0))
        e = wait + pool.profile.network_rtt_s + pool.profile.lb_overhead_s
        if size == 0:
            e += (s.dep.autoscaler.cfg.scale_up_delay_s
                  + pool.profile.model_load_s)
        return e

    def _kv_bias(self, s: _ModelState, pool: _Pool, i: int) -> float:
        """Cache terms added to a pool's expected completion during disagg
        routing: a version whose KV rows are not resident on the pool pays
        one prompt-ingest to populate them, and a pool whose projected
        block demand exceeds its budget pays the drain time of the
        deficit.  Zero for non-disagg deployments."""
        spec = s.dep.disagg
        if spec is None:
            return 0.0
        bias = 0.0
        if int(s.ver[i]) not in pool.kv_warm:
            bias += s.svc_prefill
        if pool.kv_total > 0:
            need = spec.blocks_per_request * (pool.queue_len() + 1)
            free = pool.kv_total - pool.kv_used
            if need > free:
                per_batch = spec.blocks_per_request * max(s.dep.max_batch, 1)
                bias += s.svc_decode * math.ceil((need - free) / per_batch)
        return bias

    def _pool_accepts(self, s: _ModelState, pool: _Pool, i: int) -> bool:
        """Stage gate for staged disagg: new arrivals go to prefill pools,
        prefill-complete requests to decode pools; always True otherwise
        (so every queue stays stage-homogeneous)."""
        if not s.staged:
            return True
        want = "decode" if (s.stage is not None and s.stage[i]) else "prefill"
        return pool.kind == want

    def _route(self, s: _ModelState, i: int) -> _Pool:
        """Blended queue-aware routing (RoutingConfig): live pools within
        ``slack`` of the best expected completion form the candidate band;
        the request's pre-drawn uniform resolves a weighted draw over the
        band (declared pool order), so a fixed seed stays bit-for-bit
        deterministic however queues and weights move.  policy="weights"
        skips the band (pure weighted draw).
        With every weight at zero (full outage, no standby) requests wait
        on the primary.  Staged disagg narrows the candidates to the
        request's stage and scores carry the KV cache terms (_kv_bias)."""
        live = [(c, p) for c, p in s.pools.items()
                if p.weight > 0 and self._pool_accepts(s, p, i)]
        total = sum(p.weight for _, p in live)
        if total <= 0:
            return s.pools[s.dep.profile.name]
        if self.routing.policy == "queue_aware" and len(live) > 1:
            scored = [(self._expected_wait(s, p) + self._kv_bias(s, p, i),
                       c, p) for c, p in live]
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
        measured against the SERVING pool's own warm path.  A disagg pool
        with a block budget additionally sheds on PROJECTED cache
        exhaustion -- queued demand plus in-flight blocks past
        shed_margin x the budget (``gateway:cache_shed``) -- a physical
        memory limit, so it applies even with admission control off."""
        spec = s.dep.disagg
        if spec is not None and pool.kv_total > 0:
            c = s.slo(i)
            projected = (pool.kv_used
                         + (pool.queue_len() + 1) * spec.blocks_per_request)
            if (c.sheddable
                    and projected > spec.shed_margin * pool.kv_total):
                self.log.record("gateway:cache_shed", 0.0, model=s.dep.name,
                                cloud=pool.profile.name, cls=c.name,
                                idx=int(i), t_sim=round(t, 6),
                                kv_used=int(pool.kv_used),
                                kv_projected=int(projected),
                                kv_total=int(pool.kv_total))
                self._shed(s, pool, i, t, where="cache")
                return False
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
        s.win_shed += 1
        pool.shed_pressure += 1
        self.log.record("gateway:shed", 0.0, model=s.dep.name,
                        cloud=pool.profile.name, cls=c.name, idx=int(i),
                        t_sim=round(t, 6), at=where)
        if self.tracer is not None:      # span materialized post-run
            s.shed_at[i] = (t, where, pool.profile.name)
        if self.burn is not None:        # a shed is a budget breach
            self.burn.observe(t, s.dep.name, c.name, good=False)

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
            if pool.handoff_load_s is not None and pool.handoff_n > 0:
                # warm handoff (market mode): this relaunched replica got
                # its state over the interconnect, not a cold model load
                cold = pool.handoff_load_s
                pool.handoff_n -= 1
            r.warm = True
            s.cold_starts += 1
            self.log.record("gateway:cold_start", cold, model=dep.name,
                            cloud=pool.profile.name, t_sim=round(t, 6))
        backend = dep.backends[v]
        b = len(take)
        spec = dep.disagg
        stage = None
        if spec is not None and s.staged:
            # stage-homogeneous queues make pool.kind authoritative; the
            # head check covers the full-decode-outage fallback (a stage-1
            # request parked on the primary must not prefill again)
            stage = ("prefill" if pool.kind == "prefill"
                     and not s.stage[take[0]] else "decode")
        if stage == "prefill":
            svc = b * s.svc_prefill        # prompt ingest is serial/request
        elif stage == "decode":
            svc = s.svc_decode             # one slot wave (b <= max_batch)
        else:
            svc = backend.service_time(b)
        done = (t + pool.profile.network_rtt_s + pool.profile.lb_overhead_s
                + cold + svc)
        kv = 0
        if spec is not None:
            pool.kv_warm.add(int(v))       # cache rows resident (routing)
            if pool.kv_total > 0:
                kv = spec.blocks_per_request * b
                pool.kv_used += kv
                pool.kv_resident[int(v)] = \
                    pool.kv_resident.get(int(v), 0) + kv
            if stage is None:
                # unified pool: the prefill share is priced inside
                # service_time; surface it so the event log still splits
                self.log.record("gateway:prefill", b * s.svc_prefill,
                                model=dep.name, cloud=pool.profile.name,
                                n=b, t_sim=round(t, 6), staged=False)
        if stage != "prefill":
            # in-run miss window: charge against the SERVING pool's own
            # warm path, not the primary's (per-pool promise; the
            # primary-relative one is reported post-run in per_class).
            # A staged prefill batch carries no latency
            # verdict: the request is still in flight until its decode
            # batch lands, which charges the whole arrival-to-done span.
            pool_base = self._pool_base(s, pool)
            idx = np.fromiter(take, np.intp, b)
            lats = done - s.arr[idx]
            s.lat[idx] = lats
            # the batch is single-class (queues key on class), so one
            # scalar threshold covers it; elementwise semantics match the
            # old per-row compare bit for bit (an inf deadline never
            # counts as a miss)
            s.win_miss += int((lats > s.slo_by_name[cname].deadline_mult
                               * pool_base).sum())
            s.win_n += b
            s.served += b
            s.per_version[backend.name] = \
                s.per_version.get(backend.name, 0) + b
        s.busy_s += svc
        r.busy = True
        r.last_active = done
        r.epoch += 1
        rec = None
        if self.record_batches or s.batch_recs is not None:
            # one dict per BATCH is the whole per-dispatch telemetry cost;
            # the span materializer reads rtt_lb/cold/service back out
            rec = {"model": dep.name, "rid": r.rid,
                   "cloud": pool.profile.name,
                   "cls": cname, "version": v, "idx": tuple(take),
                   "start_s": t, "end_s": done, "preempted": False,
                   "rtt_lb_s": pool.profile.network_rtt_s
                   + pool.profile.lb_overhead_s,
                   "cold_s": cold, "service_s": svc}
            if stage is not None:
                rec["stage"] = stage
            if self.record_batches:
                self.batch_log.append(rec)
            if s.batch_recs is not None:
                s.batch_recs.append(rec)
        r.inflight = {"idx": take, "v": v, "cls": cname,
                      "slo": s.slo_by_name[cname], "backend": backend.name,
                      "service_s": svc, "done": done, "record": rec,
                      "win_epoch": s.win_epoch, "stage": stage, "kv": kv}
        events.push(done, "free", dep.name,
                    (pool.profile.name, r.rid, r.epoch))

    def _reclaim(self, s: _ModelState, pool: _Pool, r: _Replica,
                 t: float) -> int:
        """Undo an in-flight batch (preemption or cloud failure): requests
        re-queue with their original arrival times, so they complete exactly
        once when re-dispatched.  Request index order IS arrival order
        (arrivals are sorted at init), so a sorted merge restores the
        queue's FIFO invariant even when several replicas reclaim into the
        same queue (e.g. a whole-pool failover drain)."""
        fl = r.inflight
        take = fl["idx"]
        key = (fl["v"], fl["cls"])
        old = pool.pending.get(key)
        pool.pending[key] = IndexQueue(
            sorted(take + (list(old) if old else [])))
        if fl["kv"]:                             # give the blocks back
            pool.kv_used -= fl["kv"]
            pool.kv_resident[int(fl["v"])] -= fl["kv"]
        if fl["stage"] != "prefill":
            # only undo window counts the batch contributed to the CURRENT
            # probe window; a pre-reset batch was already flushed with its
            # window and must not distort this one.  (A prefill batch
            # never wrote lat/window/served counters -- see _assign.)
            undo_window = fl["win_epoch"] == s.win_epoch
            pool_base = self._pool_base(s, pool)  # mirror _assign's charge
            for i in take:
                if undo_window and s.lat[i] > s.slo(i).deadline_mult \
                        * pool_base:
                    s.win_miss -= 1
                s.lat[i] = -1.0
            if undo_window:
                s.win_n -= len(take)
            s.served -= len(take)
            s.per_version[fl["backend"]] -= len(take)
        s.busy_s -= fl["service_s"]
        if fl["record"] is not None:
            # the serve attempt is abandoned: the materializer turns this
            # into a preempted serve span followed by a requeued queue span
            # (the analyzer charges preempted time separately from service)
            fl["record"]["end_s"] = t
            fl["record"]["preempted"] = True
        r.busy = False
        r.inflight = None
        r.epoch += 1                     # invalidate the scheduled "free"
        r.last_active = t
        return len(take)

    # -- weight shifts: migration, failover, recovery -----------------------
    def _desired_weights(self, s: _ModelState, down: dict) -> dict:
        """Nominal weights with down clouds zeroed; if that extinguishes
        every pool, the zero-nominal pools that are still up (the standby)
        split the traffic evenly."""
        live = {c: p.nominal for c, p in s.pools.items()
                if p.nominal > 0 and c not in down}
        if not live:
            alts = [c for c, p in s.pools.items()
                    if p.nominal <= 0 and c not in down]
            live = {c: 1.0 / len(alts) for c in alts}
        return {c: live.get(c, 0.0) for c in s.pools}

    def _outage_edge(self, st, t, down, events, *, reason: str,
                     cloud: str) -> set:
        """A cloud just died or came back: every model re-derives its live
        weights from the nominal split and the down set.  The edge is a
        plain weight shift -- failover/recovery have no code path of their
        own."""
        touched = set()
        for name, s in st.items():
            desired = self._desired_weights(s, down)
            changed = any(abs(desired[c] - p.weight) > 1e-12
                          for c, p in s.pools.items())
            dead = s.pools.get(cloud)
            must_drain = (reason == "fail" and dead is not None
                          and (dead.replicas or dead.scheduled_up))
            if not changed and not must_drain:
                continue
            if reason == "recover":
                home = cloud in s.pools and s.pools[cloud].nominal > 0
                why = "recover" if home else "fail"
            else:
                why = "fail"
            self._set_weights(s, t, desired, reason=why, events=events,
                              st=st, down=down,
                              edge_cloud=cloud if reason == "fail" else None)
            touched.add(name)
        return touched

    def _apply_migration(self, st, t, plan, events, down) -> set:
        """Apply a MigrationPlan (or raw {model: {cloud: weight}}) live:
        one weight shift per step, opening pools for clouds the deployment
        has not served from before (gateway:migrate reason=plan)."""
        if hasattr(plan, "steps"):
            steps = list(plan.steps)
        else:
            # normalize the raw-dict form into MigrationSteps so BOTH entry
            # points share one validation rule set (weights sum to 1,
            # non-negative, profiles cover every cloud)
            steps = []
            for model, weights in plan.items():
                if model not in st:
                    raise KeyError(f"no deployment named {model!r}")
                pools = st[model].pools
                steps.append(MigrationStep(
                    model, dict(weights), {},
                    {c: (pools[c].profile if c in pools else get_profile(c))
                     for c in weights}))
        touched = set()
        for step in steps:
            if step.model not in st:
                raise KeyError(f"no deployment named {step.model!r}")
            s = st[step.model]
            for cloud in step.weights:
                if cloud not in s.pools:
                    p = s.pools[cloud] = _Pool(step.profiles[cloud], 0.0)
                    if s.dep.disagg is not None:
                        p.kind = s.dep.disagg.kind(cloud)
                        p.kv_total = s.dep.disagg.blocks_for(cloud)
            self.log.record("gateway:migrate", 0.0, model=step.model,
                            t_sim=round(t, 6), reason="plan",
                            weights={c: round(w, 6)
                                     for c, w in step.weights.items()})
            self._set_weights(s, t, dict(step.weights), reason="migrate",
                              events=events, st=st, down=down,
                              update_nominal=True,
                              size_hint=dict(step.replicas) or None)
            touched.add(step.model)
        return touched

    def _set_weights(self, s: _ModelState, t: float, target: dict, *,
                     reason: str, events, st, down,
                     update_nominal: bool = False,
                     size_hint: Optional[dict] = None,
                     edge_cloud: Optional[str] = None) -> None:
        """THE weight-shift primitive (drain-and-shift, exactly-once).

        - dead-cloud pools drain hard: in-flight batches reclaim (pods are
          gone), replicas clear, pending launches invalidate;
        - pools migrated to zero weight on a LIVE cloud drain soft: idle
          replicas retire now, busy ones finish their batch and retire on
          its "free" (no work is dropped);
        - every queued request re-routes by the NEW weights via its
          original uniform draw, merged in arrival order;
        - pools gaining weight from zero relaunch forced-cold, sized by
          Autoscaler.relaunch_pool against the DESTINATION cloud's
          headroom (the working set that left the shrinking pools, or the
          MigrationPlan's replica hint).
        """
        dep = s.dep
        old_live = {c: p.weight for c, p in s.pools.items()}
        old_size = {c: p.size() for c, p in s.pools.items()}
        for c, pool in s.pools.items():
            w = float(target.get(c, 0.0))
            if update_nominal:
                pool.nominal = w
            pool.weight = 0.0 if c in down else w
            if pool.weight <= 0:
                # the shed demand re-routes with the backlog: stale
                # pressure on a drained pool must not trigger a phantom
                # scale-from-zero launch later
                pool.shed_pressure = 0
        floors = _apportion(dep.autoscaler.cfg.min_replicas,
                            {c: p.weight for c, p in s.pools.items()})
        requeued = 0
        moved = 0
        for c, pool in s.pools.items():
            pool.floor = floors[c]
            if c in down and (pool.replicas or pool.scheduled_up):
                for r in list(pool.replicas.values()):
                    if r.busy and r.inflight is not None:
                        requeued += self._reclaim(s, pool, r, t)
                moved += old_size[c]
                for r in pool.replicas.values():
                    pool.replica_seconds += max(t - r.created_s, 0.0)
                if self.market is not None:
                    # the pods are gone: give every slot back at once
                    self._market_release(dep.name, c, t,
                                         len(pool.replicas)
                                         + pool.scheduled_up)
                pool.replicas.clear()
                pool.generation += 1     # stale "up" events are dropped
                pool.scheduled_up = 0
                s.trace.append((t, s.total_pool()))
                self._note_usage(st, c, t)
            elif (pool.weight <= 0 and old_live[c] > 0
                  and (pool.replicas or pool.scheduled_up)):
                moved += old_size[c]
                pool.generation += 1
                if self.market is not None and pool.scheduled_up:
                    # invalidated pending launches free their slots now;
                    # live replicas release theirs as they retire
                    self._market_release(dep.name, c, t, pool.scheduled_up)
                pool.scheduled_up = 0
                for r in [x for x in pool.replicas.values() if not x.busy]:
                    self._retire(s, pool, r, t, st)
        # shift the backlog: re-route every queued request by the new split
        pend = []
        for pool in s.pools.values():
            for q in pool.pending.values():
                pend.extend(q)
            pool.pending = {}
        pend.sort()
        live = [p for p in s.pools.values() if p.weight > 0]
        if pend and len(live) <= 1:
            # one destination for the whole backlog (single live pool, or
            # full outage waiting on the primary): _route is constant over
            # pend, so the drain folds to one grouped append -- the exact
            # order the per-row loop below would produce.  This is the
            # failover hot path at scale (the backlog is the overload).
            dest = live[0] if live else s.pools[dep.profile.name]
            rows = np.asarray(pend, dtype=np.intp)
            self._grouped_append(
                s, rows, s.ver[rows] * len(s.classes) + s.cls_code[rows],
                dest)
        else:
            for i in pend:
                pool = self._route(s, i)
                key = (int(s.ver[i]), s.slo(i).name)
                pool.pending.setdefault(key, IndexQueue()).append(i)
        # relaunch on pools that just came alive
        gainers = [(c, p) for c, p in s.pools.items()
                   if p.weight > 0 and old_live.get(c, 0.0) <= 0
                   and p.size() == 0 and c not in down]
        wsum = sum(p.weight for _, p in gainers) or 1.0
        for c, pool in gainers:
            if size_hint is not None and c in size_hint:
                share = int(size_hint[c])
            else:
                share = int(round(moved * pool.weight / wsum))
            # surge headroom: the shrinking pools are still finishing their
            # in-flight batches, so the deployment-total bound must not
            # count them against the destination (they retire right after)
            n = dep.autoscaler.relaunch_pool(
                share, pool.queue_len(),
                self._pool_headroom(st, s, pool, assume_live=True, t=t))
            if n > 0 and self.market is not None \
                    and self.market.state_bytes > 0:
                # replica warm handoff: the relaunched cohort migrates the
                # model state from the largest shrinking pool over the
                # interconnect instead of paying a cold model load --
                # whichever is cheaper (priced like artifact transfers)
                srcs = [(old_size[c2], c2) for c2, p2 in s.pools.items()
                        if c2 != c and old_size[c2] > 0
                        and old_live.get(c2, 0.0) > 0]
                if srcs:
                    from ...pipelines.artifacts import transfer_time_s
                    src_prof = s.pools[max(srcs)[1]].profile
                    tr = transfer_time_s(src_prof, pool.profile,
                                         self.market.state_bytes)
                    if tr < pool.profile.model_load_s:
                        pool.handoff_load_s = tr
                        pool.handoff_n = n
                        self.log.record(
                            "capacity:handoff", 0.0, model=dep.name,
                            src=src_prof.name, dst=c, t_sim=round(t, 6),
                            replicas=n, transfer_s=round(tr, 6),
                            saved_s=round(pool.profile.model_load_s - tr,
                                          6))
            for i in range(n):
                self._launch(s, pool, t, events, st, down,
                             from_zero=(i == 0 and pool.queue_len() > 0),
                             forced_cold=True)
        norm = self._norm_weights(s)
        self.log.record("gateway:split", 0.0, model=dep.name,
                        t_sim=round(t, 6), reason=reason, requeued=requeued,
                        weights={c: round(w, 6) for c, w in norm.items()})
        if reason in ("fail", "recover"):
            # src/dst compare NORMALIZED shares: src is the cloud that LOST
            # traffic share (the failed cloud on an outage, the absorber on
            # recovery), dst the largest gainer -- a surviving split pool
            # that absorbs a dead cloud's traffic by renormalization is a
            # real destination; dst=None means nowhere to go at all
            old_total = sum(old_live.values())
            old_norm = {c: (w / old_total if old_total > 0 else 0.0)
                        for c, w in old_live.items()}
            losses = {c: old_norm[c] - norm[c] for c in s.pools
                      if old_norm[c] - norm[c] > 1e-12}
            gains = {c: norm[c] - old_norm[c] for c in s.pools
                     if norm[c] - old_norm[c] > 1e-12}
            # no share moved but something drained (e.g. a dead cloud's
            # lingering soft-drain replicas): attribute the edge's cloud,
            # not the primary
            src = (max(losses, key=losses.get) if losses
                   else edge_cloud or dep.profile.name)
            dst = max(gains, key=gains.get) if gains else None
            event = ("gateway:failover" if reason == "fail"
                     else "gateway:recover")
            self.log.record(event, 0.0, model=dep.name, src=src, dst=dst,
                            t_sim=round(t, 6), requeued=requeued)

    # -- continuous re-planning (probes) ------------------------------------
    def _work_left(self, st) -> bool:
        return any(p.queue_len() or p.scheduled_up
                   or any(r.busy for r in p.replicas.values())
                   for s in st.values() for p in s.pools.values())

    def _pool_overloaded(self, s: _ModelState, pool: _Pool) -> bool:
        """ReplanConfig overload rule, shared by the blocked detection and
        the destination filter so the two can never drift apart.  Counts
        shed-pressure as queue depth: a pool shedding hard keeps a short
        queue, but it is still overloaded."""
        cfg = self.replan
        q = s.dep.autoscaler.effective_queue(pool.queue_len(),
                                             pool.shed_pressure,
                                             self._alert_pressure(s))
        return q > (cfg.overload_factor * s.dep.autoscaler.cfg.target_queue
                    * max(pool.size(), 1))

    def _alert_pressure(self, s: _ModelState) -> int:
        """Extra queue depth an active SLO burn-rate alert contributes to
        every scaling / overload read for this model (telemetry/slo.py)."""
        if self.burn is None:
            return 0
        return self.burn.pressure(s.dep.name,
                                  s.dep.autoscaler.cfg.target_queue)

    def _probe(self, st, t, events, down) -> set:
        """One auto-replan check over every model (ReplanConfig)."""
        cfg = self.replan
        touched = set()
        for m, s in st.items():
            # during an outage the live weights are a temporary emergency
            # adjustment: probe shifts then stay live-only, so recovery
            # still restores the DECLARED (nominal) split
            update_nominal = not any(c in down for c in s.pools)
            live = [(c, p) for c, p in s.pools.items() if p.weight > 0]
            if not live:
                s.streak["hot"] = s.streak["cold"] = 0
                s.win_n = s.win_miss = s.win_shed = 0
                s.win_epoch += 1
                continue
            asc = s.dep.autoscaler
            blocked = [
                (c, p) for c, p in live
                if self._pool_overloaded(s, p)
                and self._pool_headroom(st, s, p, down, t=t) <= 0]
            miss = (s.win_n >= cfg.min_window_n
                    and s.win_miss / s.win_n > cfg.max_miss_rate)
            # shedding is an overload signal, never a mask: a window shed
            # rate over budget arms the same shift as a miss-rate breach
            offered = s.win_n + s.win_shed
            shed_hot = (offered >= cfg.min_window_n
                        and s.win_shed / offered > cfg.max_shed_rate)
            # an active burn-rate alert arms the same shift: the monitor's
            # sliding windows typically trip BEFORE the probe-window rates
            # accumulate (it sees every completion, not probe epochs)
            burning = self.burn is not None and self.burn.is_burning(m)
            # an active profile-drift alert arms the same shift: the live
            # placement was sized from numbers the DriftMonitor has shown
            # to be stale, so re-plan from observed demand while the
            # re-profile is in flight
            drifting = self.drift is not None and self.drift.is_drifting(m)
            was_shedding = s.win_shed > 0
            # the window is consumed by THIS probe whatever it decides --
            # an aborted shift (no destination) must not leak completions
            # into the next window.  Pool shed-pressure is window-scoped
            # too once probes are running (launches also clear it).
            s.win_n = s.win_miss = s.win_shed = 0
            s.win_epoch += 1
            for _, p in live:
                p.shed_pressure = 0
            if blocked or miss or shed_hot or burning or drifting:
                s.streak["hot"] += 1
                s.streak["cold"] = 0
                # remember what ARMED the trigger: the firing probe's own
                # flags may differ from what built the streak
                s.streak_why = ("overload" if blocked
                                else "miss_rate" if miss
                                else "shed_rate" if shed_hot
                                else "slo_burn" if burning
                                else "profile_drift")
            else:
                s.streak["hot"] = 0
                idle_split = (cfg.consolidate and len(live) > 1
                              and s.queue_len() == 0
                              and not was_shedding
                              and not any(r.busy
                                          for _, p in live
                                          for r in p.replicas.values()))
                s.streak["cold"] = s.streak["cold"] + 1 if idle_split else 0
            if s.streak["hot"] >= cfg.sustain:
                # hottest pool sheds toward the cheapest cloud with headroom
                src_c, src_p = max(live, key=lambda cp: (
                    cp[1].queue_len() / max(cp[1].size(), 1),
                    cp[1].profile.cost_per_s, cp[0]))
                views = []
                for c, p in s.pools.items():
                    if c == src_c or c in down:
                        continue
                    if self._pool_overloaded(s, p):
                        continue     # equally drowning: shifting there just
                    views.append(    # ping-pongs the backlog, no relief
                        PoolView(c, p.profile.cost_per_s, p.size(),
                                 self._pool_headroom(st, s, p, down,
                                                     assume_live=True,
                                                     t=t)))
                pick = asc.pick_scale_up(views)
                if pick is None:
                    continue     # streak stays armed: the first probe after
                                 # a destination frees up shifts immediately
                s.streak["hot"] = 0
                delta = cfg.shift * src_p.weight
                target = {c: p.weight for c, p in s.pools.items()}
                target[src_c] -= delta
                target[pick.cloud] += delta
                self.log.record("gateway:migrate", 0.0, model=m,
                                t_sim=round(t, 6), src=src_c, dst=pick.cloud,
                                delta=round(delta, 6), reason=s.streak_why)
                self._set_weights(s, t, target, reason="migrate",
                                  events=events, st=st, down=down,
                                  update_nominal=update_nominal)
                touched.add(m)
            elif s.streak["cold"] >= cfg.sustain:
                # idle fleet: fold the most expensive pool into the cheapest
                src = asc.pick_retire(
                    [PoolView(c, p.profile.cost_per_s, p.size(), 0)
                     for c, p in live])
                # real headroom, like the overload branch: never fold the
                # whole split onto a cloud that cannot actually grow
                others = [PoolView(c, p.profile.cost_per_s, p.size(),
                                   self._pool_headroom(st, s, p, down,
                                                       assume_live=True,
                                                       t=t))
                          for c, p in live if c != (src.cloud if src else None)]
                dst = asc.pick_scale_up(others)
                if src is None or dst is None:
                    continue     # streak stays armed, same as the hot path
                s.streak["cold"] = 0
                target = {c: p.weight for c, p in s.pools.items()}
                target[dst.cloud] += target[src.cloud]
                target[src.cloud] = 0.0
                self.log.record("gateway:migrate", 0.0, model=m,
                                t_sim=round(t, 6), src=src.cloud,
                                dst=dst.cloud,
                                delta=round(target[dst.cloud], 6),
                                reason="cost")
                self._set_weights(s, t, target, reason="migrate",
                                  events=events, st=st, down=down,
                                  update_nominal=update_nominal)
                touched.add(m)
        return touched

    # -- scaling ------------------------------------------------------------
    def _pool_cap(self, s: _ModelState, pool: _Pool) -> int:
        """Max replicas this pool may hold: its ceil-share of max_replicas
        by live weight (a pool holding ALL the traffic gets the whole
        budget), never below its floor."""
        total = sum(p.weight for p in s.pools.values())
        if pool.weight <= 0 or total <= 0:
            return pool.floor
        cfg = s.dep.autoscaler.cfg
        cap = max(cfg.max_replicas, cfg.min_replicas)
        return max(math.ceil(cap * pool.weight / total), pool.floor)

    def _pool_headroom(self, st, s: _ModelState, pool: _Pool,
                       down: Optional[dict] = None,
                       assume_live: bool = False,
                       t: Optional[float] = None) -> int:
        """Replicas this pool can still add under its weight share, the
        deployment budget, and the shared cloud capacity.  assume_live
        asks "could this cloud absorb a weight shift?": it prices a
        zero-weight pool as if it held traffic and skips the
        deployment-total bound, because the source pool drains after the
        shift (live migration runs a transient surge on purpose)."""
        cloud = pool.profile.name
        if down and cloud in down:
            return 0
        cfg = s.dep.autoscaler.cfg
        budget = max(cfg.max_replicas, cfg.min_replicas)
        if assume_live:
            room = budget - pool.size()
        elif pool.weight <= 0:
            room = 0
        else:
            room = min(self._pool_cap(s, pool) - pool.size(),
                       budget - s.total_pool())
        cap = self.capacity.get(cloud)
        if cap is not None:
            used = self._cloud_usage(st, cloud)
            if self.market is not None and t is not None \
                    and not self.market.serving_priority:
                # without priority, live training leases block the slots;
                # with priority they are preemptible, i.e. free headroom
                used += self.market.training_active(cloud, t)
            room = min(room, cap - used)
        return max(room, 0)

    def _autoscale(self, s: _ModelState, t: float, events: EventHeap, st,
                   down) -> None:
        cfg = s.dep.autoscaler.cfg
        budget = max(cfg.max_replicas, cfg.min_replicas)
        alert_q = self._alert_pressure(s)
        for pool in s.pools.values():
            # shed-pressure counts as queue depth: demand that admission
            # control dropped is still demand, and must drive scale-up
            # rather than be masked by the now-short queue; an active SLO
            # burn alert adds model-wide pressure the same way -- but only
            # to pools actually carrying traffic (a zero-weight standby
            # must not scale from zero on an alert it cannot serve)
            q = s.dep.autoscaler.effective_queue(
                pool.queue_len(), pool.shed_pressure,
                alert_q if pool.weight > 0 else 0)
            if q > 0 and pool.size() == 0:   # scale from zero: spin up one
                if s.total_pool() >= budget:
                    # queued work is pinned to THIS pool (routing moves only
                    # on weight shifts), so starving it would stall the run:
                    # breach the deployment budget loudly instead
                    self.log.record("gateway:budget_exceeded", 0.0,
                                    model=s.dep.name,
                                    cloud=pool.profile.name,
                                    t_sim=round(t, 6))
                self._launch(s, pool, t, events, st, down,
                             from_zero=True)
                continue
            # at most ONE launch per pool per evaluation (KPA rate-limits
            # scale-up; also the pre-gateway sim's cadence of one replica
            # per batch completion, which the legacy kserve path depends
            # on); per-pool ceil-share caps may SUM over the budget, so the
            # deployment total is enforced here too
            if (s.dep.autoscaler.scale_up_needed(q, pool.size())
                    and pool.size() < self._pool_cap(s, pool)
                    and s.total_pool() < budget):
                self._launch(s, pool, t, events, st, down)

    def _cloud_usage(self, st, cloud: str) -> int:
        return sum(p.size() for x in st.values()
                   for c, p in x.pools.items() if c == cloud)

    def _note_usage(self, st, cloud: str, t: float) -> None:
        if self.record_batches:
            self.usage_trace.append((t, cloud, self._cloud_usage(st, cloud)))

    # -- capacity-market bridge (market mode only) ---------------------------
    def _market_lease(self, model: str, cloud: str, t: float, *,
                      force: bool = False):
        """Take one serving lease for ``model`` on ``cloud`` at ``t``,
        preempting recorded/live training leases while the ledger is full
        (serving priority; ``force`` is the floor path, which always
        wins).  Returns the Lease, or None on an unledgered cloud / when
        priority is off and the cloud is full."""
        led = self.market.ledger(cloud)
        if led is None:
            return None
        lease = led.lease("serving", f"pool:{model}", t)
        while lease is None and (force or self.market.serving_priority):
            victim = led.preempt_youngest(t, "training")
            if victim is None:
                break
            self.log.record("capacity:preempt", 0.0, model=model,
                            cloud=cloud, holder=victim.holder,
                            t_sim=round(t, 6))
            lease = led.lease("serving", f"pool:{model}", t)
        if lease is not None:
            self._leases.setdefault((model, cloud), []).append(lease)
            self.log.record("capacity:lease", 0.0, model=model, cloud=cloud,
                            kind="serving", t_sim=round(t, 6))
        return lease

    def _market_release(self, model: str, cloud: str, t: float,
                        n: int = 1) -> None:
        """Close ``n`` of ``model``'s serving leases on ``cloud`` at
        ``t``.  Leases are fungible within a pool: the newest open one is
        released first."""
        led = self.market.ledger(cloud)
        leases = self._leases.get((model, cloud))
        if led is None or not leases:
            return
        for _ in range(n):
            while leases and leases[-1].status != "active":
                leases.pop()
            if not leases:
                return
            led.release(leases.pop(), t)

    def _launch(self, s: _ModelState, pool: _Pool, t: float,
                events: EventHeap, st, down, *, from_zero: bool = False,
                forced_cold: bool = False) -> bool:
        cloud = pool.profile.name
        if cloud in down:                # nothing schedules on a dead cloud
            self.log.record("gateway:scale_denied", 0.0, model=s.dep.name,
                            cloud=cloud, t_sim=round(t, 6),
                            reason="cloud_down")
            return False
        cap = self.capacity.get(cloud)
        if cap is not None:
            used = self._cloud_usage(st, cloud)
            if self.market is not None:
                # the ledger is the source of truth: live training leases
                # occupy slots too.  With serving priority they are spot --
                # preempt the youngest until this replica fits.
                used += self.market.training_active(cloud, t)
                while used >= cap:
                    victim = self.market.preempt_training(cloud, t)
                    if victim is None:
                        break
                    self.log.record("capacity:preempt", 0.0,
                                    model=s.dep.name, cloud=cloud,
                                    holder=victim.holder,
                                    t_sim=round(t, 6))
                    used -= 1
            if used >= cap:
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
        if self.market is not None:
            self._market_lease(s.dep.name, cloud, t)
        delay = s.dep.autoscaler.cfg.scale_up_delay_s
        pool.scheduled_up += 1
        pool.shed_pressure = 0           # the overload signal did its job
        s.trace.append((t, s.total_pool()))
        self._note_usage(st, cloud, t)
        events.push(t + delay, "up", s.dep.name,
                    (cloud, pool.generation, forced_cold))
        self.log.record("gateway:scale_up", delay, model=s.dep.name,
                        t_sim=round(t, 6), pool=s.total_pool(), cloud=cloud,
                        from_zero=from_zero)
        return True

    def _retire(self, s: _ModelState, pool: _Pool, r: _Replica, t: float,
                st) -> None:
        pool.replica_seconds += max(t - r.created_s, 0.0)
        del pool.replicas[r.rid]
        if self.market is not None:
            self._market_release(s.dep.name, pool.profile.name, t)
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
