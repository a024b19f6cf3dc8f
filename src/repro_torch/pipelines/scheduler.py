"""Discrete-event pipeline orchestrator: the Kubeflow-Pipelines / Argo
control-plane analog, scheduling a compiled step DAG onto simulated
per-cloud clusters instead of executing it serially in-process.

The simulation contract is the repo-wide hardware gate (DESIGN.md §1):
each step's COMPUTE time is measured on this host (the fn runs for real,
exactly once, wall-clocked -- or takes an analytic ``sim_s``), while the
control-plane and network terms are CloudProfile constants: every attempt
charges ``startup_s`` (cluster/pod spin-up, the paper's per-stage
control-plane delta) + ``network_rtt_s`` (the control-plane hop) + any
cross-cloud artifact transfers (artifacts.py) + compute, and bills
``duration x cost_per_s`` worker-seconds against the price sheet.

Scheduling (the ``placement.plan_placement`` analog, per step): a ready
step takes a free worker on an eligible cloud -- not down, pin honored --
ranked by ``policy``: "makespan" minimizes the estimated completion
(startup + rtt + transfer estimate + known duration), "cost" takes the
cheapest cloud first.  Independent DAG branches therefore run in PARALLEL
across the ``{cloud: workers}`` slots; the greedy scheduler never idles a
worker while a step is ready, so with no failures the simulated makespan
never exceeds the serial sum of step durations (work conservation -- the
invariant suite asserts it).

Failures: ``FailureSpec``-style outage windows (duck-typed: cloud / at_s /
duration_s, same shape the gateway injects) kill every attempt running on
that cloud at the window start; the step retries with exponential backoff
(``RetryPolicy``), usually landing on a surviving cloud, until it
permanently fails and its descendants are skipped.  Completion is exactly
once: the fn's real execution happens once per run regardless of simulated
attempts, and a step ends in exactly one of done / failed / skipped.

A terminal ``kind="deploy"`` step closes the paper's train->serve loop:
its fn builds a serving backend from the trained artifact, the orchestrator
sizes a placement (``plan_placement``) from the backend's MEASURED service
time and hands it to ``Gateway.deploy`` -- one run goes pipeline ->
placement -> live gateway.  With ``DeploySpec.profile`` set, demand comes
from committed Model-CI profile artifacts instead (``ProfileStore.demand``)
and the planned-from profile rides into ``Gateway.deploy`` for drift
watching.

A ``kind="profile"`` step (payload: ``modelci.ProfileSpec``) is the
profiling DAG's measurement unit: its fn returns the raw profile field
dict (``modelci.measure``/``roofline_fields`` -- JSON-able, so it CACHES
across recurring runs) and on completion the orchestrator stamps the
executing cloud's constants and commits the ModelProfile artifact into
the spec's ProfileStore.  The commit re-runs on cached completions, so a
cache-hit recurring firing still refreshes the store's ``latest``.

Event vocabulary (telemetry/events.py): pipeline:run / schedule / step /
cache_hit / transfer / retry / fail / skip / deploy / recurring, plus
modelci:profile on profile-step completion.

The port's copy of ``repro.pipelines.scheduler``.  A step's compute is
still its measured wall time (or its ``sim_s``); a step fn that queued work
on the card has finished it before the clock is read, because the
orchestrator synchronises the card after the fn returns whenever CUDA is
initialised (``_device_sync``): a fn that returns tensors need not pull a
metric to the host for its time to be true.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from ..clouds.profiles import PROFILES, CloudProfile, get_profile
from ..core.pipeline import PipelineSpec, StepRef, step_cache_key, toposort
from ..sim.engine import EventHeap
from ..telemetry.events import EventLog
from .artifacts import ArtifactCache, best_transfer, payload_bytes
from .runs import RetryPolicy, RunRecord, StepRecord


@dataclasses.dataclass
class DeploySpec:
    """Config for a terminal ``kind="deploy"`` step (the train->serve
    handoff).  The step's fn is the BACKEND FACTORY: it receives the
    upstream artifacts (e.g. trained params) and returns a gateway backend
    (``.name`` + ``.service_time(b)``).  The orchestrator then builds a
    ``ModelDemand`` from the backend's measured service time -- either a
    fixed ``rate`` (req/s) or a host-independent ``load_erlangs`` (offered
    load; rate = load / service_time) -- plans a placement over ``clouds``
    (placement.CloudCapacity list) and deploys the model active-active
    through ``Gateway.deploy`` with the plan's weights and queue hints.

    ``profile``: a ``modelci.ProfileStore`` (or anything with
    ``demand``/``worst``).  When set, every demand number comes from
    committed profile artifacts -- ``ModelDemand`` (service time and the
    prefill/decode split) is derived via ``profile.demand(model, ...)``
    restricted to the placement's candidate clouds, no profiles committed
    for the model on those clouds is an infeasible deploy, and the worst
    planned-from profile is handed through ``Gateway.deploy(planned_from=)``
    so the serving-side drift monitor can compare plan vs observed."""
    model: str
    clouds: list
    rate: Optional[float] = None
    load_erlangs: Optional[float] = None
    objective: str = "cost"
    split: bool = True
    autoscaler: Any = None               # gateway Autoscaler(Config) or None
    max_batch: int = 32
    profile: Any = None                  # modelci.ProfileStore or None

    def __post_init__(self):
        if (self.rate is None) == (self.load_erlangs is None):
            raise ValueError("set exactly one of rate / load_erlangs")
        if self.objective not in ("cost", "p99"):
            raise ValueError(f"unknown objective {self.objective!r}")


def _device_sync() -> None:
    """Wait for the card's queued work, so the wall clock read after a step
    fn covers its device time; a no-op where CUDA was never initialised."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _WorkerPool:
    def __init__(self, profile: CloudProfile, workers: int):
        self.profile = profile
        self.workers = workers
        self.busy = 0

    def free(self) -> int:
        return self.workers - self.busy


class _StepState:
    def __init__(self, record: StepRecord):
        self.record = record
        self.status = "pending"          # ready|running|done|failed|skipped
        self.executed = False            # the real fn ran (exactly once)
        self.output: Any = None
        self.compute_s = 0.0
        self.extra_s = 0.0               # deploy model loads
        self.out_clouds: Optional[set] = None
        self.nbytes = 0
        self.entry = None                # ArtifactCache entry, if cached
        self.cache_key: Optional[str] = None
        self.key_done = False            # inputs are fixed once deps are
        # done, so the content hash is computed once, not per ready pass
        self.deploy_info: Optional[dict] = None
        self.deploy_apply: Optional[dict] = None  # Gateway.deploy kwargs,
        # applied on successful COMPLETION only: a permanently failed
        # deploy step must not leave a live deployment behind
        self.pending: Optional[dict] = None   # in-flight attempt bookkeeping
        self.span = None                 # pipeline.step span (tracer only)
        self.attempt_span = None         # current pipeline.attempt span
        # market mode only (shared_capacity): live / speculative-backup
        # attempt info dicts -- the preemption victim registry
        self.live: Optional[dict] = None
        self.backup: Optional[dict] = None


class Orchestrator:
    """Event-driven executor over ``{cloud: worker pool}`` slots.

    clusters: {CloudProfile | name: n_workers} -- the simulated per-cloud
    clusters steps schedule onto.  policy: "makespan" | "cost" (see module
    docstring).  The ArtifactCache and EventLog persist across execute()
    calls, which is what makes recurring runs cache-hit (runs.py).
    """

    def __init__(self, clusters: dict, *, policy: str = "makespan",
                 retry: Optional[RetryPolicy] = None,
                 cache: Optional[ArtifactCache] = None,
                 log: Optional[EventLog] = None,
                 tracer=None, metrics=None, shared_capacity=None):
        if policy not in ("cost", "makespan"):
            raise ValueError(f"unknown policy {policy!r}")
        self.pools: dict[str, _WorkerPool] = {}
        for key, n in clusters.items():
            prof = key if isinstance(key, CloudProfile) else get_profile(key)
            if int(n) < 1:
                raise ValueError(f"{prof.name}: needs >= 1 worker")
            if prof.name in self.pools:
                raise ValueError(f"duplicate cluster {prof.name!r}")
            self.pools[prof.name] = _WorkerPool(prof, int(n))
        if not self.pools:
            raise ValueError("orchestrator needs at least one cluster")
        self.policy = policy
        self.retry = retry or RetryPolicy()
        self.cache = cache if cache is not None else ArtifactCache()
        self.log = log or EventLog()
        # observability plane (DESIGN.md S5): pipeline.run > pipeline.step
        # > pipeline.attempt > pipeline.transfer span tree on the simulated
        # clock, plus pipeline_* metric series.  Share the tracer with the
        # serving Gateway and the terminal deploy step links the serving
        # trace to this one (Deployment.trace_link).
        self.tracer = tracer
        self.metrics = metrics
        self._run_span = None            # open pipeline.run span (execute)
        # unified capacity market (clouds/capacity.py): when a
        # CapacityMarket is shared with the Gateway, every training attempt
        # takes a spot-style preemptible lease on its cloud's ledger and
        # recorded serving occupancy contends with scheduling.  None (the
        # default) keeps every market-free code path bit-identical.
        self.market = shared_capacity

    # -- outage windows ------------------------------------------------------
    @staticmethod
    def _windows(failures) -> dict:
        out: dict = {}
        for f in failures or []:
            if f.at_s < 0 or f.duration_s <= 0:
                raise ValueError("failure windows need at_s >= 0 and "
                                 "duration_s > 0")
            out.setdefault(f.cloud, []).append(
                (float(f.at_s), float(f.at_s + f.duration_s)))
        for w in out.values():
            w.sort()
        return out

    @staticmethod
    def _down_at(windows: dict, cloud: str, t: float) -> bool:
        return any(a <= t < e for a, e in windows.get(cloud, ()))

    @staticmethod
    def _fails_at(windows: dict, cloud: str, t: float,
                  t_end: float) -> Optional[float]:
        """First outage start strictly inside (t, t_end), else None."""
        for a, _ in windows.get(cloud, ()):
            if t < a < t_end:
                return a
        return None

    # -- input artifacts -----------------------------------------------------
    @staticmethod
    def _dep_indices(step) -> list:
        return list(step.deps)

    def _inputs_blocked(self, st: list, step, windows: dict,
                        t: float) -> bool:
        """True when some input artifact has residency but every resident
        cloud is mid-outage: the control plane cannot fetch it from
        anywhere, so the step must wait for a recovery edge -- the same
        rule the cache-hit path applies.  (Destination-independent.)"""
        for d in self._dep_indices(step):
            clouds = st[d].out_clouds
            if clouds and all(self._down_at(windows, c, t) for c in clouds):
                return True
        return False

    def _plan_inputs(self, st: list, step, cloud: str, windows: dict,
                     t: float) -> list:
        """Transfers needed to make every input local on ``cloud``:
        [(dep_idx, src_cloud, seconds, usd, nbytes)] -- priced by the one
        shared rule (artifacts.best_transfer), sourcing only from clouds
        that are LIVE at ``t`` (a dead cloud cannot serve bytes; callers
        gate on _inputs_blocked first, so a live source exists whenever
        residency is known)."""
        out = []
        dst = self.pools[cloud].profile
        profiles = {c: p.profile for c, p in self.pools.items()}
        for d in self._dep_indices(step):
            s = st[d]
            live = {c for c in (s.out_clouds or ())
                    if not self._down_at(windows, c, t)}
            move = best_transfer(live, s.nbytes, dst, profiles)
            if move is not None:
                src_c, t_s, usd = move
                out.append((d, src_c, t_s, usd, s.nbytes))
        return out

    # -- the run -------------------------------------------------------------
    def execute(self, spec: PipelineSpec, *, t0: float = 0.0,
                failures: Optional[list] = None, gateway=None,
                run_id: Optional[str] = None) -> RunRecord:
        names = [s.name for s in spec.steps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate step names in {spec.name!r}")
        for s in spec.steps:
            if s.pin is not None and s.pin not in self.pools:
                raise ValueError(f"step {s.name!r} pinned to unknown cloud "
                                 f"{s.pin!r}")
            if s.kind == "deploy":
                if s.payload is None:
                    raise ValueError(f"deploy step {s.name!r} needs a "
                                     "DeploySpec payload")
                if gateway is None:
                    raise ValueError(f"deploy step {s.name!r} needs "
                                     "execute(gateway=...)")
            if s.kind == "profile":
                # duck-typed on purpose: importing modelci here would cycle
                # (modelci -> pipelines.artifacts -> this module)
                p = s.payload
                if p is None or not getattr(p, "model", None) \
                        or not hasattr(getattr(p, "store", None), "put"):
                    raise ValueError(f"profile step {s.name!r} needs a "
                                     "ProfileSpec payload (model + store)")
        toposort([list(s.deps) for s in spec.steps])   # cycle check
        run_id = run_id or spec.name
        windows = self._windows(failures)
        for pool in self.pools.values():
            pool.busy = 0
        if self.tracer is not None:
            self._run_span = self.tracer.start(
                "pipeline.run", float(t0), run_id=run_id,
                pipeline=spec.name)

        st = [_StepState(StepRecord(s.name)) for s in spec.steps]
        children: list = [[] for _ in spec.steps]
        for s in spec.steps:
            for d in s.deps:
                children[d].append(s.index)
        indeg = [len(s.deps) for s in spec.steps]

        events = EventHeap()             # shared sim core (sim/engine.py)
        ready: set = set()
        for s in spec.steps:
            if indeg[s.index] == 0:
                events.push(float(t0), "ready", s.index)
        for cloud, ws in windows.items():
            for _, end in ws:            # recovery edges re-arm scheduling
                events.push(end, "recover", cloud)
        cap_woken: set = set()           # dedup for ledger wake-up events
        if self.market is not None:
            # recorded serving rise-edges from an earlier gateway run on
            # the shared market: at each edge the cloud may over-commit,
            # killing the youngest training lease (spot semantics)
            for cloud in self.pools:
                led = self.market.ledger(cloud)
                if led is not None:
                    for edge in led.serving_edges(lo=float(t0)):
                        events.push(edge, "capacity", cloud)
        self._worker_gauges()

        t_last = float(t0)
        wall0 = time.perf_counter()

        def cascade_skip(i: int, t: float) -> None:
            stack = list(children[i])
            while stack:
                j = stack.pop()
                if st[j].status in ("pending", "ready"):
                    st[j].status = "skipped"
                    st[j].record.status = "skipped"
                    ready.discard(j)
                    self.log.record("pipeline:skip", 0.0, step=names[j],
                                    reason="upstream", t_sim=round(t, 6))
                    stack.extend(children[j])

        def finish(i: int, t: float, pend: dict) -> None:
            nonlocal t_last
            s = st[i]
            rec = s.record
            s.status = "done"
            rec.status = "done"
            rec.cloud = pend["cloud"]
            rec.cached = pend["cached"]
            rec.end_s = t
            t_last = max(t_last, t)
            if pend["cached"]:
                s.output = pend["value"]
                s.entry = pend["entry"]
                s.out_clouds = pend["entry"].clouds
                s.nbytes = pend["entry"].nbytes
                pend["entry"].hits += 1
            else:
                self.pools[pend["cloud"]].busy -= 1
                att = rec.attempts[pend.get("att_idx", -1)]
                att["end_s"] = t
                att["status"] = "ok"
                att["cost_usd"] = pend["cost"]
                rec.cost_usd += pend["cost"]
                self._worker_gauges()
                if pend["key"] is not None:
                    s.entry = self.cache.put(pend["key"], s.output,
                                             names[i], pend["cloud"])
                    s.out_clouds = s.entry.clouds
                    s.nbytes = s.entry.nbytes
                else:
                    s.out_clouds = {pend["cloud"]}
                    s.nbytes = payload_bytes(s.output)
                for d, _src, _ts, _usd, _nb in pend["transfers"]:
                    if st[d].entry is not None:
                        self.cache.commit_transfer(st[d].entry, pend["cloud"])
                    else:
                        st[d].out_clouds.add(pend["cloud"])
            if s.deploy_apply is not None:
                # the handoff side effect happens exactly once, HERE: a
                # deploy step that never completes never touches the fleet
                if self.tracer is not None and s.span is not None:
                    # the serving gateway links every request span of this
                    # model back to THIS deploy step span: the cross-trace
                    # edge that makes one train-to-serve run one connected
                    # trace (telemetry/trace.py)
                    s.deploy_apply["trace_link"] = s.span.span_id
                gateway.deploy(**s.deploy_apply)
                s.deploy_apply = None
            if s.deploy_info is not None:
                self.log.record("pipeline:deploy", 0.0, step=names[i],
                                t_sim=round(t, 6), **s.deploy_info)
            if spec.steps[i].kind == "profile":
                # runs on cached completions too: a cache-hit recurring
                # firing must still refresh the store's `latest` pointer
                self._profile_commit(spec.steps[i], s, pend["cloud"], t)
            self.log.record("pipeline:step", pend["dur"], step=names[i],
                            cloud=pend["cloud"], cached=pend["cached"],
                            attempts=len(rec.attempts),
                            cost=round(rec.cost_usd, 10), t_sim=round(t, 6))
            if self.tracer is not None:
                sp = pend.get("span")
                if sp is not None and sp.t1 is None:
                    self.tracer.end(sp, t)
                if s.span is not None:
                    self.tracer.end(s.span, t, cloud=pend["cloud"],
                                    cached=pend["cached"], status="done")
                    rec.span_id = s.span.span_id
            if self.metrics is not None:
                self.metrics.histogram("pipeline_step_seconds",
                                       pipeline=spec.name,
                                       step=names[i]).observe(pend["dur"])
                if pend["cached"]:
                    self.metrics.counter("pipeline_cache_hits_total",
                                         pipeline=spec.name).inc()
            for j in children[i]:
                indeg[j] -= 1
                if indeg[j] == 0 and st[j].status == "pending":
                    st[j].status = "ready"
                    ready.add(j)

        def perm_fail(i: int, t: float, reason: str) -> None:
            nonlocal t_last
            st[i].status = "failed"
            st[i].record.status = "failed"
            st[i].record.end_s = t
            t_last = max(t_last, t)
            self.log.record("pipeline:fail", 0.0, step=names[i],
                            attempts=len(st[i].record.attempts),
                            reason=reason, t_sim=round(t, 6))
            if self.tracer is not None and st[i].span is not None:
                if st[i].attempt_span is not None \
                        and st[i].attempt_span.t1 is None:
                    self.tracer.end(st[i].attempt_span, t, status=reason)
                self.tracer.end(st[i].span, t, status="failed",
                                reason=reason)
                st[i].record.span_id = st[i].span.span_id
            cascade_skip(i, t)

        def kill_attempt(i: int, info: dict, t: float, status: str) -> None:
            """Market mode: close a live attempt early (preempted by a
            serving rise-edge, or cancelled as the losing side of a
            speculative pair).  The fn already ran exactly once; only the
            simulated occupancy is torn down."""
            nonlocal t_last
            s = st[i]
            info["dead"] = True          # stale done/abort events no-op
            self.pools[info["cloud"]].busy -= 1
            if info.get("lease") is not None:
                self.market.ledger(info["cloud"]).release(
                    info["lease"], t, status=status)
            cost = (t - info["start"]) \
                * self.pools[info["cloud"]].profile.cost_per_s \
                + info["tr_usd"]
            att = s.record.attempts[info["att_idx"]]
            att["end_s"] = t
            att["status"] = status
            att["cost_usd"] = cost
            s.record.cost_usd += cost
            t_last = max(t_last, t)
            if self.tracer is not None:
                for tsp in info.get("spans", ()):
                    if tsp.t1 is None or tsp.t1 > t:
                        self.tracer.end(tsp, t, truncated=True)
                asp = info.get("att_span")
                if asp is not None and asp.t1 is None:
                    self.tracer.end(asp, t, status=status)
            if s.live is info:
                s.live = None
            if s.backup is info:
                s.backup = None
            if s.pending is info:
                s.pending = None         # the scheduled abort is void
            self._worker_gauges()

        def preempt_training(cloud: str, t: float) -> bool:
            """Kill the youngest live training attempt on ``cloud`` (max
            start time, ties by attempt/step order).  The killed attempt
            re-enters the normal RetryPolicy backoff path -- unless its
            speculative twin is still running, which then IS the retry."""
            cands = []
            for j, s2 in enumerate(st):
                for info in (s2.live, s2.backup):
                    if info is not None and not info.get("dead") \
                            and info["cloud"] == cloud:
                        cands.append((info["start"], info["att_idx"], j,
                                      info))
            if not cands:
                return False
            _, _, j, info = max(cands, key=lambda x: x[:3])
            kill_attempt(j, info, t, "preempted")
            s2 = st[j]
            self.log.record("capacity:preempt", 0.0, step=names[j],
                            cloud=cloud, attempt=info["att_idx"] + 1,
                            t_sim=round(t, 6))
            if s2.live is None and s2.backup is not None:
                s2.live = s2.backup      # surviving twin carries on
                s2.backup = None
            if s2.live is not None:
                return True
            n_att = len(s2.record.attempts)
            if n_att > self.retry.max_retries:
                perm_fail(j, t, "preempted")
            else:
                nxt = t + self.retry.delay_s(n_att - 1)
                s2.status = "retry_wait"
                self.log.record("pipeline:retry", 0.0, step=names[j],
                                cloud=cloud, attempt=n_att,
                                t_sim=round(t, 6), next_s=round(nxt, 6),
                                reason="preempt")
                events.push(nxt, "ready", j)
            return True

        def market_edges(t: float) -> None:
            """A recorded serving rise-edge may over-commit a cloud whose
            slots are partly held by open training leases: preempt the
            youngest until the committed timeline fits again."""
            for cloud in sorted(self.market.ledgers):
                led = self.market.ledgers[cloud]
                while led.used(t) > led.slots:
                    if not preempt_training(cloud, t):
                        break            # nothing left to evict here

        def schedule(t: float) -> None:
            for i in sorted(ready):
                step = spec.steps[i]
                s = st[i]
                # cache hit: the control plane reuses the artifact without
                # starting a pod -- no worker, no startup, one rtt to the
                # resident cloud (Kubeflow step caching)
                key = None
                if step.cache:
                    if not s.key_done:
                        args = tuple(self._resolve(st, a) for a in step.args)
                        kwargs = {k: self._resolve(st, v)
                                  for k, v in step.kwargs.items()}
                        s.cache_key = step_cache_key(
                            spec.name, step.name, step.fn, args, kwargs)
                        s.key_done = True
                    key = s.cache_key
                    entry = self.cache.get(key)
                    if entry is not None:
                        # serve the hit from a LIVE resident cloud; if the
                        # artifact lives only on dead clouds the control
                        # plane cannot fetch it -- wait for recovery (an
                        # outage must hit cached recurring runs too)
                        homes = sorted(entry.clouds)
                        live = [c for c in homes
                                if not self._down_at(windows, c, t)]
                        if homes and not live:
                            continue

                        def _prof(c):
                            # a resident cloud outside this cluster map (a
                            # retired cluster's store entry) still prices
                            # its own control-plane RTT -- same PROFILES
                            # fallback as best_transfer
                            p = self.pools.get(c)
                            return p.profile if p else PROFILES.get(c)

                        # fastest live resident cloud serves the hit, the
                        # same fastest-then-name rule best_transfer uses
                        home = min(
                            live,
                            key=lambda c: ((_prof(c).network_rtt_s
                                            if _prof(c) else 0.0), c)) \
                            if live else None
                        hp = _prof(home) if home else None
                        rtt = hp.network_rtt_s if hp else 0.0
                        s.status = "running"
                        ready.discard(i)
                        s.record.start_s = t
                        self.log.record("pipeline:cache_hit", 0.0,
                                        step=names[i], key=key,
                                        cloud=home, t_sim=round(t, 6))
                        hit_span = None
                        if self.tracer is not None:
                            if s.span is None:
                                s.span = self.tracer.start(
                                    "pipeline.step", t,
                                    parent=self._run_span, step=names[i],
                                    deps=[names[d] for d in step.deps])
                            hit_span = self.tracer.start(
                                "pipeline.attempt", t, parent=s.span,
                                cloud=home, cached=True, control_s=rtt,
                                transfer_s=0.0, compute_s=0.0)
                        events.push(
                            t + rtt, "done",
                            (i, {"cloud": home, "cached": True,
                                 "value": entry.value, "entry": entry,
                                 "dur": rtt, "cost": 0.0, "key": None,
                                 "transfers": [], "span": hit_span}))
                        continue
                if self._inputs_blocked(st, step, windows, t):
                    continue             # inputs live only on dead clouds:
                cands = [p for c, p in self.pools.items()   # wait, like a
                         if p.free() > 0                    # cache hit would
                         and not self._down_at(windows, c, t)
                         and (step.pin is None or step.pin == c)]
                if self.market is not None and cands:
                    # the ledger is the source of truth: a cloud whose
                    # slots are taken (serving occupancy + reserve) admits
                    # no new training lease at t -- the step waits for the
                    # next recorded lease end (wake-up event)
                    open_ = [p for p in cands
                             if self.market.training_free(
                                 p.profile.name, t) > 0]
                    if not open_:
                        for p in cands:
                            led = self.market.ledger(p.profile.name)
                            nxt = (led.next_release_after(t)
                                   if led is not None else None)
                            if nxt is not None and nxt not in cap_woken:
                                cap_woken.add(nxt)
                                events.push(nxt, "recover", p.profile.name)
                    cands = open_
                if not cands:
                    continue             # stays ready; a done/abort/recover
                ready.discard(i)         # event re-runs this pass
                pool = min(cands, key=lambda p: self._rank(st, step, p,
                                                           windows, t))
                transfers = self._plan_inputs(st, step, pool.profile.name,
                                              windows, t)
                self._start_attempt(spec, st, i, pool, t, key, transfers,
                                    windows, events, perm_fail)

        while events:
            # collect-then-apply batching: a same-t push during the batch
            # (e.g. a zero-RTT cache hit) lands in the NEXT batch, then
            # schedule(t) runs again at the same timestamp -- the
            # orchestrator's historical semantics, kept by pop_batch()
            t, batch = events.pop_batch()
            for kind, data in batch:
                if kind == "ready":
                    if st[data].status == "pending":
                        st[data].status = "ready"
                        ready.add(data)
                    elif st[data].status == "retry_wait":
                        st[data].status = "ready"
                        ready.add(data)
                elif kind == "recover":
                    pass                 # scheduling pass below re-checks
                elif kind == "capacity":
                    market_edges(t)      # serving rise-edge on `data` cloud
                elif kind == "done":
                    i, pend = data
                    if self.market is not None and not pend["cached"]:
                        info = pend.get("info")
                        if info is not None:
                            if info.get("dead"):
                                continue  # preempted/cancelled: stale done
                            s2 = st[i]
                            if info.get("lease") is not None:
                                self.market.ledger(info["cloud"]).release(
                                    info["lease"], t)
                            info["dead"] = True
                            loser = (s2.backup if s2.live is info
                                     else s2.live)
                            if s2.live is info:
                                s2.live = None
                            else:
                                s2.backup = None
                            if loser is not None and not loser.get("dead"):
                                # the speculative twin lost the race:
                                # cancel it through the ledger
                                kill_attempt(i, loser, t, "cancelled")
                    finish(i, t, pend)
                else:                    # "abort": outage killed the attempt
                    i = data
                    s = st[i]
                    pend = s.pending
                    if self.market is not None \
                            and (pend is None or pend.get("dead")):
                        continue         # already torn down via the market
                    s.pending = None
                    self.pools[pend["cloud"]].busy -= 1
                    if self.market is not None:
                        pend["dead"] = True
                        if pend.get("lease") is not None:
                            # with a live speculative twin the outage ends
                            # the race: the twin is promoted below and the
                            # primary is the cancelled loser in the audit
                            self.market.ledger(pend["cloud"]).release(
                                pend["lease"], t,
                                status=("cancelled" if s.backup is not None
                                        else "released"))
                        if s.live is pend:
                            s.live = None
                    self._worker_gauges()
                    cost = (t - pend["start"]) \
                        * self.pools[pend["cloud"]].profile.cost_per_s \
                        + pend["tr_usd"]
                    att = s.record.attempts[pend.get("att_idx", -1)]
                    att["end_s"] = t
                    att["status"] = "outage"
                    att["cost_usd"] = cost
                    s.record.cost_usd += cost
                    t_last = max(t_last, t)
                    if self.tracer is not None:
                        # the outage truncates the attempt (and any
                        # in-flight transfer child) at the window start
                        for tsp in pend.get("spans", ()):
                            if tsp.t1 is None or tsp.t1 > t:
                                self.tracer.end(tsp, t, truncated=True)
                        asp = pend.get("att_span", s.attempt_span)
                        if asp is not None and asp.t1 is None:
                            self.tracer.end(asp, t, status="outage")
                    n_att = len(s.record.attempts)
                    if self.market is not None and s.backup is not None:
                        s.live = s.backup   # the speculative backup IS the
                        s.backup = None     # retry: no backoff re-entry
                    elif n_att > self.retry.max_retries:
                        perm_fail(i, t, "outage")
                    else:
                        nxt = t + self.retry.delay_s(n_att - 1)
                        s.status = "retry_wait"
                        self.log.record("pipeline:retry", 0.0, step=names[i],
                                        cloud=pend["cloud"], attempt=n_att,
                                        t_sim=round(t, 6),
                                        next_s=round(nxt, 6),
                                        reason="outage")
                        events.push(nxt, "ready", i)
            schedule(t)

        bad = [names[i] for i, s in enumerate(st)
               if s.status not in ("done", "failed", "skipped")]
        if bad:
            raise RuntimeError(f"orchestrator stalled on {bad}")

        steps = {names[i]: s.record for i, s in enumerate(st)}
        status = ("succeeded" if all(s.status == "done" for s in st)
                  else "failed")
        rec = RunRecord(
            run_id, spec.name, status, float(t0), t_last, steps,
            {names[i]: s.output for i, s in enumerate(st)
             if s.status == "done"},
            cost_usd=sum(r.cost_usd for r in steps.values()),
            cache_hits=sum(1 for r in steps.values() if r.cached))
        self.log.record("pipeline:run", rec.makespan_s, run_id=run_id,
                        pipeline=spec.name, status=status,
                        cost=round(rec.cost_usd, 10),
                        wall_s=round(time.perf_counter() - wall0, 4))
        if self.tracer is not None and self._run_span is not None:
            self.tracer.end(self._run_span, t_last, status=status)
            rec.span_id = self._run_span.span_id
            self._run_span = None
        if self.metrics is not None:
            self.metrics.counter("pipeline_runs_total", pipeline=spec.name,
                                 status=status).inc()
            self.metrics.counter("pipeline_cost_usd_total",
                                 pipeline=spec.name).inc(rec.cost_usd)
        return rec

    # -- attempt machinery ---------------------------------------------------
    @staticmethod
    def _resolve(st: list, v: Any):
        if isinstance(v, StepRef):
            return st[v.index].output
        return v

    def _rank(self, st: list, step, pool: _WorkerPool, windows: dict,
              t: float) -> tuple:
        """Policy key for one eligible pool (lower is better).  The
        completion estimate only counts KNOWN terms: control-plane
        constants, the transfer plan, and the compute duration when it is
        analytic (sim_s) or already measured by an earlier attempt."""
        prof = pool.profile
        tr = sum(x[2] for x in self._plan_inputs(st, step, prof.name,
                                                 windows, t))
        known = step.sim_s if step.sim_s is not None else (
            st[step.index].compute_s if st[step.index].executed else 0.0)
        est = prof.startup_s + prof.network_rtt_s + tr + known
        if self.policy == "cost":
            return (prof.cost_per_s, est, prof.name)
        return (est, prof.cost_per_s, prof.name)

    def _start_attempt(self, spec, st, i: int, pool: _WorkerPool, t: float,
                       key, transfers, windows, events: EventHeap,
                       perm_fail) -> None:
        step = spec.steps[i]
        s = st[i]
        names = step.name
        cloud = pool.profile.name
        tr_s = sum(x[2] for x in transfers)
        tr_usd = sum(x[3] for x in transfers)
        if self.tracer is not None and s.span is None:
            # opened on the FIRST attempt (exception paths included) and
            # closed by finish/perm_fail; deps attr carries the dependency
            # step names the critical-path walk follows
            s.span = self.tracer.start(
                "pipeline.step", t, parent=self._run_span, step=names,
                deps=[spec.steps[d].name for d in step.deps])
        if not s.executed:
            args = tuple(self._resolve(st, a) for a in step.args)
            kwargs = {k: self._resolve(st, v)
                      for k, v in step.kwargs.items()}
            w0 = time.perf_counter()
            try:
                s.output = step.fn(*args, **kwargs)
            except Exception as e:       # authoring bug, not an outage:
                s.executed = True        # fail fast, no retries
                s.record.start_s = t
                s.record.attempts.append(
                    {"cloud": cloud, "start_s": t, "end_s": t,
                     "status": "exception", "cost_usd": 0.0})
                perm_fail(i, t, f"exception:{type(e).__name__}")
                return
            _device_sync()
            wall = time.perf_counter() - w0
            s.executed = True
            s.compute_s = step.sim_s if step.sim_s is not None else wall
            if step.kind == "deploy":
                ok = self._plan_handoff(step, s)
                if not ok:
                    s.record.start_s = t
                    s.record.attempts.append(
                        {"cloud": cloud, "start_s": t, "end_s": t,
                         "status": "infeasible", "cost_usd": 0.0})
                    perm_fail(i, t, "deploy_infeasible")
                    return
        dur = (pool.profile.startup_s + pool.profile.network_rtt_s
               + tr_s + s.compute_s + s.extra_s)
        t_end = t + dur
        s.status = "running"
        if not s.record.attempts:
            s.record.start_s = t
        s.record.compute_s = s.compute_s
        s.record.transfer_s += tr_s
        s.record.transfer_cost_usd += tr_usd
        s.record.attempts.append({"cloud": cloud, "start_s": t,
                                  "end_s": t_end, "status": "ok",
                                  "cost_usd": 0.0})
        pool.busy += 1
        lease = None
        if self.market is not None:
            led = self.market.ledger(cloud)
            if led is not None:
                lease = led.lease("training", f"{spec.name}:{names}", t)
                self.log.record("capacity:lease", 0.0, cloud=cloud,
                                kind="training", step=names,
                                t_sim=round(t, 6))
        self._worker_gauges()
        self.log.record("pipeline:schedule", 0.0, step=names, cloud=cloud,
                        attempt=len(s.record.attempts), t_sim=round(t, 6))
        att_span = None
        tspans = []
        if self.tracer is not None:
            # attempt attrs carry the simulated-time decomposition the
            # critical-path analyzer reads back: control (startup + rtt +
            # deploy model loads), transfer, compute
            att_span = s.attempt_span = self.tracer.start(
                "pipeline.attempt", t, parent=s.span, cloud=cloud,
                attempt=len(s.record.attempts),
                control_s=(pool.profile.startup_s
                           + pool.profile.network_rtt_s + s.extra_s),
                transfer_s=tr_s, compute_s=s.compute_s)
        for d, src, t_tr, usd, nb in transfers:
            self.log.record("pipeline:transfer", t_tr, step=names,
                            src=src, dst=cloud, bytes=int(nb),
                            cost=round(usd, 10), t_sim=round(t, 6))
            if self.tracer is not None:
                tsp = self.tracer.start("pipeline.transfer", t,
                                        parent=att_span, src=src, dst=cloud,
                                        bytes=int(nb))
                self.tracer.end(tsp, t + t_tr)
                tspans.append(tsp)
        att_idx = len(s.record.attempts) - 1
        info = None
        if self.market is not None:
            info = {"cloud": cloud, "start": t, "tr_usd": tr_usd,
                    "spans": tspans, "lease": lease, "att_idx": att_idx,
                    "att_span": att_span, "dead": False}
            s.live = info
        t_f = self._fails_at(windows, cloud, t, t_end)
        if t_f is not None:
            s.pending = info if info is not None else \
                {"cloud": cloud, "start": t, "tr_usd": tr_usd,
                 "spans": tspans, "att_idx": att_idx}
            events.push(t_f, "abort", i)
            if info is not None:
                # the outage window threatens this attempt: hedge with a
                # speculative backup on a second cloud -- the loser is
                # cancelled via the ledger
                self._speculate(spec, st, i, t, key, windows, events)
            return
        cost = dur * pool.profile.cost_per_s + tr_usd
        pend = {"cloud": cloud, "cached": False, "dur": dur, "cost": cost,
                "key": key, "transfers": transfers, "span": att_span,
                "att_idx": att_idx}
        if info is not None:
            pend["info"] = info
        events.push(t_end, "done", (i, pend))

    def _worker_gauges(self) -> None:
        """Expose cluster occupancy to the metrics plane: the
        gauges are refreshed on every busy/free transition and frozen by
        whatever scrape runs next (e.g. a shared registry's gateway
        scrape loop)."""
        if self.metrics is None:
            return
        for c in sorted(self.pools):
            p = self.pools[c]
            self.metrics.gauge("pipeline_workers_busy", cloud=c).set(p.busy)
            self.metrics.gauge("pipeline_workers_free",
                               cloud=c).set(p.free())

    def _speculate(self, spec, st, i: int, t: float, key, windows,
                   events: EventHeap) -> None:
        """Market mode: the just-started attempt is doomed by a known
        outage window.  Launch a backup attempt of the same step on a
        second cloud that (a) has a free worker and a free ledger slot and
        (b) survives its own duration -- the first attempt to complete
        wins and the loser is cancelled through the ledger.  The fn is
        NOT re-run (exactly once); the backup replays the measured
        compute under the alternate cloud's control-plane constants."""
        step = spec.steps[i]
        s = st[i]
        prim = s.live["cloud"]
        cands = []
        for c, p in self.pools.items():
            if c == prim or p.free() <= 0 \
                    or self._down_at(windows, c, t) \
                    or (step.pin is not None and step.pin != c) \
                    or self.market.training_free(c, t) <= 0:
                continue
            transfers = self._plan_inputs(st, step, c, windows, t)
            tr_s = sum(x[2] for x in transfers)
            dur = (p.profile.startup_s + p.profile.network_rtt_s + tr_s
                   + s.compute_s + s.extra_s)
            if self._fails_at(windows, c, t, t + dur) is not None:
                continue                 # a doomed backup hedges nothing
            cands.append((self._rank(st, step, p, windows, t), c, p,
                          transfers, tr_s, dur))
        if not cands:
            return
        _, cloud, pool, transfers, tr_s, dur = min(cands,
                                                   key=lambda x: x[0])
        tr_usd = sum(x[3] for x in transfers)
        t_end = t + dur
        led = self.market.ledger(cloud)
        lease = None
        if led is not None:
            lease = led.lease("training", f"{spec.name}:{step.name}", t)
            if lease is None:
                return                   # lost the slot; no hedge
            self.log.record("capacity:lease", 0.0, cloud=cloud,
                            kind="training", step=step.name,
                            t_sim=round(t, 6))
        pool.busy += 1
        s.record.transfer_s += tr_s
        s.record.transfer_cost_usd += tr_usd
        s.record.attempts.append({"cloud": cloud, "start_s": t,
                                  "end_s": t_end, "status": "ok",
                                  "cost_usd": 0.0})
        att_idx = len(s.record.attempts) - 1
        self._worker_gauges()
        self.log.record("capacity:speculate", 0.0, step=step.name,
                        cloud=cloud, primary=prim, attempt=att_idx + 1,
                        t_sim=round(t, 6))
        self.log.record("pipeline:schedule", 0.0, step=step.name,
                        cloud=cloud, attempt=att_idx + 1,
                        t_sim=round(t, 6))
        att_span = None
        tspans = []
        if self.tracer is not None:
            att_span = self.tracer.start(
                "pipeline.attempt", t, parent=s.span, cloud=cloud,
                attempt=att_idx + 1, speculative=True,
                control_s=(pool.profile.startup_s
                           + pool.profile.network_rtt_s + s.extra_s),
                transfer_s=tr_s, compute_s=s.compute_s)
        for d, src, t_tr, usd, nb in transfers:
            self.log.record("pipeline:transfer", t_tr, step=step.name,
                            src=src, dst=cloud, bytes=int(nb),
                            cost=round(usd, 10), t_sim=round(t, 6))
            if self.tracer is not None:
                tsp = self.tracer.start("pipeline.transfer", t,
                                        parent=att_span, src=src,
                                        dst=cloud, bytes=int(nb))
                self.tracer.end(tsp, t + t_tr)
                tspans.append(tsp)
        info = {"cloud": cloud, "start": t, "tr_usd": tr_usd,
                "spans": tspans, "lease": lease, "att_idx": att_idx,
                "att_span": att_span, "dead": False}
        s.backup = info
        cost = dur * pool.profile.cost_per_s + tr_usd
        events.push(t_end, "done",
                    (i, {"cloud": cloud, "cached": False, "dur": dur,
                         "cost": cost, "key": key, "transfers": transfers,
                         "span": att_span, "att_idx": att_idx,
                         "info": info}))

    def _profile_commit(self, step, s: _StepState, cloud: Optional[str],
                        t: float) -> None:
        """kind="profile" terminal side effect: stamp the executing
        cloud's constants onto the fn's raw measurement dict and commit
        the ModelProfile artifact into the spec's store.  ``cloud`` is the
        pin when set (per-cloud profiling DAGs pin their steps), else the
        cloud the attempt/cache-hit landed on."""
        from ..modelci.profile import finalize   # lazy: modelci imports
        ps = step.payload                        # pipelines.artifacts
        if not isinstance(s.output, dict):
            raise TypeError(f"profile step {step.name!r} fn must return "
                            "the raw profile field dict "
                            "(modelci.measure / roofline_fields)")
        name = step.pin or cloud
        pool = self.pools.get(name) if name else None
        prof = pool.profile if pool else PROFILES.get(name)
        if prof is None:                 # retired cluster / unknown pool:
            prof = next(iter(self.pools.values())).profile
        mp = finalize(s.output, ps.model, prof)
        ps.store.put(mp)
        self.log.record("modelci:profile", 0.0, step=step.name,
                        model=ps.model, cloud=mp.cloud, key=mp.key,
                        service_time_s=round(mp.service_time_s, 9),
                        source=mp.source, t_sim=round(t, 6))
        if self.metrics is not None:
            self.metrics.counter("modelci_profiles_total",
                                 model=ps.model, cloud=mp.cloud).inc()

    def _plan_handoff(self, step, s: _StepState) -> bool:
        """Deploy planning: size a placement from the backend's measured
        service time -- or, with ``DeploySpec.profile`` set, from the
        committed Model-CI profile artifacts (ProfileStore.demand), so no
        hand-tuned service-time constant enters the plan.  The
        Gateway.deploy call itself is DEFERRED to the step's successful
        completion (finish) so a deploy step that permanently fails leaves
        no live deployment behind.  The fn's output (the backend) is
        replaced by a JSON-able summary; the backend itself lives on
        inside the prepared deploy kwargs."""
        from ..serving.gateway.placement import ModelDemand, plan_placement
        ds: DeploySpec = step.payload
        backend = s.output
        planned_profile = None
        if ds.profile is not None:
            cnames = [cc.profile.name for cc in ds.clouds]
            try:
                planned_profile = ds.profile.worst(ds.model, cnames)
            except KeyError:
                return False             # no artifacts: deploy_infeasible
            dem = planned_profile.demand(rate=ds.rate,
                                         load_erlangs=ds.load_erlangs)
            svc, rate = dem.service_time_s, dem.rate
        else:
            svc = backend.service_time(ds.max_batch) / ds.max_batch
            rate = ds.rate if ds.rate is not None else ds.load_erlangs / svc
            dem = ModelDemand(ds.model, rate, svc)
        clouds = ds.clouds
        if self.market is not None:
            # placement headroom reads the ledger: a cloud can never host
            # more replicas than its market slots (serving holds priority,
            # so the full slot count -- not slots minus reserve -- bounds)
            clouds = [
                cc if self.market.ledger(cc.profile.name) is None
                else dataclasses.replace(
                    cc, max_replicas=min(
                        cc.max_replicas,
                        self.market.ledger(cc.profile.name).slots))
                for cc in ds.clouds]
        plan = plan_placement([dem], clouds,
                              objective=ds.objective, split=ds.split)
        a = plan.assignments[0]
        if not plan.feasible or not a.shares:
            return False
        profiles = {c.profile.name: c.profile for c in ds.clouds}
        s.deploy_apply = dict(
            name=ds.model, backend=backend,
            split={profiles[c]: w for c, w in a.weights.items()},
            autoscaler=ds.autoscaler, max_batch=ds.max_batch,
            queue_hint=dict(a.est_wait_s))
        if planned_profile is not None:
            # the drift monitor compares serving observations against the
            # exact artifact the placement was planned from
            s.deploy_apply["planned_from"] = planned_profile
        # weights loaded onto every serving cloud: one model_load_s each
        s.extra_s = sum(profiles[c].model_load_s for c in a.shares)
        s.deploy_info = {"model": ds.model,
                         "weights": {c: round(w, 6)
                                     for c, w in a.weights.items()},
                         "replicas": dict(a.shares),
                         "cost_hr": round(a.cost_hr, 6),
                         "profiled": planned_profile is not None}
        s.output = {"model": ds.model, "weights": dict(a.weights),
                    "replicas": dict(a.shares), "cost_hr": a.cost_hr,
                    "est_p99_s": a.est_p99_s,
                    "profiled": planned_profile is not None}
        return True
