"""KServe analog: InferenceService with the paper's deployment strategies.

Counterpart of ``repro.serving.kserve``.  Strategies (paper Table 3
columns):
  baremetal -- model re-loaded on EVERY request, no batching, sequential
  k8s       -- persistent model behind a LoadBalancer, batch=1, sequential
  kserve    -- dynamic batching + queue-depth autoscaling + optional canary
               traffic split, on a CloudProfile (gcp / ibm), through the
               gateway (serving/gateway/router.py)

Compute latencies are measured: ``Predictor.service_time`` times real
predicts on the predictor's device and, on a CUDA device, waits for the
card with ``torch.cuda.synchronize`` before it reads the clock.  Network,
load-balancer and reload constants come from the CloudProfile (simulated).

InferenceService is the gateway's single-model client: one Deployment,
KPA knobs (min_replicas >= 1, no idle scale-down, warm scale-up).
Predictor / ServeResult are re-exported from the router.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..clouds.profiles import CloudProfile
from ..telemetry.events import EventLog
from .gateway.autoscaler import AutoscalerConfig
from .gateway.router import (AdmissionConfig, Gateway,  # noqa: F401
                             Predictor, ServeResult, TrafficSpec, _pow2)

STRATEGIES = ("baremetal", "k8s", "kserve")


class InferenceService:
    def __init__(self, predictor: Predictor, profile: CloudProfile,
                 strategy: str = "kserve", *, max_batch: int = 32,
                 min_replicas: int = 1, max_replicas: int = 4,
                 target_queue: int = 16, scale_up_delay_s: float = 0.5,
                 canary: Optional[Predictor] = None, canary_fraction: float = 0.0,
                 admission: Optional[AdmissionConfig] = None,
                 log: Optional[EventLog] = None,
                 tracer=None, metrics=None):
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy {strategy!r}; known: {STRATEGIES}")
        self.predictor = predictor
        self.profile = profile
        self.strategy = strategy
        self.max_batch = max_batch
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.target_queue = target_queue
        self.scale_up_delay_s = scale_up_delay_s
        self.canary = canary
        self.canary_fraction = canary_fraction
        self.admission = admission       # pass-through: deadline-hopeless
        # requests shed at the gateway (kserve strategy only; the
        # sequential baselines admit everything by construction)
        self.log = log or EventLog()
        self.tracer = tracer             # telemetry pass-through: the
        self.metrics = metrics           # kserve-strategy gateway records
        # request spans / metric series into these (observability plane,
        # DESIGN.md S5); the sequential baselines have no event loop to
        # instrument

    # -- the paper's stress test -------------------------------------------
    def stress_test(self, n_requests: int, seed: int = 0, *,
                    arrival: str = "burst", rate: float = 0.0,
                    slo="standard") -> ServeResult:
        """arrival="burst": all requests at t=0 (the paper's test).
        arrival="poisson": open-loop Poisson arrivals at `rate` req/s
        (measures queueing latency, not just throughput).
        slo: SLO class (name or SLOClass) stamped on every request --
        passed straight through to the gateway, so per-class percentiles
        and deadline-miss rates come back in the result."""
        with self.log.stage(f"serve:{self.strategy}", n=n_requests):
            if self.strategy == "baremetal":
                return self._sequential(n_requests, reload_each=True)
            if self.strategy == "k8s":
                return self._sequential(n_requests, reload_each=False)
            arrivals = None
            if arrival == "poisson":
                rng = np.random.default_rng(seed + 1)
                gaps = rng.exponential(1.0 / max(rate, 1e-9), n_requests)
                arrivals = np.cumsum(gaps)
            return self._kserve_sim(n_requests, seed=seed, arrivals=arrivals,
                                    slo=slo)

    def _sequential(self, n: int, *, reload_each: bool) -> ServeResult:
        p = self.profile
        t_req = self.predictor.service_time(1)
        lat, clock = [], 0.0
        for _ in range(n):
            l = p.network_rtt_s + p.lb_overhead_s + t_req
            if reload_each:
                l += p.model_load_s
            clock += l
            lat.append(l)
        # one always-on replica billed for the whole run (simulated $,
        # profile price sheet -- DESIGN.md §1)
        cost = clock * p.cost_per_s
        return ServeResult(self.strategy, n, clock, lat, [(0.0, 1)],
                           cost_usd=cost, cost_by_cloud={p.name: cost})

    def _kserve_sim(self, n: int, seed: int = 0, arrivals=None,
                    slo="standard") -> ServeResult:
        """One-model gateway run with the KPA semantics: replicas never
        idle out (idle_window=inf) and scale-ups arrive warm (the scale-up
        delay stands in for scheduling + load)."""
        if n == 0:                       # untrafficked models report nothing
            return ServeResult(self.strategy, 0, 0.0, [], [(0.0, 1)])
        cfg = AutoscalerConfig(min_replicas=self.min_replicas,
                               max_replicas=self.max_replicas,
                               target_queue=self.target_queue,
                               scale_up_delay_s=self.scale_up_delay_s,
                               idle_window_s=math.inf, cold_scale_up=False)
        gw = Gateway(log=self.log, admission=self.admission,
                     tracer=self.tracer, metrics=self.metrics)
        gw.deploy(self.predictor.name, self.predictor, self.profile,
                  autoscaler=cfg, max_batch=self.max_batch,
                  canary=self.canary, canary_fraction=self.canary_fraction)
        res = gw.run([TrafficSpec(self.predictor.name, n, arrivals=arrivals,
                                  slo=slo)],
                     seed=seed).per_model[self.predictor.name]
        return ServeResult(self.strategy, n, res.total_time_s,
                           res.latencies_s, res.replica_trace,
                           per_version=res.per_version,
                           class_latencies=res.class_latencies,
                           class_misses=res.class_misses,
                           class_shed=res.class_shed,
                           observed=res.observed,
                           cost_usd=res.cost_usd,
                           cost_by_cloud=res.cost_by_cloud)
