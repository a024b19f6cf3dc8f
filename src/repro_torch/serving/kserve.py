"""KServe analog: a model version behind an InferenceService.

Counterpart of ``repro.serving.kserve`` and of the ``Predictor`` /
``ServeResult`` it re-exports from the gateway.  Two of the paper's
deployment strategies are ported:
  baremetal -- model re-loaded on EVERY request, no batching, sequential
  k8s       -- persistent model behind a LoadBalancer, batch=1, sequential
The ``kserve`` strategy runs the multi-model gateway, which is not ported
yet (ROADMAP.md queue 1 item 1.3).

Compute latencies are measured: ``Predictor.service_time`` times real
predicts on the predictor's device and, on a CUDA device, waits for the
card with ``torch.cuda.synchronize`` before it reads the clock.  Network,
load-balancer and reload constants come from the CloudProfile (simulated).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..clouds.profiles import CloudProfile
from ..telemetry.events import EventLog

STRATEGIES = ("baremetal", "k8s", "kserve")


def _pow2(b: int) -> int:
    """Service times are measured on pow2 batch buckets."""
    n = 1
    while n < b:
        n *= 2
    return n


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


@dataclasses.dataclass
class ServeResult:
    strategy: str
    n_requests: int
    total_time_s: float
    latencies_s: list
    replica_trace: list = dataclasses.field(default_factory=list)
    # SIMULATED dollars (CloudProfile.cost_per_s price sheet), never measured
    cost_usd: float = 0.0
    cost_by_cloud: dict = dataclasses.field(default_factory=dict)

    @property
    def p50(self) -> Optional[float]:
        return float(np.percentile(self.latencies_s, 50)) if self.latencies_s else None

    @property
    def p99(self) -> Optional[float]:
        return float(np.percentile(self.latencies_s, 99)) if self.latencies_s else None

    def summary(self) -> dict:
        p50, p99 = self.p50, self.p99
        return {"strategy": self.strategy, "n": self.n_requests,
                "total_s": round(self.total_time_s, 4),
                "p50_s": round(p50, 4) if p50 is not None else None,
                "p99_s": round(p99, 4) if p99 is not None else None,
                "replicas_max": max([r for _, r in self.replica_trace], default=1),
                **({"sim_cost_usd": round(self.cost_usd, 6)}
                   if self.cost_by_cloud else {})}


class InferenceService:
    def __init__(self, predictor: Predictor, profile: CloudProfile,
                 strategy: str = "k8s", *, log: Optional[EventLog] = None):
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy {strategy!r}; known: {STRATEGIES}")
        self.predictor = predictor
        self.profile = profile
        self.strategy = strategy
        self.log = log or EventLog()

    def stress_test(self, n_requests: int) -> ServeResult:
        """The paper's stress test: ``n_requests`` arrive at t=0."""
        if self.strategy == "kserve":
            raise NotImplementedError(
                "the kserve strategy needs the multi-model gateway, which is not "
                "ported yet: ROADMAP.md queue 1 item 1.3")
        with self.log.stage(f"serve:{self.strategy}", n=n_requests):
            return self._sequential(n_requests, reload_each=self.strategy == "baremetal")

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
        cost = clock * p.cost_per_s
        return ServeResult(self.strategy, n, clock, lat, [(0.0, 1)],
                           cost_usd=cost, cost_by_cloud={p.name: cost})
