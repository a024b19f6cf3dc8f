"""The port's copy of ``repro.serving.gateway.autoscaler``, whole.

KPA-style autoscaling policy with scale-to-zero (Cox et al.,
arXiv:2007.07366: serverless inferencing makes idle scale-down + cold-start
the defining production behaviors), extended with cost awareness over the
CloudProfile price sheet (active-active splits make "which cloud" a
per-replica decision, not a per-deployment one).

The policy is pure decision logic so it unit-tests without the simulator:
the router observes queue depth / idle time and asks the policy what to do,
then executes the decision inside the discrete-event loop (router.py).

Scale-up     queue_len > target_queue * pool  (KServe KPA queue-depth rule,
             same rule InferenceService used pre-gateway), evaluated PER
             POOL now that a deployment may hold one pool per cloud.
             ``effective_queue`` folds the router's shed-pressure (requests
             admission control dropped since the last launch/probe) into
             the queue term: shed demand is still demand, so shedding
             triggers scale-up instead of masking the overload.
Scale-down   a replica idle for idle_window_s is retired, never below the
             pool's floor (its apportioned share of min_replicas).
             min_replicas=0 enables scale-to-zero.
Cost         pick_scale_up prefers the cheapest cloud with headroom;
             pick_retire prefers the most expensive cloud first.  Both rank
             against CloudProfile.cost_per_s (a simulated price sheet,
             DESIGN.md §1).
Cold start   a replica created after t=0 holds no weights: its first batch
             pays CloudProfile.model_load_s (cold_scale_up=False restores
             the legacy InferenceService behavior where the scale-up delay
             was the whole cost).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    min_replicas: int = 0            # 0 => scale-to-zero allowed
    max_replicas: int = 4
    target_queue: int = 16           # per-replica queue-depth target
    scale_up_delay_s: float = 0.5    # control-plane: pod scheduling + start
    idle_window_s: float = 1.0       # retire a replica idle this long
    cold_scale_up: bool = True       # new replicas pay model_load_s


@dataclasses.dataclass(frozen=True)
class PoolView:
    """What the policy sees of one per-cloud replica pool: enough to rank
    clouds by price and room, nothing about the simulator's internals."""
    cloud: str
    cost_per_s: float                # CloudProfile price sheet entry
    replicas: int                    # live + scheduled
    headroom: int                    # replicas the cloud/pool can still add


class Autoscaler:
    """Stateless policy over an AutoscalerConfig (per-deployment instance)."""

    def __init__(self, config: AutoscalerConfig | None = None):
        self.cfg = config or AutoscalerConfig()

    def scale_up_needed(self, queue_len: int, pool: int) -> bool:
        """pool counts live replicas plus ones already scheduled to start.
        The max_replicas bound is enforced by the caller per pool share
        (router.py) -- this is the pure queue-pressure rule."""
        return (queue_len > self.cfg.target_queue * max(pool, 1)
                and pool < self.cfg.max_replicas)

    @staticmethod
    def effective_queue(queue_len: int, shed_pressure: int,
                        alert_pressure: int = 0) -> int:
        """Queue depth as the scaling policy should see it: the real queue
        plus the requests admission control shed since the last launch or
        probe window, plus ``alert_pressure`` from an active SLO burn-rate
        alert (telemetry/slo.py BurnRateMonitor.pressure: a model burning
        its error budget scales up BEFORE the queue alone would tip the
        rule).  Shedding keeps queues short by design; without these terms
        an overloaded, hard-shedding pool would never scale up."""
        return queue_len + shed_pressure + alert_pressure

    def can_remove(self, pool: int, floor: Optional[int] = None) -> bool:
        """``floor`` is the pool's apportioned share of min_replicas; a
        single-pool deployment's floor IS min_replicas (legacy behavior)."""
        return pool > (self.cfg.min_replicas if floor is None else floor)

    def relaunch_pool(self, pool_before: int, queue_len: int,
                      headroom: Optional[int] = None) -> int:
        """Replicas to start on the destination cloud after a migration /
        failover: preserve the working-set size (the old pool was sized by
        observed load), keep at least min_replicas, and start one even from
        an empty pool when work is already queued.  Bounded by max_replicas
        so a migration cannot out-scale the policy, AND by the destination
        pool's capacity headroom when known (a global
        bound over-asked on a smaller destination cloud, burning launches
        on gateway:scale_denied) -- except the one guaranteed from-zero
        launch, which may breach the budget loudly."""
        want = max(pool_before, self.cfg.min_replicas,
                   1 if queue_len > 0 else 0)
        want = min(want, max(self.cfg.max_replicas, self.cfg.min_replicas))
        if headroom is not None:
            want = min(want, max(headroom, 1 if queue_len > 0 else 0))
        return want

    # -- cost awareness (CloudProfile.cost_per_s price sheet) ---------------
    @staticmethod
    def pick_scale_up(pools: list) -> Optional[PoolView]:
        """Cheapest cloud that can still grow; ties prefer the most
        headroom, then the cloud name (deterministic)."""
        open_ = [p for p in pools if p.headroom > 0]
        if not open_:
            return None
        return min(open_, key=lambda p: (p.cost_per_s, -p.headroom, p.cloud))

    @staticmethod
    def pick_retire(pools: list) -> Optional[PoolView]:
        """Most expensive cloud holding replicas retires first; ties prefer
        the most replicas, then the cloud name (deterministic)."""
        held = [p for p in pools if p.replicas > 0]
        if not held:
            return None
        return max(held, key=lambda p: (p.cost_per_s, p.replicas,
                                        p.cloud))

    @property
    def tracks_idle(self) -> bool:
        return math.isfinite(self.cfg.idle_window_s)
