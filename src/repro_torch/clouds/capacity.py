"""Unified per-cloud capacity market: the port's copy of
``repro.clouds.capacity``.

The paper deploys Kubeflow training pipelines and KServe-style serving
onto the *same* per-cloud clusters; until now the repro kept them in two
disjoint universes (orchestrator worker slots vs gateway replica counts).
This module is the single source of truth both subsystems draw from:

  CapacityLedger   one cloud's slots.  A slot grant is a Lease -- a
                   ``[t0, t1)`` sim-time interval with a holder kind
                   (``"serving"`` / ``"training"``), a priority class and
                   a lifecycle status (active/released/preempted/
                   cancelled).  Every mutation appends an audit op with a
                   monotonically increasing ``seq``, so the whole history
                   replays deterministically and the conservation
                   invariant (concurrent leases <= slots at every point
                   of the committed timeline) is checkable after the run.

  CapacityMarket   the per-cloud ledgers plus the economics: serving
                   priority (training leases are preemptible, like spot
                   instances), a per-cloud serving ``reserve`` produced
                   by the budget planner (``plan_budget`` trades training
                   makespan against reserved serving headroom), and the
                   ``state_bytes`` knob that prices replica warm handoff
                   (state transfer over interconnect_bw instead of a cold
                   model load).

The gateway and the orchestrator run as *separate* discrete-event
simulations on the shared event-heap core, each restarting its own sim
clock; the market bridges them through the recorded lease timeline.  The
subsystem that runs later contends against the intervals the earlier run
left behind: a gateway scale-up that finds a cloud full preempts the
youngest training lease (``preempt_youngest``), and an orchestrator run
watches the recorded serving rise-edges (``serving_edges``) and kills its
own youngest running attempt when one over-commits the cloud.

Both subsystems accept ``shared_capacity=None`` (the default), which
keeps every market-free code path bit-identical -- contention only
activates when one explicit ``CapacityMarket`` is passed to both.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional


@dataclasses.dataclass
class Lease:
    """One slot grant on one cloud over the sim-time interval [t0, t1).

    ``t1`` is ``inf`` while the lease is open; release/preempt/cancel
    close it.  ``status`` is the lifecycle outcome:

      active      open, holder still occupies the slot
      released    closed normally by the holder
      preempted   truncated by the market (serving priority over spot
                  training, or a recorded-timeline kill)
      cancelled   closed because the holder became redundant (the losing
                  side of a speculative-retry pair)
    """
    lease_id: int
    cloud: str
    kind: str                    # "serving" | "training"
    holder: str
    t0: float
    t1: float = math.inf
    status: str = "active"
    priority: int = 0

    def covers(self, t: float) -> bool:
        return self.t0 <= t < self.t1


class CapacityLedger:
    """One cloud's slot ledger: lease/release/preempt primitives plus the
    monotonic-``seq`` audit trail.  Conservation is enforced at lease
    time *instantaneously*: a lease at ``t`` is refused (returns None)
    when the slots covering ``t`` are all taken -- callers preempt
    (serving priority) or deny.  Later over-commits against *recorded*
    intervals (a serving rise-edge crossing an open training lease) are
    resolved by preemption at the edge, so the committed timeline never
    exceeds ``slots`` anywhere."""

    def __init__(self, cloud: str, slots: int, *, _seq=None) -> None:
        if slots < 1:
            raise ValueError(f"ledger {cloud!r} needs >= 1 slot, got {slots}")
        self.cloud = cloud
        self.slots = int(slots)
        self.leases: list[Lease] = []
        self.audit: list[dict] = []
        self._seq = itertools.count() if _seq is None else _seq
        self._ids = itertools.count()

    # -- queries -------------------------------------------------------------

    def used(self, t: float, kind: Optional[str] = None) -> int:
        return sum(1 for l in self.leases
                   if l.covers(t) and (kind is None or l.kind == kind))

    def free(self, t: float) -> int:
        return max(self.slots - self.used(t), 0)

    def next_release_after(self, t: float) -> Optional[float]:
        """Earliest recorded lease end strictly after ``t`` (wake-up time
        for a caller blocked on a full ledger), or None."""
        ends = [l.t1 for l in self.leases if t < l.t1 < math.inf]
        return min(ends) if ends else None

    def serving_edges(self, lo: float = 0.0,
                      hi: float = math.inf) -> list[float]:
        """Times in (lo, hi] where recorded serving occupancy rises."""
        return sorted({l.t0 for l in self.leases
                       if l.kind == "serving" and lo < l.t0 <= hi})

    def max_overlap(self, kind: Optional[str] = None) -> int:
        """Peak concurrent leases over the committed timeline (the
        conservation invariant asserts this never exceeds ``slots``)."""
        edges = []
        for l in self.leases:
            if kind is not None and l.kind != kind:
                continue
            edges.append((l.t0, 1))
            if l.t1 < math.inf:
                edges.append((l.t1, -1))
        peak = cur = 0
        for _, d in sorted(edges):           # ends sort before starts at
            cur += d                         # equal t ((-1) < (+1)): the
            peak = max(peak, cur)            # interval [t0, t1) is half-open
        return peak

    # -- mutations (each appends one audit op) -------------------------------

    def _op(self, op: str, lease: Lease, t: float) -> None:
        self.audit.append({"seq": next(self._seq), "op": op,
                           "lease": lease.lease_id, "cloud": self.cloud,
                           "kind": lease.kind, "holder": lease.holder,
                           "t": t})

    def lease(self, kind: str, holder: str, t: float, *,
              priority: int = 0) -> Optional[Lease]:
        if self.used(t) >= self.slots:
            return None
        l = Lease(next(self._ids), self.cloud, kind, holder, t,
                  priority=priority)
        self.leases.append(l)
        self._op("lease", l, t)
        return l

    def release(self, lease: Lease, t: float, *,
                status: str = "released") -> None:
        lease.t1 = max(t, lease.t0)
        lease.status = status
        self._op({"released": "release", "preempted": "preempt",
                  "cancelled": "cancel"}.get(status, status), lease, t)

    def preempt_youngest(self, t: float,
                         kind: str = "training") -> Optional[Lease]:
        """Truncate the youngest ``kind`` lease covering ``t`` (max t0,
        ties broken by max lease_id) at ``t1 = t``.  Also truncates
        *recorded* (already-released) intervals from an earlier run --
        the kill is then a market-level fact about the shared timeline."""
        cands = [l for l in self.leases if l.kind == kind and l.covers(t)]
        if not cands:
            return None
        victim = max(cands, key=lambda l: (l.t0, l.lease_id))
        victim.t1 = max(t, victim.t0)
        victim.status = "preempted"
        self._op("preempt", victim, t)
        return victim


class CapacityMarket:
    """Per-cloud ledgers plus the shared-substrate economics.

    ``slots`` maps cloud name -> slot count; clouds absent from the map
    are unconstrained (the subsystems fall back to their own limits).
    ``serving_priority=True`` lets serving preempt training (spot
    semantics); False means a full cloud denies the serving scale-up
    instead.  ``state_bytes > 0`` prices replica warm handoff: a gateway
    relaunch that migrates load pays the state transfer over the clouds'
    interconnect instead of a cold model load, when cheaper.  A single
    ``seq`` counter is shared by every ledger so the audit trail has one
    global order."""

    def __init__(self, slots: dict, *, serving_priority: bool = True,
                 state_bytes: float = 0.0) -> None:
        seq = itertools.count()
        self.ledgers = {c: CapacityLedger(c, n, _seq=seq)
                        for c, n in sorted(slots.items())}
        self.serving_priority = serving_priority
        self.state_bytes = float(state_bytes)
        self.reserve: dict = {}          # cloud -> slots held for serving

    # -- per-cloud views (unconstrained when the cloud has no ledger) --------

    def ledger(self, cloud: str) -> Optional[CapacityLedger]:
        return self.ledgers.get(cloud)

    def training_free(self, cloud: str, t: float) -> int:
        """Slots a *training* lease may take at ``t``: ledger free minus
        the serving reserve.  Unconstrained clouds report a large free."""
        led = self.ledgers.get(cloud)
        if led is None:
            return 1 << 30
        return max(led.free(t) - int(self.reserve.get(cloud, 0)), 0)

    def training_active(self, cloud: str, t: float) -> int:
        led = self.ledgers.get(cloud)
        return 0 if led is None else led.used(t, kind="training")

    def preempt_training(self, cloud: str, t: float) -> Optional[Lease]:
        if not self.serving_priority:
            return None
        led = self.ledgers.get(cloud)
        return None if led is None else led.preempt_youngest(t, "training")

    # -- budget planner ------------------------------------------------------

    def plan_budget(self, serving_load: dict, work_s: float, *,
                    target_util: float = 0.7) -> dict:
        """Trade training makespan against reserved serving headroom.

        ``serving_load`` maps cloud -> expected steady serving occupancy
        (replicas); the planner reserves ``ceil(load / target_util)``
        slots per cloud for serving (bounded by the ledger), leaves the
        rest to training, and estimates the training makespan as the
        total work spread over the remaining slots.  The reserve is
        installed on the market (``training_free`` honors it) and the
        plan is returned for logging."""
        reserve, train = {}, {}
        for cloud, led in self.ledgers.items():
            load = float(serving_load.get(cloud, 0.0))
            r = min(led.slots, math.ceil(load / target_util)) if load else 0
            reserve[cloud] = r
            train[cloud] = led.slots - r
        total_train = sum(train.values())
        self.reserve = reserve
        return {"reserve": reserve, "training_slots": train,
                "est_makespan_s": (work_s / total_train
                                   if total_train else math.inf)}

    # -- invariant helper (tests / benches) ----------------------------------

    def check_conservation(self) -> None:
        """Raise if any ledger's committed timeline ever exceeds its
        slots (the no-over-commit invariant, checked post-run over the
        full audit history)."""
        for cloud, led in self.ledgers.items():
            peak = led.max_overlap()
            if peak > led.slots:
                raise AssertionError(
                    f"{cloud}: {peak} concurrent leases > {led.slots} slots")
            seqs = [op["seq"] for op in led.audit]
            if seqs != sorted(seqs) or len(set(seqs)) != len(seqs):
                raise AssertionError(f"{cloud}: audit seq not monotonic")
