"""SLO burn-rate monitor (the port's copy of ``repro.telemetry.slo``):
multi-window error-budget alerting that CLOSES
the control loop (DESIGN.md S5) instead of sitting beside it.

The rule is the SRE-workbook multiwindow burn-rate alert.  An SLO class
promises ``objective`` (fraction of offered requests that complete within
their class deadline; a shed request is a breach by definition).  The
error budget is ``1 - objective``; the burn rate over a window is

    burn = breach_fraction(window) / (1 - objective)

i.e. how many times faster than sustainable the budget is being consumed
(burn=1 -> the budget exactly lasts the period).  An alert FIRES for a
(model, class) pair when burn >= ``threshold`` over BOTH the short and the
long window (the short window gates on recency -- the alert resolves
promptly when the burn stops; the long window gates on significance -- a
single slow batch cannot page), each with at least ``min_n``
observations.  Edges are recorded as ``gateway:alert`` events
(state=firing / resolved) on the simulated clock, deterministic under the
run seed.

Consumers:
- ``Gateway._probe`` treats an active alert like a miss-rate breach
  (ReplanConfig arming reason ``slo_burn``), so weight shifts away from a
  burning model BEFORE the coarser window-rate triggers accumulate;
- ``Autoscaler.effective_queue`` folds ``pressure()`` in next to
  shed-pressure, so a burning pool scales up;
- ``placement.replan(alerts=...)`` over-provisions burning models.

Windows are simulated seconds; observations arrive in nondecreasing sim
time from the gateway event loop (completions at their "free" event,
sheds at shed time), so eviction is a deque pop from the left -- O(1)
amortized per observation, no per-event dict churn.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BurnRateConfig:
    objective: float = 0.9       # served-within-deadline fraction promised
    short_s: float = 0.5         # recency window (simulated seconds)
    long_s: float = 2.5          # significance window
    threshold: float = 2.0       # alert at >= threshold x sustainable burn
    min_n: int = 8               # observations needed per window

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if not 0.0 < self.short_s <= self.long_s:
            raise ValueError("need 0 < short_s <= long_s")
        if self.threshold <= 0:
            raise ValueError("threshold must be > 0")
        if self.min_n < 1:
            raise ValueError("min_n must be >= 1")


class BurnRateMonitor:
    """Per-(model, class) budget accounting over two sliding windows."""

    def __init__(self, cfg: Optional[BurnRateConfig] = None, *, log=None,
                 metrics=None):
        self.cfg = cfg or BurnRateConfig()
        self.log = log
        self.metrics = metrics
        # key -> [short deque[(t, bad)], long deque, bad_short, bad_long];
        # each window evicts by time from the left: O(1) amortized
        self._win: dict[tuple, list] = {}
        self.active: dict[tuple, float] = {} # key -> firing-since t_sim
        self.alerts: list[dict] = []         # every firing edge, in order

    def reset(self) -> None:
        """Forget window state between runs (alert history is kept)."""
        self._win.clear()
        self.active.clear()

    # -- feed ---------------------------------------------------------------
    def observe(self, t: float, model: str, cls: str, good: bool) -> None:
        """One terminal request outcome at simulated time ``t``: a served
        request (good = met its class deadline) or a shed (good=False).
        Evaluates the alert rule for this key on the spot."""
        cfg = self.cfg
        key = (model, cls)
        w = self._win.get(key)
        if w is None:
            w = self._win[key] = [deque(), deque(), 0, 0]
        bad = not good
        w[0].append((t, bad))
        w[1].append((t, bad))
        if bad:
            w[2] += 1
            w[3] += 1
        while w[0] and w[0][0][0] < t - cfg.short_s:
            if w[0].popleft()[1]:
                w[2] -= 1
        while w[1] and w[1][0][0] < t - cfg.long_s:
            if w[1].popleft()[1]:
                w[3] -= 1
        self._evaluate(t, key, w)

    def age(self, t: float) -> None:
        """Advance every window to simulated time ``t`` with no new
        observation.  The short window gates on RECENCY, so an alert must
        resolve once the burn stops even if no further requests ever
        arrive -- but ``observe`` is the only other place eviction runs,
        so without this a burst that ends in a firing alert pins
        ``pressure()`` forever: the autoscaler keeps launching replicas
        that idle out, each launch re-arms the event loop, and the run
        never terminates.  The gateway calls this once per timestep."""
        cfg = self.cfg
        for key, w in self._win.items():
            changed = False
            while w[0] and w[0][0][0] < t - cfg.short_s:
                if w[0].popleft()[1]:
                    w[2] -= 1
                changed = True
            while w[1] and w[1][0][0] < t - cfg.long_s:
                if w[1].popleft()[1]:
                    w[3] -= 1
                changed = True
            if changed:
                self._evaluate(t, key, w)

    def _evaluate(self, t: float, key: tuple, w: list) -> None:
        cfg = self.cfg
        budget = 1.0 - cfg.objective
        n_s, n_l = len(w[0]), len(w[1])
        burn_s = (w[2] / n_s) / budget if n_s else 0.0
        burn_l = (w[3] / n_l) / budget if n_l else 0.0
        firing = (n_s >= cfg.min_n and n_l >= cfg.min_n
                  and burn_s >= cfg.threshold and burn_l >= cfg.threshold)
        was = key in self.active
        if firing and not was:
            self.active[key] = t
            rec = {"model": key[0], "cls": key[1], "t_sim": round(t, 6),
                   "burn_short": round(burn_s, 4),
                   "burn_long": round(burn_l, 4)}
            self.alerts.append(rec)
            if self.log is not None:
                self.log.record("gateway:alert", 0.0, state="firing",
                                objective=cfg.objective, **rec)
            if self.metrics is not None:
                self.metrics.counter("gateway_slo_alerts_total",
                                     model=key[0], cls=key[1]).inc()
        elif was and not firing:
            since = self.active.pop(key)
            if self.log is not None:
                self.log.record("gateway:alert", 0.0, state="resolved",
                                model=key[0], cls=key[1],
                                t_sim=round(t, 6),
                                firing_s=round(t - since, 6))

    # -- control-loop reads -------------------------------------------------
    def is_burning(self, model: str) -> bool:
        return any(m == model for m, _ in self.active)

    def alerting_models(self) -> set:
        return {m for m, _ in self.active}

    def pressure(self, model: str, target_queue: int) -> int:
        """Extra queue depth the autoscaler should assume for a burning
        model (one target_queue worth: enough to tip the per-replica rule
        without double-counting the real backlog)."""
        return int(target_queue) if self.is_burning(model) else 0
