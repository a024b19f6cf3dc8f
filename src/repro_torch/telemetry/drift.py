"""Profile-vs-observed drift detection (the port's copy of
``repro.telemetry.drift``): the Model-CI feedback edge
(DESIGN.md S9).

A placement planned from a ``ModelProfile`` artifact is only as good as
the profile's numbers.  The ``DriftMonitor`` closes that loop at serving
time: the gateway registers the exact profile each deployment was planned
from (``watch``), and at every metrics scrape feeds the model's
cumulative busy-seconds / served-count (``observe``).  The monitor takes
per-scrape deltas, so the comparison is the OBSERVED per-request service
time over the scrape interval against the profile's promised
``service_time_s``:

    ratio = observed_s / profile.service_time_s

Drift fires when the ratio leaves the tolerance band
[1/threshold, threshold] for ``sustain`` consecutive evaluated scrapes
(scrapes with fewer than ``min_n`` served requests in the interval are
not evidence either way -- they neither advance nor reset the streak).
Edges are ``profile:drift`` events (state=firing / resolved) on the
simulated clock, deterministic under the run seed.

The monitor is a CONTROLLER, not just an alarm:

- a firing edge arms the model for re-profiling (``reprofile`` set +
  one ``modelci:reprofile`` event) -- consumers re-run the profiling DAG
  for that model, producing a fresh artifact that supersedes the stale
  one in the ProfileStore;
- ``Gateway._probe`` treats a drifting model like an overload breach
  (ReplanConfig arming reason ``profile_drift``), so the placement is
  re-planned from OBSERVED demand while the re-profile is in flight.

Metric families: ``modelci_drift_ratio`` (last evaluated ratio per
model) and ``modelci_profile_staleness`` (simulated seconds since the
watched profile was planned from), refreshed on every observe and frozen
by whatever scrape runs next.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    threshold: float = 1.5       # band is [1/threshold, threshold]
    sustain: int = 2             # consecutive out-of-band evaluated scrapes
    min_n: int = 8               # served requests needed per interval

    def __post_init__(self):
        if self.threshold <= 1.0:
            raise ValueError("threshold must be > 1 (a band, not a point)")
        if self.sustain < 1:
            raise ValueError("sustain must be >= 1")
        if self.min_n < 1:
            raise ValueError("min_n must be >= 1")


class _Watch:
    __slots__ = ("profile", "t0", "busy0", "served0", "streak", "ratio")

    def __init__(self, profile, t0: float):
        self.profile = profile
        self.t0 = t0                 # planned-from time: staleness origin
        self.busy0 = 0.0             # cumulative counters at last scrape
        self.served0 = 0
        self.streak = 0              # consecutive out-of-band evaluations
        self.ratio = 1.0             # last evaluated ratio


class DriftMonitor:
    """Per-model observed-vs-profiled service-time accounting, fed by the
    gateway scrape loop on cumulative counters (the monitor does the
    deltas -- same contract a Prometheus rate() has with a counter)."""

    def __init__(self, cfg: Optional[DriftConfig] = None, *, log=None,
                 metrics=None):
        self.cfg = cfg or DriftConfig()
        self.log = log
        self.metrics = metrics
        self._watch: dict[str, _Watch] = {}
        self.active: dict[str, float] = {}   # model -> firing-since t_sim
        self.reprofile: set = set()          # models armed for re-profiling
        self.drifts: list[dict] = []         # every firing edge, in order

    # -- registration --------------------------------------------------------
    def watch(self, model: str, profile, t: float = 0.0) -> None:
        """Register the profile ``model``'s live placement was planned
        from.  Re-watching (a re-deploy after re-profiling) replaces the
        baseline and clears the model's drift state."""
        self._watch[model] = _Watch(profile, t)
        self.active.pop(model, None)
        self.reprofile.discard(model)

    def reset(self) -> None:
        """Forget per-run counters between runs (watched profiles and the
        drift history are kept; cumulative baselines restart at zero with
        the gateway's per-run state)."""
        for w in self._watch.values():
            w.busy0, w.served0, w.streak, w.ratio = 0.0, 0, 0, 1.0
        self.active.clear()

    # -- feed ---------------------------------------------------------------
    def observe(self, t: float, model: str, busy_s: float,
                served: int) -> None:
        """One scrape's cumulative counters for ``model``: total busy
        seconds and total served requests since run start.  Evaluates the
        drift rule over the delta since the previous scrape."""
        w = self._watch.get(model)
        if w is None:
            return
        d_busy = busy_s - w.busy0
        d_served = served - w.served0
        w.busy0, w.served0 = busy_s, served
        if self.metrics is not None:
            self.metrics.gauge("modelci_profile_staleness",
                               model=model).set(round(t - w.t0, 6))
        if d_served < self.cfg.min_n or d_busy <= 0:
            return                   # not evidence either way
        observed = d_busy / d_served
        expected = w.profile.service_time_s
        ratio = observed / expected
        w.ratio = ratio
        if self.metrics is not None:
            self.metrics.gauge("modelci_drift_ratio",
                               model=model).set(round(ratio, 6))
        out = ratio >= self.cfg.threshold or ratio <= 1.0 / self.cfg.threshold
        w.streak = w.streak + 1 if out else 0
        firing = w.streak >= self.cfg.sustain
        was = model in self.active
        if firing and not was:
            self.active[model] = t
            rec = {"model": model, "t_sim": round(t, 6),
                   "ratio": round(ratio, 4),
                   "expected_s": round(expected, 9),
                   "observed_s": round(observed, 9)}
            self.drifts.append(rec)
            if self.log is not None:
                self.log.record("profile:drift", 0.0, state="firing",
                                **rec)
            if self.metrics is not None:
                self.metrics.counter("modelci_drift_total",
                                     model=model).inc()
            if model not in self.reprofile:
                # the controller edge: one re-profile armed per drift
                # episode -- consumers re-run the profiling DAG
                self.reprofile.add(model)
                if self.log is not None:
                    self.log.record("modelci:reprofile", 0.0, model=model,
                                    ratio=round(ratio, 4),
                                    t_sim=round(t, 6))
        elif was and not firing and w.streak == 0:
            since = self.active.pop(model)
            if self.log is not None:
                self.log.record("profile:drift", 0.0, state="resolved",
                                model=model, t_sim=round(t, 6),
                                ratio=round(ratio, 4),
                                firing_s=round(t - since, 6))

    # -- control-loop reads -------------------------------------------------
    def is_drifting(self, model: str) -> bool:
        return model in self.active

    def drifting_models(self) -> set:
        return set(self.active)

    def pop_reprofile(self) -> set:
        """Drain the armed re-profile set (the consumer claims the work:
        e.g. a runner that fires the profiling DAG for each model)."""
        out, self.reprofile = self.reprofile, set()
        return out
