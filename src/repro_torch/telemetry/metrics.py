"""Metrics plane (the port's copy of ``repro.telemetry.metrics``):
counters / gauges / histograms with a log-linear
quantile sketch, scraped on the SIMULATED clock (DESIGN.md S5).

The registry is the Prometheus analog the paper leans on (Istio metrics):
instruments are keyed by (name, sorted label items), observations land in
O(1) sketch buckets (no per-event dict churn on the hot path), and
``scrape(t_sim)`` appends an immutable snapshot so p50/p99/miss/shed/cost
SERIES exist over simulated time -- the single source the benches and the
SLO burn-rate monitor read, reconciled exactly against the event log by
the invariant suites (served + shed == offered).

Metric naming scheme (Prometheus conventions):
  <subsystem>_<noun>_<unit>[_total]   e.g. gateway_requests_total,
  gateway_request_latency_seconds, gateway_queue_depth,
  pipeline_step_seconds, gateway_cost_usd
labels: model / cloud / cls / outcome (served|shed) / pipeline / step.

The sketch is HDR/Prometheus-native-histogram style log-linear: each
power-of-two order is split into ``sub`` linear sub-buckets, giving a
relative quantile error <= 1/sub (sub=32 -> ~3%) over any value range
with a sparse dict of counts.  Quantiles interpolate inside the winning
bucket, and exact min/max are tracked so q=0/q=1 are exact.
"""
from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np


class QuantileSketch:
    """Log-linear histogram sketch.  ``observe`` is O(1); ``quantile``
    walks the sparse buckets (analysis-time only)."""

    __slots__ = ("sub", "counts", "n", "total", "vmin", "vmax")

    def __init__(self, sub: int = 32):
        if sub < 1:
            raise ValueError("sub must be >= 1")
        self.sub = sub
        self.counts: dict[int, int] = {}   # flat bucket key -> count
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _key(self, v: float) -> int:
        """Flat bucket key: exponent e (2^e <= v < 2^(e+1)) * sub + linear
        sub-bucket.  Non-positive values share one underflow bucket."""
        if v <= 0.0:
            return -(1 << 30)
        m, e = math.frexp(v)             # v = m * 2^e, m in [0.5, 1)
        sub = int((m - 0.5) * 2 * self.sub)   # 0..sub-1
        return e * self.sub + min(sub, self.sub - 1)

    def _lo(self, key: int) -> float:
        e, sub = divmod(key, self.sub)
        return math.ldexp(0.5 + sub / (2 * self.sub), e)

    def _hi(self, key: int) -> float:
        e, sub = divmod(key, self.sub)
        return math.ldexp(0.5 + (sub + 1) / (2 * self.sub), e)

    def observe(self, v: float) -> None:
        v = float(v)
        k = self._key(v)
        self.counts[k] = self.counts.get(k, 0) + 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def observe_many(self, values) -> None:
        """Vectorized bulk observe (the gateway's scrape-time fold, which
        rebuilds series off the hot path).  Bucket counts / n / min / max
        are identical to a loop of ``observe`` calls over the same values;
        ``total`` may differ in the last float bits (pairwise vs serial
        summation), which every consumer tolerates."""
        v = np.asarray(values, float)
        if v.size == 0:
            return
        if v.size <= 32:                 # numpy dispatch overhead beats a
            for x in v.tolist():         # plain loop on small chunks
                self.observe(x)
            return
        vmin, vmax = float(v.min()), float(v.max())
        if vmin > 0.0:                   # the common all-positive chunk
            vp = v                       # skips the underflow filter
        else:
            pos = v > 0.0
            under = int(v.size - pos.sum())
            if under:                    # shared underflow bucket, as _key
                k = -(1 << 30)
                self.counts[k] = self.counts.get(k, 0) + under
            vp = v[pos]
        if vp.size:
            m, e = np.frexp(vp)          # same op chain as _key, so the
            sub = ((m - 0.5) * 2 * self.sub).astype(np.int64)   # keys match
            sub = np.minimum(sub, self.sub - 1)                 # bit-exactly
            keys, cnts = np.unique(e.astype(np.int64) * self.sub + sub,
                                   return_counts=True)
            get = self.counts.get
            for k, c in zip(keys.tolist(), cnts.tolist()):
                self.counts[k] = get(k, 0) + c
        self.n += int(v.size)
        self.total += float(v.sum())
        self.vmin = min(self.vmin, vmin)
        self.vmax = max(self.vmax, vmax)

    def merge(self, other: "QuantileSketch") -> None:
        if other.sub != self.sub:
            raise ValueError("cannot merge sketches with different sub")
        for k, c in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + c
        self.n += other.n
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` (linear interpolation inside the
        winning bucket, clamped to the exact observed min/max); None when
        empty.  Relative error <= 1/sub vs the exact percentile."""
        return self.quantiles((q,))[0]

    def quantiles(self, qs) -> list:
        """Several quantiles in ONE sorted bucket walk -- what snapshot()
        uses so each scrape sorts the buckets once, not per quantile."""
        out: list = [None] * len(qs)
        if self.n == 0:
            return out
        order = sorted(range(len(qs)), key=lambda i: qs[i])
        items = sorted(self.counts.items())
        acc, pos = 0.0, 0
        for i in order:
            q = qs[i]
            if q <= 0.0:
                out[i] = self.vmin
                continue
            if q >= 1.0:
                out[i] = self.vmax
                continue
            rank = q * self.n
            while pos < len(items) and acc + items[pos][1] < rank:
                acc += items[pos][1]
                pos += 1
            if pos >= len(items):
                out[i] = self.vmax
                continue
            k, c = items[pos]
            if k == -(1 << 30):          # underflow bucket: exact floor
                out[i] = min(0.0, self.vmin)
                continue
            frac = (rank - acc) / c
            lo, hi = self._lo(k), self._hi(k)
            out[i] = min(max(lo + frac * (hi - lo), self.vmin), self.vmax)
        return out

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.n if self.n else None

    def snapshot(self) -> dict:
        p50, p99 = self.quantiles((0.5, 0.99))
        return {"n": self.n, "sum": self.total, "p50": p50, "p99": p99}


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v

    def snapshot(self):
        return self.value


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    __slots__ = ("sketch",)

    def __init__(self, sub: int = 32):
        self.sketch = QuantileSketch(sub)

    def observe(self, v: float) -> None:
        self.sketch.observe(v)

    def quantile(self, q: float) -> Optional[float]:
        return self.sketch.quantile(q)

    @property
    def n(self) -> int:
        return self.sketch.n

    def snapshot(self):
        return self.sketch.snapshot()


def _escape_label(v) -> str:
    """Prometheus exposition escaping for label VALUES: backslash first
    (escaping the escapes), then double-quote and newline."""
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _escape_help(v: str) -> str:
    """HELP text escaping: only backslash and newline (quotes are legal)."""
    return v.replace("\\", r"\\").replace("\n", r"\n")


class MetricsRegistry:
    """Label-keyed instrument families + simulated-time scrape snapshots.

    ``counter/gauge/histogram(name, **labels)`` get-or-create (stable key:
    sorted label items), so hot-path callers can cache the returned
    instrument and skip the lookup entirely.  ``scrape(t_sim)`` appends
    one frozen snapshot of every live series to ``scrapes``.
    """

    def __init__(self, *, sub: int = 32):
        self.sub = sub
        self._series: dict[tuple, object] = {}
        self._kinds: dict[str, str] = {}     # family name -> kind
        self._help: dict[str, str] = {}      # family name -> HELP text
        self.scrapes: list[dict] = []
        self._fmt_cache: list = []           # sorted (key_str, inst) pairs;
        # rebuilt when a series appears (scrape re-sorts + re-formats
        # otherwise -- measurable at gateway scrape frequency)

    def _get(self, kind: str, name: str, labels: dict):
        known = self._kinds.setdefault(name, kind)
        if known != kind:
            raise ValueError(f"{name!r} is a {known}, not a {kind}")
        key = (name, tuple(sorted(labels.items())))
        inst = self._series.get(key)
        if inst is None:
            inst = self._series[key] = (
                Counter() if kind == "counter" else
                Gauge() if kind == "gauge" else Histogram(self.sub))
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def describe(self, name: str, text: str) -> None:
        """Attach HELP text to a family (rendered by ``to_prometheus``;
        families never described fall back to a kind-derived one-liner)."""
        self._help[name] = str(text)

    # -- reads --------------------------------------------------------------
    def value(self, name: str, **labels):
        """Current value (counter/gauge) or sketch snapshot (histogram);
        None when the series does not exist."""
        inst = self._series.get((name, tuple(sorted(labels.items()))))
        return None if inst is None else inst.snapshot()

    def total(self, name: str, **match) -> float:
        """Sum of a counter family over every series whose labels include
        ``match`` (e.g. total('gateway_requests_total', model='m'))."""
        out = 0.0
        want = set(match.items())
        for (n, labels), inst in self._series.items():
            if n == name and want <= set(labels):
                out += inst.value
        return out

    # -- scrapes (simulated-time series) ------------------------------------
    def scrape(self, t_sim: float, log=None) -> dict:
        """Freeze every live series at simulated time ``t_sim``.  Passing
        an EventLog records a ``metrics:scrape`` event."""
        if len(self._fmt_cache) != len(self._series):
            self._fmt_cache = [(self._fmt(n, dict(l)), inst)
                               for (n, l), inst
                               in sorted(self._series.items())]
        snap = {"t_sim": float(t_sim),
                "series": {k: inst.snapshot()
                           for k, inst in self._fmt_cache}}
        self.scrapes.append(snap)
        if log is not None:
            log.record("metrics:scrape", 0.0, t_sim=round(t_sim, 6),
                       series=len(snap["series"]))
        return snap

    def series(self, name: str, **labels) -> list:
        """(t_sim, snapshot) pairs for one series across every scrape."""
        key = self._fmt(name, labels)
        return [(s["t_sim"], s["series"][key]) for s in self.scrapes
                if key in s["series"]]

    # -- export -------------------------------------------------------------
    @staticmethod
    def _fmt(name: str, labels: dict) -> str:
        if not labels:
            return name
        inner = ",".join(f'{k}="{_escape_label(v)}"'
                         for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}}"

    def to_prometheus(self) -> str:
        """Prometheus text exposition of the CURRENT values (histograms as
        _count/_sum plus p50/p99 quantile gauges from the sketch).  Every
        family gets a ``# HELP``/``# TYPE`` pair and label values are
        escaped per the exposition format (backslash, quote, newline)."""
        by_family: dict[str, list] = {}
        for (n, labels), inst in sorted(self._series.items()):
            by_family.setdefault(n, []).append((dict(labels), inst))
        lines = []
        for name, series in by_family.items():
            kind = self._kinds[name]
            help_text = self._help.get(
                name, f"{'summary' if kind == 'histogram' else kind} "
                      f"family {name}")
            lines.append(f"# HELP {name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {name} "
                         f"{'summary' if kind == 'histogram' else kind}")
            for labels, inst in series:
                if kind == "histogram":
                    s = inst.snapshot()
                    lines.append(f"{self._fmt(name + '_count', labels)}"
                                 f" {s['n']}")
                    lines.append(f"{self._fmt(name + '_sum', labels)}"
                                 f" {s['sum']:.9g}")
                    for q in (0.5, 0.99):
                        v = inst.quantile(q)
                        if v is not None:
                            ql = dict(labels, quantile=q)
                            lines.append(f"{self._fmt(name, ql)} {v:.9g}")
                else:
                    lines.append(f"{self._fmt(name, labels)} "
                                 f"{inst.snapshot():.9g}")
        return "\n".join(lines) + "\n"

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps({"current": {self._fmt(n, dict(l)): i.snapshot()
                                    for (n, l), i
                                    in sorted(self._series.items())},
                        "scrapes": self.scrapes}, indent=1)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s
