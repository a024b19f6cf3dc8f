"""Trace analyzer (the port's copy of ``repro.telemetry.analyze``):
critical paths + per-stage time attribution
(DESIGN.md S5) -- the paper's Tables 4/5 as a DERIVED artifact of the
span tree rather than hand-kept timers.

Request side (gateway.request trees): ``request_breakdown`` attributes
each served request's latency to queue-wait vs network (rtt+lb) vs
cold-start vs service from its gateway.queue / gateway.serve child spans;
``slowest_requests`` ranks them, and ``request_table`` renders the
breakdown of the slowest (p99-ish) requests.

Run side (pipeline.run trees): ``run_critical_path`` walks the step spans
backward from the last-finishing step through its latest-finishing
dependency (span attrs carry the dep step names), yielding the chain that
bounds the makespan; ``run_table`` attributes each link's simulated time
to control-plane (startup+rtt) vs transfer vs compute vs wait
(ready-but-queued + retry backoff).

``validate_trace`` is the well-formedness oracle the invariant suites
run: span ids unique, parent edges acyclic and interval-nested, exactly
one root per trace id, closed spans only.

Exports: ``Tracer.to_json`` (JSON trace) and
``MetricsRegistry.to_prometheus`` (Prometheus text) are the two wire
formats; ``export`` writes both next to each other.
"""
from __future__ import annotations

from typing import Optional

from .trace import Span, Tracer


# -- well-formedness (invariant-suite oracle) -------------------------------

def validate_trace(tracer: Tracer, *, eps: float = 1e-9) -> list:
    """Return a list of violation strings (empty == well-formed):
    duplicate ids, dangling/self/cyclic parent edges, open spans, a child
    interval escaping its parent's, or a non-root span whose trace_id
    does not match its root's."""
    bad = []
    seen = set()
    for s in tracer.spans:
        if s.span_id in seen:
            bad.append(f"duplicate span id {s.span_id}")
        seen.add(s.span_id)
    by_id = {s.span_id: s for s in tracer.spans}
    for s in tracer.spans:
        if s.t1 is None:
            bad.append(f"open span {s!r}")
            continue
        if s.t1 < s.t0 - eps:
            bad.append(f"negative interval {s!r}")
        if s.parent_id is None:
            if s.trace_id != s.span_id:
                bad.append(f"root {s.span_id} trace_id {s.trace_id}")
            continue
        p = by_id.get(s.parent_id)
        if p is None:
            bad.append(f"dangling parent {s.parent_id} on {s.span_id}")
            continue
        if s.trace_id != p.trace_id:
            bad.append(f"trace_id mismatch {s.span_id} vs {p.span_id}")
        if s.t0 < p.t0 - eps or (p.t1 is not None and s.t1 is not None
                                 and s.t1 > p.t1 + eps):
            bad.append(f"child {s.span_id} [{s.t0},{s.t1}] escapes "
                       f"parent {p.span_id} [{p.t0},{p.t1}]")
        # cycle check: walk to the root, bounded by the span count
        hops, cur = 0, s
        while cur.parent_id is not None and hops <= len(tracer.spans):
            cur = by_id.get(cur.parent_id)
            if cur is None:
                break
            hops += 1
        if hops > len(tracer.spans):
            bad.append(f"parent cycle through {s.span_id}")
    return bad


# -- request side ------------------------------------------------------------

def request_breakdown(tracer: Tracer, *, model: Optional[str] = None) -> list:
    """One row per SERVED gateway.request span: total latency and its
    attribution -- queue_s (sum of gateway.queue children), rtt_lb_s /
    cold_s / service_s (from the final gateway.serve child; preempted
    serve spans count as queue time: the work was thrown away)."""
    children = tracer.children_index()
    rows = []
    for r in tracer.named("gateway.request"):
        if r.t1 is None or r.attrs.get("outcome") != "served":
            continue
        if model is not None and r.attrs.get("model") != model:
            continue
        queue_s = wasted_s = 0.0
        serve = None
        for c in children.get(r.span_id, ()):
            if c.name == "gateway.queue":
                queue_s += c.duration_s
            elif c.name == "gateway.serve":
                if c.attrs.get("preempted"):
                    wasted_s += c.duration_s
                else:
                    serve = c
        row = {"model": r.attrs.get("model"), "idx": r.attrs.get("idx"),
               "cls": r.attrs.get("cls"), "total_s": r.duration_s,
               "queue_s": queue_s, "preempted_s": wasted_s,
               "rtt_lb_s": 0.0, "cold_s": 0.0, "service_s": 0.0,
               "cloud": None, "span_id": r.span_id}
        if serve is not None:
            row["rtt_lb_s"] = serve.attrs.get("rtt_lb_s", 0.0)
            row["cold_s"] = serve.attrs.get("cold_s", 0.0)
            row["service_s"] = serve.attrs.get("service_s", 0.0)
            row["cloud"] = serve.attrs.get("cloud")
        rows.append(row)
    return rows


def slowest_requests(tracer: Tracer, k: int = 1, *,
                     model: Optional[str] = None) -> list:
    rows = request_breakdown(tracer, model=model)
    rows.sort(key=lambda r: (-r["total_s"], r["span_id"]))
    return rows[:k]


def request_table(tracer: Tracer, k: int = 3, *,
                  model: Optional[str] = None) -> str:
    """Stage-breakdown table of the k slowest served requests (the 'where
    did the p99 request spend its time' answer)."""
    rows = slowest_requests(tracer, k, model=model)
    cols = ("model", "idx", "cls", "cloud", "total_s", "queue_s",
            "preempted_s", "rtt_lb_s", "cold_s", "service_s")
    return _table(rows, cols, title="slowest requests (trace-derived)")


# -- run side ----------------------------------------------------------------

def run_critical_path(tracer: Tracer, run_span_id: int) -> list:
    """The chain of pipeline.step spans bounding the run's makespan: start
    from the step finishing last, hop to its latest-finishing dependency
    (attrs['deps'] step names), repeat.  Returns spans in execution
    order."""
    children = tracer.children_index()
    steps = {s.attrs.get("step"): s
             for s in children.get(run_span_id, ())
             if s.name == "pipeline.step" and s.t1 is not None}
    if not steps:
        return []
    cur = max(steps.values(), key=lambda s: (s.t1, s.span_id))
    path = [cur]
    while True:
        deps = [steps[d] for d in cur.attrs.get("deps", ())
                if d in steps]
        if not deps:
            break
        cur = max(deps, key=lambda s: (s.t1, s.span_id))
        path.append(cur)
    path.reverse()
    return path


def run_breakdown(tracer: Tracer, run_span_id: int) -> list:
    """Per-step attribution along the critical path: control_s
    (startup+rtt over attempts), transfer_s, compute_s, and wait_s (the
    rest: ready-but-queued time + retry backoff gaps)."""
    children = tracer.children_index()
    rows = []
    for s in run_critical_path(tracer, run_span_id):
        attempts = [c for c in children.get(s.span_id, ())
                    if c.name == "pipeline.attempt"]
        control = sum(a.attrs.get("control_s", 0.0) for a in attempts)
        transfer = sum(a.attrs.get("transfer_s", 0.0) for a in attempts)
        compute = sum(a.attrs.get("compute_s", 0.0) for a in attempts)
        total = s.duration_s
        rows.append({"step": s.attrs.get("step"),
                     "cloud": s.attrs.get("cloud"),
                     "cached": s.attrs.get("cached", False),
                     "attempts": len(attempts),
                     "total_s": total, "control_s": control,
                     "transfer_s": transfer, "compute_s": compute,
                     "wait_s": max(total - control - transfer - compute,
                                   0.0)})
    return rows


def run_table(tracer: Tracer, run_span_id: int) -> str:
    rows = run_breakdown(tracer, run_span_id)
    cols = ("step", "cloud", "cached", "attempts", "total_s", "control_s",
            "transfer_s", "compute_s", "wait_s")
    return _table(rows, cols,
                  title="run critical path (trace-derived Tables 4/5)")


# -- rendering / export -------------------------------------------------------

def _table(rows: list, cols: tuple, *, title: str = "") -> str:
    def fmt(v):
        if isinstance(v, float):
            return f"{v:.5f}"
        return "-" if v is None else str(v)
    grid = [[fmt(r.get(c)) for c in cols] for r in rows]
    widths = [max([len(c)] + [len(g[i]) for g in grid])
              for i, c in enumerate(cols)]
    lines = ([title] if title else []) + [
        "  ".join(c.rjust(w) for c, w in zip(cols, widths))]
    lines += ["  ".join(v.rjust(w) for v, w in zip(g, widths))
              for g in grid]
    return "\n".join(lines)


def export(tracer: Tracer, registry=None, *, trace_path: str,
           prom_path: Optional[str] = None, log=None) -> None:
    """Write the JSON trace (and, with a registry, the Prometheus text
    exposition) to disk -- the two wire formats of DESIGN.md S5."""
    tracer.to_json(trace_path, log=log)
    if registry is not None and prom_path is not None:
        with open(prom_path, "w") as f:
            f.write(registry.to_prometheus())
