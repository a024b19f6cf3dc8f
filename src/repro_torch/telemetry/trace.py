"""Structured tracing over SIMULATED time: the port's copy of
``repro.telemetry.trace`` (DESIGN.md S5).

A ``Tracer`` owns a flat list of ``Span``s with deterministic integer ids
(a per-tracer monotonic counter -- no wall clock, no randomness, so a
seeded run produces a bit-identical trace).  Spans form a forest:

- ``parent_id`` edges build the tree WITHIN one simulated-time axis: a
  child span's [t0, t1] interval nests inside its parent's (the
  well-formedness invariant the test suites check).  Roots (run spans)
  have ``parent_id=None``.
- ``links`` are OTel-style causal references ACROSS trees whose time axes
  differ: the serving gateway's request spans link to the pipeline's
  terminal deploy-step span (each ``Gateway.run`` / ``Orchestrator.
  execute`` restarts its own sim clock at t0, so the request cannot NEST
  inside the deploy step -- it is caused by it).  ``reachable`` follows
  parent->child edges plus link-target->linker edges, which is how the
  e2e acceptance walks from a pipeline run span to a served request.

Span vocabulary: gateway.run > gateway.request > {gateway.queue,
gateway.serve}; pipeline.run > pipeline.step > {pipeline.attempt >
pipeline.transfer}.  A ``trace_id`` groups each tree (the root span's own
id, inherited by descendants); links deliberately keep their own
trace_id -- that is what makes them links and not parents.
"""
from __future__ import annotations

import json
from typing import Any, Optional


class Span:
    """One timed operation on the simulated clock.  ``t1 is None`` while
    open; ``attrs`` is a small flat dict (cheap on the hot path)."""

    __slots__ = ("span_id", "trace_id", "parent_id", "name", "t0", "t1",
                 "attrs", "links")

    def __init__(self, span_id: int, trace_id: int, parent_id: Optional[int],
                 name: str, t0: float, attrs: dict, links: tuple):
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = float(t0)
        self.t1: Optional[float] = None
        self.attrs = attrs
        self.links = links

    @property
    def duration_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def to_dict(self) -> dict:
        return {"span_id": self.span_id, "trace_id": self.trace_id,
                "parent_id": self.parent_id, "name": self.name,
                "t0": round(self.t0, 9),
                "t1": None if self.t1 is None else round(self.t1, 9),
                "attrs": self.attrs, "links": list(self.links)}

    def __repr__(self):
        return (f"Span({self.span_id} {self.name!r} "
                f"[{self.t0:.4f},{self.t1 if self.t1 is None else round(self.t1, 4)}]"
                f" parent={self.parent_id})")


class Tracer:
    def __init__(self):
        self.spans: list[Span] = []      # id order == creation order
        self._next = 0

    def start(self, name: str, t: float, *, parent: Optional[Span] = None,
              links: tuple = (), **attrs) -> Span:
        """Open a span at simulated time ``t``.  ``links`` holds span ids
        of causally-related spans in OTHER trees (may be empty)."""
        sid = self._next
        self._next = sid + 1
        trace_id = parent.trace_id if parent is not None else sid
        parent_id = parent.span_id if parent is not None else None
        if links and None in links:      # hot path: links is almost always
            links = tuple(l for l in links if l is not None)   # () already
        span = Span(sid, trace_id, parent_id, name, t, attrs, links)
        self.spans.append(span)
        return span

    @staticmethod
    def end(span: Span, t: float, **attrs) -> Span:
        span.t1 = float(t)
        if attrs:
            span.attrs.update(attrs)
        return span

    # -- lookups (analysis-time; the hot path only calls start/end) ---------
    def get(self, span_id: int) -> Span:
        return self.spans[span_id]       # ids ARE list indices

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def roots(self) -> list:
        return [s for s in self.spans if s.parent_id is None]

    def children_index(self) -> dict:
        """parent span_id -> [child Span], in creation order."""
        idx: dict[Optional[int], list] = {}
        for s in self.spans:
            if s.parent_id is not None:
                idx.setdefault(s.parent_id, []).append(s)
        return idx

    def reachable(self, span_id: int) -> set:
        """Span ids reachable from ``span_id`` following parent->child
        edges AND link-target->linker edges (a span linking TO a reachable
        span is caused by it -- the cross-trace train->serve walk)."""
        children = self.children_index()
        linked_by: dict[int, list] = {}
        for s in self.spans:
            for l in s.links:
                linked_by.setdefault(l, []).append(s.span_id)
        seen = {span_id}
        stack = [span_id]
        while stack:
            cur = stack.pop()
            for nxt in ([c.span_id for c in children.get(cur, ())]
                        + linked_by.get(cur, [])):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen

    # -- export -------------------------------------------------------------
    def to_json(self, path: Optional[str] = None,
                log=None) -> str:
        """Deterministic JSON trace export (spans in id order).  Passing
        an EventLog records a ``trace:export`` event."""
        s = json.dumps([sp.to_dict() for sp in self.spans], indent=1)
        if path:
            with open(path, "w") as f:
                f.write(s)
        if log is not None:
            log.record("trace:export", 0.0, path=path or "",
                       spans=len(self.spans))
        return s

    @classmethod
    def from_json(cls, text: str) -> "Tracer":
        """Rebuild a Tracer from a ``to_json`` export so the offline
        analyzers (``analyze.request_table`` / ``run_table``) run against
        the file exactly as they would against the live tracer.  The
        export writes spans in id order and ids ARE list indices (the
        ``get()`` contract), so a reordered or id-gapped blob is rejected
        rather than silently re-keyed."""
        rows = json.loads(text)
        tr = cls()
        for i, r in enumerate(rows):
            if r["span_id"] != i:
                raise ValueError(f"span id {r['span_id']} at position {i}: "
                                 "ids must be the list indices")
            span = Span(r["span_id"], r["trace_id"], r["parent_id"],
                        r["name"], r["t0"], dict(r.get("attrs", {})),
                        tuple(r.get("links", ())))
            if r.get("t1") is not None:
                span.t1 = float(r["t1"])
            tr.spans.append(span)
        tr._next = len(tr.spans)
        return tr

    @classmethod
    def load(cls, path: str) -> "Tracer":
        """``from_json`` over a file written by ``to_json(path)``."""
        with open(path) as f:
            return cls.from_json(f.read())
