"""Shared discrete-event simulation core (DESIGN.md S6): the port's copy of
``repro.sim.engine``, whole.

The reference's two event loops -- the serving gateway
(serving/gateway/router.py) and the pipeline orchestrator
(pipelines/scheduler.py) -- run on the one ``EventHeap`` here instead of
each hand-rolling ``heapq`` + ``itertools.count``; the port's gateway does
too.  The contract:

- every event is a ``(t, seq, kind, *payload)`` tuple ordered by
  ``(t, seq)``; ``seq`` is a per-heap monotonic counter drawn at push
  time, so ties at the same simulated timestamp resolve in PUSH order
  and no payload is ever compared;
- same-timestamp batching: all events sharing the earliest ``t`` form
  one logical step.  ``pop()`` + ``peek_t()`` supports the gateway's
  interleaved style (an event processed at ``t`` may push another event
  at ``t`` into the SAME step); ``pop_batch()`` supports the
  orchestrator's collect-then-apply style (a same-``t`` push lands in
  the NEXT step).  Each caller keeps its historical semantics exactly;
- timer kinds: self-rescheduling periodic events (the gateway's
  ``probe`` / ``scrape``).  ``only_timers()`` is the dead-tail rule
  from the observability PR: once no work is left and only timer kinds
  remain queued, the timers must stop re-arming -- re-pushing while
  "the heap is non-empty" would let two timers sustain each other
  through an unbounded tail after the last request completes;
- determinism: no RNG is consumed here, ``seq`` is stable under a fixed
  push order, and ``n_pushed`` / ``n_popped`` count simulator events for
  the scale bench (events/sec) without touching the hot-path tuples.

``Ledger`` is the struct-of-arrays request ledger the vectorized gateway
engine folds over (arrival / class / version / routing-uniform /
latency / shed columns, one row per offered request), and ``IndexQueue``
the O(1)-amortized FIFO of ledger row indices that replaced the
quadratic ``list.pop(0)`` pending queues.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Iterable

import numpy as np

_INF = float("inf")


class EventHeap:
    """Min-heap of ``(t, seq, kind, *payload)`` with same-timestamp
    batching and the timer dead-tail rule (module docstring)."""

    __slots__ = ("_heap", "_seq", "timer_kinds", "n_pushed", "n_popped")

    def __init__(self, timer_kinds: Iterable[str] = ()):
        self._heap: list = []
        self._seq = itertools.count()
        self.timer_kinds = frozenset(timer_kinds)
        self.n_pushed = 0
        self.n_popped = 0

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, t: float, kind: str, *payload) -> None:
        """Schedule ``kind`` at simulated time ``t``; ties at ``t``
        process in push order (the drawn ``seq`` is unique, so payloads
        never compare)."""
        heapq.heappush(self._heap,
                       (float(t), next(self._seq), kind) + payload)
        self.n_pushed += 1

    def peek_t(self) -> float:
        """Earliest scheduled time; +inf when empty."""
        return self._heap[0][0] if self._heap else _INF

    def pop(self) -> tuple:
        """Pop the earliest event as ``(kind, *payload)``."""
        self.n_popped += 1
        return heapq.heappop(self._heap)[2:]

    def pop_batch(self) -> tuple[float, list]:
        """Pop EVERY event at the earliest time: ``(t, [(kind, *payload),
        ...])`` in seq order.  Events pushed while the batch is processed
        -- even at the same ``t`` -- belong to the next batch."""
        t = self._heap[0][0]
        batch = []
        while self._heap and self._heap[0][0] == t:
            batch.append(self.pop())
        return t, batch

    def only_timers(self) -> bool:
        """True when nothing but self-rescheduling timer kinds remain --
        the signal for periodic timers to stop re-arming (dead-tail
        rule)."""
        kinds = self.timer_kinds
        return all(e[2] in kinds for e in self._heap)


class Ledger:
    """Struct-of-arrays request ledger for one model's offered traffic.

    One row per request, columns as parallel numpy arrays: ``arr``
    (arrival time, sorted ascending -- row index IS arrival order),
    ``cls_code`` (int code into the owner's SLO-class list), ``ver``
    (backend version: 0 primary / 1 canary), ``route_u`` (the pre-drawn
    routing uniform), ``lat`` (realized latency, -1 until served) and
    ``shed`` (admission-control drop flag, set exactly once).  The
    vectorized engine appends/folds whole index ranges against these
    columns; the scalar engine addresses single rows -- both see the
    same memory, which is what makes bit-compatibility checkable.
    """

    __slots__ = ("arr", "cls_code", "ver", "route_u", "lat", "shed")

    def __init__(self, arr: np.ndarray, cls_code: np.ndarray,
                 ver: np.ndarray, route_u: np.ndarray):
        n = len(arr)
        self.arr = arr
        self.cls_code = cls_code
        self.ver = ver
        self.route_u = route_u
        self.lat = np.full(n, -1.0)
        self.shed = np.zeros(n, bool)

    def __len__(self) -> int:
        return len(self.arr)

    def deadlines(self, mult_by_code: np.ndarray, base: float) -> np.ndarray:
        """Per-request deadline column: class deadline multiple x a warm
        single-request base path (seconds)."""
        return mult_by_code[self.cls_code] * base


class IndexQueue:
    """FIFO of ledger row indices: a list plus a head cursor.

    Replaces the ``list.pop(0)`` pending queues that went quadratic
    under backlog: append/extend are amortized O(1), ``take(n)`` is one
    C-level slice, and the consumed prefix is compacted away once it
    outgrows the live tail.  Iteration and ``sorted()`` see only the
    live items, so drain/merge paths (preemption reclaim, weight-shift
    re-routing) behave exactly like the old plain list."""

    __slots__ = ("buf", "head")

    def __init__(self, items: Iterable = ()):
        self.buf = list(items)
        self.head = 0

    def __len__(self) -> int:
        return len(self.buf) - self.head

    def __bool__(self) -> bool:
        return len(self.buf) > self.head

    def __iter__(self):
        return iter(self.buf[self.head:])

    def peek(self):
        return self.buf[self.head]

    def append(self, i) -> None:
        self.buf.append(i)

    def extend(self, items) -> None:
        self.buf.extend(items)

    def popleft(self):
        i = self.buf[self.head]
        self.head += 1
        self._trim()
        return i

    def take(self, n: int) -> list:
        """Pop and return up to ``n`` items from the front (FIFO order)."""
        h = self.head
        j = min(h + n, len(self.buf))
        out = self.buf[h:j]
        self.head = j
        self._trim()
        return out

    def _trim(self) -> None:
        if self.head * 2 >= len(self.buf):
            del self.buf[:self.head]
            self.head = 0
