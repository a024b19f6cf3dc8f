"""Structured event log with stage timing: the port's trimmed copy of
``repro.telemetry.events`` (the part the serving strategies and the gateway
use).

``record`` stamps a monotonic per-log ``seq``, never the wall clock;
``stage`` wall-clocks a block and marks its event ``wall=True``; ``dump``
strips every wall-clock field, so two seeded simulated runs dump the same
text.  The gateway's event vocabulary is the reference's.
"""
from __future__ import annotations

import contextlib
import json
import time

# meta keys that carry wall-clock measurements; dump() gates them
_WALL_KEYS = ("wall_s",)


class EventLog:
    def __init__(self):
        self.events: list[dict] = []
        self._by_name: dict[str, list] = {}  # name -> events (same dicts)
        self._seq = 0

    def record(self, name: str, duration_s: float, **meta):
        e = {"name": name, "duration_s": duration_s, "seq": self._seq, **meta}
        self._seq += 1
        self.events.append(e)
        self._by_name.setdefault(name, []).append(e)

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0, wall=True, **meta)

    def named(self, name: str) -> list:
        """All events with this name, in record order."""
        return list(self._by_name.get(name, ()))

    def count(self, name: str) -> int:
        return len(self._by_name.get(name, ()))

    def dump(self) -> str:
        """JSON export with every wall-clock field stripped (``wall_s`` meta
        everywhere; ``duration_s`` on ``wall=True`` stage events)."""
        events = []
        for e in self.events:
            drop = _WALL_KEYS + (("duration_s",) if e.get("wall") else ())
            events.append({k: v for k, v in e.items() if k not in drop})
        return json.dumps(events, indent=1, default=str)
