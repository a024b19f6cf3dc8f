"""Structured event log with stage timing: the port's trimmed copy of
``repro.telemetry.events`` (the part the serving strategies use).

``record`` stamps a monotonic per-log ``seq``, never the wall clock;
``stage`` wall-clocks a block and marks its event ``wall=True``.
"""
from __future__ import annotations

import contextlib
import time


class EventLog:
    def __init__(self):
        self.events: list[dict] = []
        self._seq = 0

    def record(self, name: str, duration_s: float, **meta):
        self.events.append({"name": name, "duration_s": duration_s,
                            "seq": self._seq, **meta})
        self._seq += 1

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0, wall=True, **meta)
