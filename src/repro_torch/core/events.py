"""Minimal discrete-event engine for the EPD serving simulator."""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Optional, Tuple


class EventLoop:
    def __init__(self):
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.now = 0.0
        # called with each positive clock jump BEFORE the event fires —
        # the telemetry accountant hangs here so every simulated-time
        # advance is charged to the open requests (sum-to-e2e invariant)
        self.on_advance: Optional[Callable[[float], None]] = None

    def at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (max(t, self.now), next(self._seq), fn))

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.now + dt, fn)

    def run(self, until: float = float("inf")) -> None:
        while self._heap and self._heap[0][0] <= until:
            t, _, fn = heapq.heappop(self._heap)
            dt = t - self.now
            self.now = t
            if dt > 0 and self.on_advance is not None:
                self.on_advance(dt)
            fn()

    def __bool__(self) -> bool:
        return bool(self._heap)
