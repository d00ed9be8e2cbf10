"""Periodic gating and metric aggregation, a copy of
``surreal_tpu/session/tracker.py`` (``PeriodicTracker``,
``PeriodicTimeTracker``, ``MetricAggregator``): jax-free code the port
keeps its own copy of.
"""

from __future__ import annotations

import time
from collections import defaultdict


class PeriodicTracker:
    """True every N increments (reference: PeriodicTracker)."""

    def __init__(self, period: int, init_count: int = 0):
        if period < 1:
            raise ValueError("period must be >= 1")
        self.period = period
        self._count = init_count

    def track_increment(self, n: int = 1) -> bool:
        prev = self._count // self.period
        self._count += n
        return self._count // self.period > prev

    @property
    def count(self) -> int:
        return self._count


class PeriodicTimeTracker:
    """True at most once every ``interval`` seconds."""

    def __init__(self, interval_s: float):
        self.interval_s = interval_s
        self._last = None

    def track(self) -> bool:
        now = time.monotonic()
        if self._last is None or now - self._last >= self.interval_s:
            self._last = now
            return True
        return False


class MetricAggregator:
    """Accumulate scalars between flushes; mean per key (tensorplex's
    per-group averaging, collapsed into one process)."""

    def __init__(self):
        self._sums: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    def add(self, metrics: dict[str, float]) -> None:
        for key, value in metrics.items():
            self._sums[key] += float(value)
            self._counts[key] += 1

    def flush(self) -> dict[str, float]:
        out = {k: self._sums[k] / self._counts[k] for k in self._sums}
        self._sums.clear()
        self._counts.clear()
        return out

    def __len__(self) -> int:
        return len(self._sums)
