"""Serving-step health (port of ``repro.runtime.monitor``'s serving part):
a step timer, a nearest-rank percentile and the hang watchdog that
``Engine.health()`` reads.  The reference's ``StragglerDetector`` and
``PreemptionGuard`` serve training and distribution and wait for those
slices (ROADMAP queue 1)."""

from __future__ import annotations

import collections
import statistics
import time


class StepTimer:
    """Wall time of one step at a time, over a rolling window."""

    def __init__(self, window: int = 20):
        self.times = collections.deque(maxlen=window)
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]); 0.0 on empty input."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


class HangWatchdog:
    """Flags a step whose wall time exceeds ``threshold`` x the rolling
    median of the last ``window`` steps, once ``min_samples`` are in.
    ``note(dt)`` returns True for such a step.  Slow steps still enter the
    window, so a persistently slow phase raises the median and stops
    re-flagging: the watchdog detects discontinuities, not load."""

    def __init__(self, threshold: float = 10.0, window: int = 20, min_samples: int = 5):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1, got {threshold}")
        self.threshold = threshold
        self.min_samples = min_samples
        self.times = collections.deque(maxlen=window)
        self.trips = 0

    def note(self, dt: float) -> bool:
        slow = False
        if len(self.times) >= self.min_samples:
            med = statistics.median(self.times)
            if med > 0 and dt > self.threshold * med:
                slow = True
                self.trips += 1
        self.times.append(dt)
        return slow
