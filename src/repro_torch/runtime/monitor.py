"""Runtime health (port of ``repro.runtime.monitor``): a step timer, a
nearest-rank percentile and the hang watchdog that ``Engine.health()``
reads; the straggler detector over per-host step times and the
cooperative preemption guard that ``train.trainer.Trainer`` checks every
step."""

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


class StragglerDetector:
    """Flags hosts whose rolling median step time exceeds the fleet median
    (the median of the hosts' medians) by ``threshold`` x."""

    def __init__(self, n_hosts: int, window: int = 20, threshold: float = 1.5):
        self.threshold = threshold
        self.hosts = [collections.deque(maxlen=window) for _ in range(n_hosts)]

    def report(self, host_id: int, step_time: float):
        self.hosts[host_id].append(step_time)

    def stragglers(self):
        meds = [statistics.median(h) if h else None for h in self.hosts]
        known = [m for m in meds if m is not None]
        if not known:
            return []
        fleet = statistics.median(known)
        return [i for i, m in enumerate(meds)
                if m is not None and fleet > 0 and m > self.threshold * fleet]


class PreemptionGuard:
    """Cooperative preemption: an orchestrator calls ``signal()``; the
    training loop reads ``should_stop`` every step and checkpoints before
    it exits."""

    def __init__(self):
        self._stop = False

    def signal(self):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop
