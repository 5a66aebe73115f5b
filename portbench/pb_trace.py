"""The traced slice: ``torch.profiler`` over a run of consecutive
dispatches, device activity only, and its reduction to busy time, the
device operations that took most time and the idle gaps named by the
benchmark span the host was in.

The profiler records CUDA activity alone (the host's ops would multiply
the events many times over).  To place device times on the host's clock
the slice opens with a marker: the host synchronizes, reads its clock
and launches one small kernel, which is the slice's first device event.
"""

from __future__ import annotations

import re
import time

import torch


class Slice:
    """One profiled stretch.  ``start()`` then ``stop()``; afterwards
    ``events`` holds ``(name, start_s, end_s)`` on the host clock
    (``time.perf_counter``), and ``t0``/``t1`` the slice's bounds."""

    def __init__(self):
        self.prof = None
        self.events = []
        self.t0 = self.t1 = None
        self._host_mark = None
        self._marker = None

    @staticmethod
    def warm(device) -> None:
        """Start and stop the profiler once, outside any window, so that
        its first start (CUPTI's set-up) is paid in set-up."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    def start(self, device) -> None:
        self._marker = torch.zeros(1, device=device)
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(device)
        self._host_mark = time.perf_counter()
        self._marker.add_(1)  # the slice's first device event
        self.t0 = self._host_mark

    def stop(self, device) -> None:
        torch.cuda.synchronize(device)
        self.t1 = time.perf_counter()
        self.prof.stop()
        raw = device_events(self.prof)
        self.prof = None
        if not raw:
            return
        raw.sort(key=lambda e: e[1])
        offset = self._host_mark - raw[0][1]  # device clock -> host clock
        self.events = [(name, s + offset, e + offset) for name, s, e in raw[1:]]
        # the marker's launch latency put the device clock a little late
        if self.events:
            self.t0 = min(self.t0, self.events[0][1])
            self.t1 = max(self.t1, self.events[-1][2])


def device_events(prof) -> list:
    """``(name, start_s, end_s)`` of every device activity of a profile."""
    out = []
    try:
        kin = prof.profiler.kineto_results.events()
    except AttributeError:
        kin = None
    if kin is not None:
        for ev in kin:
            if str(ev.device_type()).endswith("CUDA"):
                if hasattr(ev, "start_ns"):
                    s, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
                else:
                    s, d = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
                out.append((ev.name(), s, s + d))
        return out
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            out.append((ev.name, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6))
    return out


def union(intervals) -> list:
    """Merged, sorted ``(start, end)`` intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_s(events, t0: float, t1: float) -> float:
    """Seconds of ``[t0, t1]`` in which some device operation ran."""
    clipped = [(max(s, t0), min(e, t1)) for _, s, e in events if e > t0 and s < t1]
    return sum(e - s for s, e in union(clipped))


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace wrapper,
    template arguments and parameters."""
    n = name
    if n.startswith("void "):
        n = n[5:]
    n = n.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in n:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    n = "".join(out).strip() or name
    return n[:100]


def kernel_matcher(names):
    """A predicate on device-event names: the port's kernels ``names``
    (they live in an anonymous namespace of their ``.cu`` file, which
    sets them apart from PyTorch's ``at::native::`` kernels)."""
    pat = re.compile(r"(?:^|[\s*])\(anonymous namespace\)::(?:%s)\b" % "|".join(names))
    return lambda name: bool(pat.search(name))


def device_time(events, t0: float, t1: float, match) -> float:
    """Seconds of device time of the events ``match`` accepts in the slice."""
    return sum(min(e, t1) - max(s, t0) for name, s, e in events
               if e > t0 and s < t1 and match(name))


def top_ops(events, t0: float, t1: float, k: int = 10) -> list:
    """The ``k`` device operations (by short name) that took most time."""
    tot = {}
    for name, s, e in events:
        if e > t0 and s < t1:
            key = short_name(name)
            tot[key] = tot.get(key, 0.0) + min(e, t1) - max(s, t0)
    return sorted(([n, t] for n, t in tot.items()), key=lambda x: -x[1])[:k]


def idle_gaps(events, t0: float, t1: float, spans, k: int = 10) -> list:
    """Idle device time of the slice, summed by what the host was doing
    when each gap began: the innermost benchmark span open then
    (``spans``: ``(name, start, end, depth)``), or ``"engine loop"``
    between spans; the ``k`` largest sums."""
    busy = union([(max(s, t0), min(e, t1)) for _, s, e in events if e > t0 and s < t1])
    gaps, cur = [], t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    tot = {}
    for g0, g1 in gaps:
        inner, depth = "engine loop", -1
        for name, s, e, d in spans:
            if s <= g0 < e and d > depth:
                inner, depth = name, d
        tot[inner] = tot.get(inner, 0.0) + (g1 - g0)
    return sorted(([n, t] for n, t in tot.items()), key=lambda x: -x[1])[:k]
