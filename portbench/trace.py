"""Device readings from torch.profiler: device time per call, the device's
busy time over a stretch of requests, the operations that took most of it
and the longest idle gaps by what the host was doing.  Everything stays in
memory; nothing is written to disk."""

from __future__ import annotations

import dataclasses
import heapq
import time

import torch

STRETCH = "portbench.stretch"     # the profiled stretch's own annotation
NAME_CHARS = 160                  # kernel names are cut to this length


@dataclasses.dataclass
class Profile:
    """A profiled stretch: wall seconds (host clock, synchronised at both
    ends), device intervals [(start_us, end_us, name)] and host operations
    [(start_us, end_us, name)] on one clock, the stretch's start in us."""
    wall_s: float
    start_us: float
    device: list
    host: list

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the device intervals)."""
        return sum(e - s for s, e in _union(self.device)) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        by = {}
        for s, e, name in self.device:
            name = name[:NAME_CHARS]
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host activity, seconds]]: the device's idle gaps inside the
        stretch, each named by the innermost host operation running at its
        middle, summed by name, the longest first."""
        end_us = self.start_us + self.wall_s * 1e6
        busy = _union(self.device)
        gaps, t = [], self.start_us
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if end_us > t:
            gaps.append((t, end_us))
        # sweep the gaps' middles in time order over the host operations in
        # start order: the innermost operation running at a middle is the
        # running one that started last
        host = sorted(self.host)
        active, by, i = [], {}, 0
        for s, e in gaps:
            mid = 0.5 * (s + e)
            while i < len(host) and host[i][0] <= mid:
                heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
                i += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            name = active[0][2][:NAME_CHARS] if active else "host outside any operation"
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _union(intervals):
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn, n: int, host: bool = True) -> Profile:
    """Profile n calls of fn (after one call outside the profile): CUDA
    activity, and the host's operations where ``host`` (their recording
    slows the host, so a stretch timed for its idle share leaves it out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with _profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    device, host, start = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.name == STRETCH:
            # the annotation appears on the host and, as a range, on the
            # device; neither is work
            if e.device_type == DeviceType.CPU:
                start = tr.start
        elif e.device_type == DeviceType.CUDA:
            device.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    if start is None:
        start = min((s for s, _, _ in device), default=0.0)
    return Profile(wall, start, device, host)


def device_ms_per_call(fn, n: int = 20) -> float | None:
    """Device milliseconds per call of fn: the device operations' time over
    n calls; None where the trace holds no device operation."""
    p = profile(fn, n)
    if not p.device:
        return None
    return sum(e - s for s, e, _ in p.device) / 1e3 / n
