"""Reading the traced run: CUDA events at the trainer's phase boundaries,
and a ``torch.profiler`` window reduced to device intervals, kernel times
and the host's activity in the device's idle gaps."""

from __future__ import annotations

import bisect
import math
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

Interval = Tuple[float, float]


def busy_union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals: the time the
    device ran at least one operation, each instant counted once however
    many ran in it."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def idle_gaps(intervals) -> List[Interval]:
    """The gaps between the union's runs of busy time, in order."""
    gaps, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


class PhaseClock:
    """CUDA events at each iteration's start, after its rollout (and GAE)
    and at its end, recorded from the trainer's ``phase_hook``; one triple
    an iteration."""

    def __init__(self) -> None:
        self.events: List[List[torch.cuda.Event]] = []

    def __call__(self, phase: str) -> None:
        if phase == "rollout":
            self.events.append([])
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events[-1].append(event)

    def phase_ms(self) -> List[Tuple[float, float]]:
        """``(rollout ms, update ms)`` of each whole iteration recorded
        (synchronize first)."""
        return [(e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2]))
                for e in self.events if len(e) == 3]


class Profile:
    """A ``torch.profiler`` segment from ``start`` to ``stop``, each taken
    once the device has finished what was queued before it, reduced to
    what the per-layer readers need: the device intervals, each kernel's
    launches and device time, and the CPU operations the host ran."""

    def __init__(self) -> None:
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.busy_us = self.window_us = 0.0

    @classmethod
    def of(cls, run: Callable[[], None]) -> "Profile":
        """The segment of one call of ``run``."""
        segment = cls()
        segment.start()
        run()
        segment.stop()
        return segment

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.window_us = (time.perf_counter() - self._t0) * 1e6
        self._prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.events():
            a, b = e.time_range.start, e.time_range.end
            if b <= a:
                continue
            if e.device_type == cuda:
                self.device.append((e.name, a, b))
            else:
                self.host.append((e.name, a, b))
        self.busy_us = busy_union_us((a, b) for _, a, b in self.device)
        del self._prof

    def kernels(self, key: str) -> List[float]:
        """Device microseconds of each launch whose name holds ``key``."""
        return [b - a for n, a, b in self.device if key in n]

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time, in seconds."""
        total: Dict[str, float] = defaultdict(float)
        for n, a, b in self.device:
            total[n] += b - a
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], t / 1e6] for n, t in ranked]

    def idle_by_host(self, top: int = 10) -> List[List]:
        """The device's idle gaps, summed by the innermost host operation
        running at each gap's middle (``"host idle"`` where none was), in
        seconds, the longest first."""
        gaps = idle_gaps((a, b) for _, a, b in self.device)
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        total: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            name = "host idle"
            # The latest-starting operation still running at ``mid``.
            for i in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 4097),
                           -1):
                if host[i][2] >= mid:
                    name = host[i][0][:120]
                    break
            total[name] += b - a
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n, t / 1e6] for n, t in ranked]
