"""The device trace of a traced run: torch.profiler (CUPTI) over a bounded
part of the window, read from the profiler's raw records.

What it gives the metric readers: every device activity (kernels, copies,
sets) in the traced span, the span's length, and the device's busy time as
the union of those activities (the method of chip_smoke.py's `profile*`
phases).  For the breakdown: device time by operation, and, from one more
request profiled with host activity too, the device's idle time by what the
host was doing, that is the innermost host operation running at the middle
of each idle gap.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

#: The annotation around the traced requests; its span is the window.
SPAN = "benchmark.traced"
#: Host records of the CUDA runtime and driver, skipped when naming what
#: the host was doing.
_RUNTIME_PREFIX = "cu"


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


@dataclasses.dataclass
class TraceData:
    """Device and host records of the traced span, in microseconds."""

    device: list  # (name, start, end)
    host: list  # (name, start, end), sorted by start
    window: tuple  # (start, end) of the traced span

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_us(self) -> float:
        a, b = self.window
        return union_length((max(s, a), min(e, b)) for _, s, e in self.device
                            if e > a and s < b)

    def device_time(self, names) -> tuple:
        """(events, summed us) of the device records whose name holds one
        of `names`."""
        hits = [e - s for n, s, e in self.device
                if any(k in n for k in names)]
        return len(hits), sum(hits)

    def top_device_ops(self, count: int = 10) -> list:
        by_name: dict = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
        return [[n[:120], us / 1e6] for n, us in top]

    def idle_by_host_op(self, count: int = 10) -> list:
        """Idle device seconds summed by the host operation running at the
        middle of each gap, the largest first."""
        a, b = self.window
        merged = []
        for _, s, e in sorted((r for r in self.device if r[2] > a
                               and r[1] < b), key=lambda r: r[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        edges = [a] + [t for iv in merged for t in iv] + [b]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        starts = [h[1] for h in self.host]
        by_op: dict = {}
        for g0, g1 in gaps:
            label = self._host_op_at((g0 + g1) / 2, starts)
            by_op[label] = by_op.get(label, 0.0) + (g1 - g0)
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:count]
        return [[n[:120], us / 1e6] for n, us in top]

    def _host_op_at(self, t: float, starts: list, reach: int = 256) -> str:
        i = bisect.bisect_right(starts, t)
        for name, s, e in reversed(self.host[max(0, i - reach):i]):
            if e >= t and name != SPAN and not name.startswith(
                    _RUNTIME_PREFIX):
                return name
        return "python (between operations)"


class Profile:
    """torch.profiler over device activity, and over host activity where
    `host`: host records name the idle gaps, but cost the host about as
    much time again, so the device's shares are read without them."""

    def __init__(self, host: bool = False):
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        # Off the card (a rehearsal) there is no device to profile.
        activities = [ProfilerActivity.CPU] if host or not cuda else []
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._span = None

    def start(self):
        self._prof.start()
        self._span = torch.profiler.record_function(SPAN)
        self._span.__enter__()

    def stop(self, wall_us: float) -> TraceData:
        """The records of the profiled requests, which took `wall_us` on
        the host's clock."""
        self._span.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        device, host, window = [], [], None
        cuda = torch.autograd.DeviceType.CUDA
        # The raw records: prof.events() would first build a Python event
        # tree, about 70 us a record.
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e3
            rec = (e.name(), s, s + e.duration_ns() / 1e3)
            if e.device_type() == cuda:
                # The span's own mirror on the device timeline is no work.
                if rec[0] != SPAN:
                    device.append(rec)
            else:
                host.append(rec)
                if rec[0] == SPAN:
                    window = rec[1:]
        if window is None:
            # A device profile records no host span: the requests' wall
            # from their first device record, which cannot start before
            # them, nor the last end after them.
            first = min((r[1] for r in device), default=0.0)
            window = (first, first + wall_us)
        host.sort(key=lambda r: r[1])
        return TraceData(device, host, window)
