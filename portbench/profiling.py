"""The device trace of a run's profiled calls, and what the metric readers
read from it.

``Trace.capture`` runs calls under ``torch.profiler`` (host and device
activities), each inside a range of the benchmark's own, ``portbench/call``,
and keeps the device's kernel intervals, the device-side extents of every
``record_function`` range (the program's own, such as ``moe/dispatch``, and
the benchmark's), and the host's ranges and ops, from which an idle gap is
named by what the host was doing while the device waited.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

CALL_RANGE = "portbench/call"
#: the longest idle gaps that are named by the host's work (the rest are
#: counted in the idle share alone)
NAMED_GAPS = 500


# copied from chip_smoke.py at PR 24 (profile_device's interval union)
def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals: kernels that overlap
    count once."""
    union, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    return union


# copied from chip_smoke.py at PR 24 (profile_device's in-range busy time)
def busy_in_us(starts, extents) -> float:
    """Device time of the kernels, (start, duration) pairs, that start
    within one of the (start, end) extents of a range on the device's
    timeline (one stream): the range's busy time, idle gaps left out."""
    return sum(d for at, d in starts if any(a <= at < b for a, b in extents))


# copied from chip_smoke.py at PR 24
def time_ms(fn, torch, min_s=0.2):
    """Mean device time of one call, by CUDA events over a run of calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    n = max(3, min(200, int(min_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


@dataclass
class Trace:
    """One profiled stretch of calls.  Times are in microseconds on the
    profiler's clock, ``wall_s`` on the host's."""

    wall_s: float
    kernels: list                                   # (start, end, name) on the device
    extents: dict = field(default_factory=dict)     # range name -> [(start, end)] on the device
    calls: list = field(default_factory=list)       # (start, end) of each call on the device
    host: list = field(default_factory=list)        # (start, end, name, is_range) on the host
    table: str = ""

    @classmethod
    def capture(cls, torch, calls) -> "Trace":
        """Runs each thunk of ``calls`` in order under the profiler, then
        synchronises; ``wall_s`` is the host's time from the first call to
        that synchronise."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for fn in calls:
                with torch.profiler.record_function(CALL_RANGE):
                    fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        tr = cls.from_events(prof.events(), wall)
        tr.table = prof.key_averages().table(sort_by="device_time_total", row_limit=80)
        return tr

    @classmethod
    def from_events(cls, events, wall_s: float, table: str = "") -> "Trace":
        ranges = {ev.name for ev in events
                  if ev.device_type.name == "CPU" and getattr(ev, "is_user_annotation", False)}
        kernels, extents, host = [], {}, []
        for ev in events:
            a, b = ev.time_range.start, ev.time_range.end
            if ev.device_type.name == "CUDA":
                if ev.name in ranges or getattr(ev, "is_user_annotation", False):
                    extents.setdefault(ev.name, []).append((a, b))
                else:
                    kernels.append((a, b, ev.name))
            else:
                host.append((a, b, ev.name, ev.name in ranges))
        kernels.sort()
        calls = sorted(extents.get(CALL_RANGE, []))
        return cls(wall_s, kernels, extents, calls, host, table)

    # -- what the readers use ------------------------------------------------
    @property
    def busy_s(self) -> float:
        return union_us((a, b) for a, b, _ in self.kernels) / 1e6

    def busy_in_s(self, range_name: str) -> float | None:
        """Device busy seconds inside the program's range ``range_name``;
        None where the trace has no such range."""
        extents = self.extents.get(range_name)
        if not extents:
            return None
        return busy_in_us([(a, b - a) for a, b, _ in self.kernels], sorted(extents)) / 1e6

    def kernels_named(self, parts, call: int | None = None):
        """(start, end, name) of the kernels whose name holds one of
        ``parts``, within call ``call``'s extent where given."""
        lo, hi = self.calls[call] if call is not None else (float("-inf"), float("inf"))
        return [k for k in self.kernels
                if lo <= k[0] < hi and any(p in k[2] for p in parts)]

    def top_ops(self, n: int = 10):
        """[[kernel name, device seconds]] of the ``n`` kernels that took most."""
        by = {}
        for a, b, name in self.kernels:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """[[what the host was doing, idle seconds]]: the ``NAMED_GAPS``
        longest gaps between the device's kernels, each named by the
        innermost range and op the host had open at its middle, summed by
        name, the ``n`` largest."""
        gaps, end = [], None
        for a, b, _ in self.kernels:
            if end is not None and a > end:
                gaps.append((a - end, end, a))
            end = b if end is None else max(end, b)
        gaps = sorted(gaps, reverse=True)[:NAMED_GAPS]
        if not gaps or not self.host:
            return []
        starts = np.array([h[0] for h in self.host])
        ends = np.array([h[1] for h in self.host])
        is_range = np.array([h[3] for h in self.host])
        by = {}
        for length, a, b in gaps:
            mid = (a + b) / 2
            cover = (starts <= mid) & (ends > mid)
            label = []
            for kind in (True, False):
                idx = np.nonzero(cover & (is_range == kind))[0]
                if len(idx):
                    label.append(self.host[idx[np.argmax(starts[idx])]][2])
            name = " > ".join(label) or "host outside any range"
            by[name] = by.get(name, 0.0) + length / 1e6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

