"""What the readers of the program's own ranges share, beside
``readers.busy_ms_per_call``: a range's self time, the recompute's time,
the share of busy time in no layer's range, and the device's idle time
while the host is inside the program.

The program's ranges (``repro_torch/obs/ranges.py``) nest: a layer's
backward holds its plain attention backward or a block's recompute.
``torch.profiler`` books a kernel to the innermost user range open on the
thread that launched it, and gives each occurrence of a range a device
extent from the first to the last kernel booked to it.  On one stream a
kernel so lies in the extent of its own range, and in the extent of an
enclosing range only where that range's own kernels come before and after
it.  So a range's self time is the device time of the kernels that start in
one of its extents and in no extent of another range nested there, and its
busy time counts every kernel that starts in one of its extents.

A reader returns None where the trace lacks the ranges it reads (the parent
of the change that added them), and 0.0 where they hold no kernel.
"""

from __future__ import annotations

import numpy as np

from .profiling import CALL_RANGE

#: ranges that hold a whole step or call, not one layer
STEP_RANGES = (CALL_RANGE, "train_step/loss_and_grad", "runtime/prefill_step")
#: the block remat's range: the second forward of a block inside the backward
RECOMPUTE = "block/recompute"
#: the first and the last layer range of a training step's backward
BACKWARD_FIRST, BACKWARD_LAST = "model/head_loss/backward", "model/embed/backward"


def _kernels(trace):
    """(starts, durations) of the trace's kernels, by start, as arrays."""
    starts = np.array([a for a, _, _ in trace.kernels], dtype=float)
    ends = np.array([b for _, b, _ in trace.kernels], dtype=float)
    return starts, ends - starts


def _within(starts, extents) -> np.ndarray:
    """Mask of the kernels that start within one of the (a, b) extents."""
    inside = np.zeros(len(starts), dtype=bool)
    for a, b in extents:
        inside[np.searchsorted(starts, a, "left"):np.searchsorted(starts, b, "left")] = True
    return inside


def _layer_extents(trace, skip=()) -> list:
    """(a, b) device extents of every layer range (not ``STEP_RANGES``) but
    those named in ``skip``."""
    return [e for name, exts in trace.extents.items()
            if name not in STEP_RANGES and name not in skip for e in exts]


def _per_call(bench, us: float) -> float | None:
    if not bench.traced_calls:
        return None
    return us / len(bench.traced_calls) / 1e3


def self_ms_per_call(bench, trace, name: str) -> float | None:
    """Self time of range ``name``, device ms a call: the kernels that start
    in one of its extents, less those that start in an extent of another
    program range nested in that extent."""
    own = trace.extents.get(name)
    if not own:
        return None
    others = _layer_extents(trace, skip=(name,))
    nested = [(c, d) for a, b in own for c, d in others if a <= c and d <= b]
    starts, durations = _kernels(trace)
    kept = _within(starts, own) & ~_within(starts, nested)
    return _per_call(bench, float(durations[kept].sum()))


def backward_windows(trace) -> list:
    """(a, b) of each training step's backward on the device: from an
    extent of ``BACKWARD_FIRST`` to the end of the first extent of
    ``BACKWARD_LAST`` after it."""
    last = sorted(trace.extents.get(BACKWARD_LAST, []))
    windows = []
    for a, _ in sorted(trace.extents.get(BACKWARD_FIRST, [])):
        ends = [d for c, d in last if c >= a]
        if ends:
            windows.append((a, ends[0]))
    return windows


def recompute_ms_per_call(bench, trace) -> float | None:
    """Device ms a call of the block remat's recompute: the kernels in
    ``RECOMPUTE``'s extents and in the extents of the forward's ranges
    (those not named ``*backward``) that lie in a step's backward.  A
    recompute ends inside its last sublayer's range, after the last of
    ``RECOMPUTE``'s own kernels, so its own extents alone miss that part."""
    own = trace.extents.get(RECOMPUTE)
    windows = backward_windows(trace)
    if not own or not windows:
        return None
    forward = [e for name, exts in trace.extents.items()
               if name not in STEP_RANGES and not name.endswith("backward") for e in exts]
    inner = [(c, d) for c, d in forward if any(a <= c and d <= b for a, b in windows)]
    starts, durations = _kernels(trace)
    return _per_call(bench, float(durations[_within(starts, own + inner)].sum()))


def untraced_share(trace, needs=("layer/mixer", "layer/ffn")) -> float | None:
    """Percent of the profiled calls' kernel time that starts in no layer
    range's extent (``STEP_RANGES`` are not layers'); None unless the trace
    has the ranges ``needs``."""
    if not trace.kernels or not all(trace.extents.get(n) for n in needs):
        return None
    starts, durations = _kernels(trace)
    outside = ~_within(starts, _layer_extents(trace))
    return 100.0 * float(durations[outside].sum()) / float(durations.sum())


def idle_gaps(trace) -> list:
    """(a, b) of each gap between the device's kernels (one stream: a gap
    ends where the next kernel starts after every earlier one ended)."""
    gaps, end = [], None
    for a, b, _ in trace.kernels:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def idle_ms_per_call_in(bench, trace, names) -> float | None:
    """Idle device ms a call in the gaps whose midpoint falls while the host
    is inside one of the program's ranges ``names`` (on any thread); None
    where the host never opened one."""
    host = sorted((a, b) for a, b, name, _ in trace.host if name in names)
    if not host:
        return None
    opened = np.array([a for a, _ in host])
    # the latest end among the ranges opened so far: ranges may nest
    closed = np.maximum.accumulate(np.array([b for _, b in host]))
    idle = 0.0
    for a, b in idle_gaps(trace):
        mid = (a + b) / 2
        i = np.searchsorted(opened, mid, "right") - 1
        if i >= 0 and closed[i] > mid:
            idle += b - a
    return _per_call(bench, idle)
