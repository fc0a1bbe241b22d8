"""What the per-layer metric readers share.  A reader returns None where
its trace holds nothing for it to read; the harness then leaves the metric
out of the line and says so on standard error."""

from __future__ import annotations

from . import counts
from .profiling import CALL_RANGE


def busy_ms_per_call(bench, trace, ranges) -> float | None:
    """Device busy ms inside the program's ``ranges``, per profiled call."""
    busy = [trace.busy_in_s(r) for r in ranges]
    if any(b is None for b in busy) or not bench.traced_calls:
        return None
    return sum(busy) / len(bench.traced_calls) * 1e3


def busy_ms_per_call_outside(bench, trace, ranges) -> float | None:
    """Device busy ms of the profiled calls outside the program's ``ranges``,
    per call: what a range cannot hold, as the kernels autograd launches
    from its own thread, outside the host's range."""
    inside = busy_ms_per_call(bench, trace, ranges)
    if inside is None or len(trace.calls) != len(bench.traced_calls):
        return None
    calls = trace.busy_in_s(CALL_RANGE) / len(bench.traced_calls) * 1e3
    return calls - inside


def flash_roofline(bench, trace, kernels) -> float | None:
    """Percent of the flash forward's bound its launches reached: each
    profiled call's launches of ``kernels`` times the bound of one launch at
    that call's shape, over their device time."""
    if len(trace.calls) != len(bench.traced_calls):
        return None
    bound = took = 0.0
    for j, (B, S) in enumerate(bench.traced_calls):
        launches = trace.kernels_named(kernels, call=j)
        bound += len(launches) * counts.flash_launch_bound_s(bench.cfg, B, S)
        took += sum(b - a for a, b, _ in launches) / 1e6
    return 100.0 * bound / took if took > 0 else None


def mfu(bench) -> float:
    """Percent of the bf16 peak the window's model FLOPs took of its time."""
    return 100.0 * bench.window_flops / (bench.window_s * counts.PEAK_BF16_FLOPS)


def idle_share(trace) -> float | None:
    """Percent of the profiled calls' wall in which no kernel ran."""
    if not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.wall_s)
