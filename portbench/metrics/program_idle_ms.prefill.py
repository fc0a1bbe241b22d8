"""Idle device ms per call in the gaps between kernels whose midpoint falls while
the host is inside the program's ``runtime/prefill_step``: the device waiting
on the prefill's host work."""

from portbench import spans

LAYER = "runtime steps (runtime/steps.py)"
UNIT = "ms"
MOVES = "prefill_tok_s"
SOURCE = "program_span"
RANGES = ("runtime/prefill_step",)


def read(bench, trace):
    return spans.idle_ms_per_call_in(bench, trace, RANGES)
