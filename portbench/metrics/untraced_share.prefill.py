"""Percent of the profiled calls' kernel time that starts in no layer range of the
program (the step's own ``runtime/prefill_step`` and the benchmark's call are
not layers')."""

from portbench import spans

LAYER = "device (one H100)"
UNIT = "%"
MOVES = "prefill_tok_s"
SOURCE = "program_span"


def read(bench, trace):
    return spans.untraced_share(trace)
