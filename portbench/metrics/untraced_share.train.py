"""Percent of the profiled step's kernel time that starts in no layer range of the
program (the step's own ``train_step/loss_and_grad`` and the benchmark's call
are not layers')."""

from portbench import spans

LAYER = "device (one H100)"
UNIT = "%"
MOVES = "train_tok_s"
SOURCE = "program_span"


def read(bench, trace):
    return spans.untraced_share(trace)
