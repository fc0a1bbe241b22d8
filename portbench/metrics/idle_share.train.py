"""Percent of the profiled calls' wall in which no kernel ran on the card."""

from portbench import readers

LAYER = "device (one H100)"
UNIT = "%"
MOVES = "train_tok_s"
SOURCE = "device_trace"


def read(bench, trace):
    return readers.idle_share(trace)
