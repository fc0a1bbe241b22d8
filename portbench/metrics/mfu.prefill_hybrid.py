"""Percent of the bf16 peak: the hybrid's model FLOPs of the window's work (portbench/counts_hybrid.py) over the window's seconds."""

from portbench import readers

LAYER = "model step (models/transformer.py, layers.py, moe.py)"
UNIT = "%"
MOVES = "prefill_tok_s"
SOURCE = "host_clock"


def read(bench, trace):
    return readers.mfu(bench)
