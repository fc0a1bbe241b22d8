"""Device busy ms inside the program's ``moe/experts`` range, per step: the
experts' batched products, in the forward and in the block remat's recompute."""

from portbench import readers

LAYER = "MoE (models/moe.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
RANGES = ("moe/experts",)


def read(bench, trace):
    return readers.busy_ms_per_call(bench, trace, RANGES)
