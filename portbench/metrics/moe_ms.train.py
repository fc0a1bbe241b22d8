"""Device busy ms inside the program's ``moe/dispatch`` and ``moe/combine`` ranges, per step (the forward and the remat's recompute)."""

from portbench import readers

LAYER = "MoE (models/moe.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
RANGES = ("moe/dispatch", "moe/combine")


def read(bench, trace):
    return readers.busy_ms_per_call(bench, trace, RANGES)
