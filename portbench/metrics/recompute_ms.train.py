"""Device busy ms per step of the block remat's recompute: the program's
``block/recompute`` range and the forward ranges that run inside the step's
backward."""

from portbench import spans

LAYER = "model step (models/transformer.py, layers.py, moe.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"


def read(bench, trace):
    return spans.recompute_ms_per_call(bench, trace)
