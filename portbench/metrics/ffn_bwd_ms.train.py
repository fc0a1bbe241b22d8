"""Self time of the program's ``layer/ffn/backward`` range, device ms per step:
the ffn's backward (for granite-moe the MoE's, its index backward included),
without the block remat's recompute and the other ranges nested in it."""

from portbench import spans

LAYER = "MoE (models/moe.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
RANGE = "layer/ffn/backward"


def read(bench, trace):
    return spans.self_ms_per_call(bench, trace, RANGE)
