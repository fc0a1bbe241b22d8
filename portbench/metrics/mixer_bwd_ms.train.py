"""Self time of the program's ``layer/mixer/backward`` range, device ms per step:
the attention sublayer's backward (norm, projections, RoPE) without
``flash_attention/plain_backward`` nested in it."""

from portbench import spans

LAYER = "attention (models/layers.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
RANGE = "layer/mixer/backward"


def read(bench, trace):
    return spans.self_ms_per_call(bench, trace, RANGE)
