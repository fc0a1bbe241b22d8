"""Device busy ms per call inside the program's ``layer/mixer`` ranges: each
layer's norm, projections, RoPE, flash forward and output projection."""

from portbench import readers

LAYER = "attention (models/layers.py)"
UNIT = "ms"
MOVES = "prefill_tok_s"
SOURCE = "program_span"
RANGES = ("layer/mixer",)


def read(bench, trace):
    return readers.busy_ms_per_call(bench, trace, RANGES)
