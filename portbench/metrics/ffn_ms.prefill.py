"""Device busy ms per call inside the program's ``layer/ffn`` ranges: each layer's
norm and MLP."""

from portbench import readers

LAYER = "MLP (models/layers.py)"
UNIT = "ms"
MOVES = "prefill_tok_s"
SOURCE = "program_span"
RANGES = ("layer/ffn",)


def read(bench, trace):
    return readers.busy_ms_per_call(bench, trace, RANGES)
