"""Device busy ms per step inside the program's ``model/block_slices/backward``
ranges: autograd's scatter of each block's parameter-slice gradients into the
stacked parameters' shape, and their sum over the blocks."""

from portbench import readers

LAYER = "model step (models/transformer.py, layers.py, moe.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
RANGES = ("model/block_slices/backward",)


def read(bench, trace):
    return readers.busy_ms_per_call(bench, trace, RANGES)
