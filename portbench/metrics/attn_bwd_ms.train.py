"""Device busy ms inside the program's ``flash_attention/plain_backward`` range, per step."""

from portbench import readers

LAYER = "attention (kernels/flash_attention/ops.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
RANGES = ("flash_attention/plain_backward",)


def read(bench, trace):
    return readers.busy_ms_per_call(bench, trace, RANGES)
