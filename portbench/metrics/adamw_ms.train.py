"""Device busy ms inside the program's ``train_step/adamw`` range, per step."""

from portbench import readers

LAYER = "optimizer (optim/adamw.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
RANGES = ("train_step/adamw",)


def read(bench, trace):
    return readers.busy_ms_per_call(bench, trace, RANGES)
