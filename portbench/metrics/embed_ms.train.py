"""Device busy ms per step inside the program's ``model/embed`` range and its
backward: the lookup and cast, and the embedding's index backward."""

from portbench import readers

LAYER = "model step (models/transformer.py, layers.py, moe.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
RANGES = ("model/embed", "model/embed/backward")


def read(bench, trace):
    return readers.busy_ms_per_call(bench, trace, RANGES)
