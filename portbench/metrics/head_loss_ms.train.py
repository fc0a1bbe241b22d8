"""Device busy ms per step inside the program's ``model/final_norm`` and
``model/head_loss`` ranges and their backwards: the final norm, the LM head's
products, logsumexp and gather, and the tied table's head gradient."""

from portbench import readers

LAYER = "model step (models/transformer.py, layers.py, moe.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
RANGES = ("model/final_norm", "model/final_norm/backward", "model/head_loss",
          "model/head_loss/backward")


def read(bench, trace):
    return readers.busy_ms_per_call(bench, trace, RANGES)
