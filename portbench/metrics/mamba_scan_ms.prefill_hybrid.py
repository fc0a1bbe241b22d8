"""Device busy ms per call inside the program's ``mamba/scan`` range: the Mamba-1 selective scans."""

from portbench import readers

LAYER = "Mamba-1 mixer (models/transformer.py)"
UNIT = "ms"
MOVES = "prefill_tok_s"
SOURCE = "program_span"
RANGES = ("mamba/scan",)


def read(bench, trace):
    return readers.busy_ms_per_call(bench, trace, RANGES)
