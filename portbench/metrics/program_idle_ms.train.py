"""Idle device ms per step in the gaps between kernels whose midpoint falls while
the host is inside the program's step ranges (its own thread's or autograd's):
the device waiting on the program's host work."""

from portbench import spans

LAYER = "runtime steps (runtime/steps.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
RANGES = ("train_step/loss_and_grad", "train_step/adamw")


def read(bench, trace):
    return spans.idle_ms_per_call_in(bench, trace, RANGES)
