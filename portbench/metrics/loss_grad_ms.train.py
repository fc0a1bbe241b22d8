"""Device busy ms of the loss and its gradients, per step: the step's busy
time outside the program's ``train_step/adamw`` range.  The program's own
``train_step/loss_and_grad`` range holds only the forward on the device:
autograd launches the backward from its device thread, outside the host's
range."""

from portbench import readers

LAYER = "runtime steps (runtime/steps.py)"
UNIT = "ms"
MOVES = "train_tok_s"
SOURCE = "program_span"
RANGES = ("train_step/adamw",)


def read(bench, trace):
    return readers.busy_ms_per_call_outside(bench, trace, RANGES)
