"""Host ms from the call into the prefill step to its return, before the synchronise, mean over the window's batches (none profiled)."""

LAYER = "runtime steps (runtime/steps.py)"
UNIT = "ms"
MOVES = "prefill_tok_s"
SOURCE = "host_clock"


def read(bench, trace):
    return 1e3 * sum(bench.host_s) / len(bench.host_s)
