"""Percent of the selective scan's bound that the scans reached: the profiled calls' scans (one a Mamba layer) times the bound of one at each call's shape (portbench/counts_hybrid.py), over the device time in the program's ``mamba/scan`` range, whatever kernel runs there."""

from portbench import counts_hybrid

LAYER = "kernels (selective_scan.cu)"
UNIT = "%"
MOVES = "prefill_tok_s"
SOURCE = "device_trace"
RANGE = "mamba/scan"


def read(bench, trace):
    took = trace.busy_in_s(RANGE)
    if not took or not bench.traced_calls:
        return None
    layers = counts_hybrid.n_mamba(bench.cfg)
    bound = sum(layers * counts_hybrid.scan_bound_s(bench.cfg, B, S)
                for B, S in bench.traced_calls)
    return 100.0 * bound / took
