"""Percent of the flash-attention backward's bound that its kernels reached, over their device time.

The bound of one backward (one ``attn_bwd_main`` launch) at a call's shape is
``counts.bound_s`` of 2.5 times the forward's FLOPs (five products of 2 dh a
visible pair and query head: S, dP, dV, dK, dQ, against the forward's two)
and twice its bytes (q, k, v, o and dO read, dq, dk and dv written, against
q, k, v read and o written).  The device time is that of every backward
kernel (``attn_bwd_`` in the name: the prep pass, the main kernel, the dQ
pass).  A trace without the backward kernels (the plain backward) reads
nothing."""

from portbench import counts

LAYER = "kernels (flash_attention.cu)"
UNIT = "%"
MOVES = "train_tok_s"
SOURCE = "device_trace"
#: one launch per backward
MAIN = ("attn_bwd_main",)
#: every kernel of the backward
KERNELS = ("attn_bwd_",)


def launch_bound_s(cfg, B, S) -> float:
    """The bound of one causal bf16 backward of one layer over B sequences of S."""
    nbytes, flops = counts.attention_work(B, S, S, cfg["n_heads"], cfg["n_kv_heads"],
                                          cfg["head_dim"], True, cfg.get("swa_window"), 2)
    return counts.bound_s(2.5 * flops, 2 * nbytes)


def read(bench, trace):
    if len(trace.calls) != len(bench.traced_calls):
        return None
    bound = took = 0.0
    for j, (B, S) in enumerate(bench.traced_calls):
        bound += len(trace.kernels_named(MAIN, call=j)) * launch_bound_s(bench.cfg, B, S)
        took += sum(b - a for a, b, _ in trace.kernels_named(KERNELS, call=j)) / 1e6
    return 100.0 * bound / took if took > 0 and bound > 0 else None
