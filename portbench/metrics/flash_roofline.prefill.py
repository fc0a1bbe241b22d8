"""Percent of the flash-attention forward's bound (portbench/counts.py) that its launches reached, over their device time."""

from portbench import readers

LAYER = "kernels (flash_attention.cu)"
UNIT = "%"
MOVES = "prefill_tok_s"
SOURCE = "device_trace"
#: the forward kernel instances of ``flash_attention.cu``, by name
KERNELS = ("attn_fwd_bf16_tma", "attn_fwd_bf16_sync")


def read(bench, trace):
    return readers.flash_roofline(bench, trace, KERNELS)
