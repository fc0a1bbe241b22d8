"""The work a call must do, counted from its shapes: FLOPs and bytes.

The benchmark keeps its own counts, so a kernel's roofline and the step's
share of the peak read the same work whatever implements it.  Nothing here
imports the program.

Model FLOPs (``prefill_flops``, ``train_flops``) count the matrix products
a token passes through and attention over the band the model allows:

- per layer, the attention projections ``d * (H + 2 KV) * dh + H * dh * d``,
  then the dense SwiGLU ``3 d f`` or, with experts, the router ``d E`` and
  ``top_k`` experts of ``3 d f``;
- the LM head ``d V``: in a prefill on the last position of each request
  only (the program computes no other logits), in training on every token;
- attention ``4 dh`` FLOPs per (query, key) pair the causal band keeps
  (QK^T and PV), per query head.

A prefill is 2 FLOPs per weight and token; a training step 6 (forward and
backward) and attention 3 times its forward.  No recompute is counted:
remat is work the program chose to do again.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit: bf16 tensor-core
#: FLOP/s and HBM3 bytes/s (the figures of ``roofline/hw.py::HW_H100``)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


# copied from chip_smoke.py at PR 24
def attention_work(B, Sq, Skv, H, KV, dh, causal, window, elem_bytes):
    """(bytes, flops) the attention forward must move and do: q, k, v read
    once, o written once; 4 * dh flops per unmasked (q, k) pair."""
    pairs = 0
    for q in range(Sq):
        lo = max(0, q - window + 1) if window is not None else 0
        hi = min(Skv, q + 1) if causal else Skv
        pairs += max(0, hi - lo)
    nbytes = elem_bytes * dh * (2 * B * Sq * H + 2 * B * Skv * KV)
    return nbytes, 4 * dh * pairs * B * H


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the FLOPs over the
    bf16 peak and the bytes over the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def causal_pairs(S: int, window: int | None) -> int:
    """(query, key) pairs of a causal self-attention over S positions whose
    keys lie within ``window`` of the query (all earlier keys with None)."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def layer_weights(cfg: dict) -> int:
    """Weights of one layer's matrix products that each token passes through."""
    d, H, KV, dh, f = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff"))
    attn = d * (H + 2 * KV) * dh + H * dh * d
    moe = cfg.get("moe")
    if moe is None:
        return attn + 3 * d * f
    return attn + d * moe["n_experts"] + moe["top_k"] * 3 * d * f


def attention_flops(cfg: dict, B: int, S: int) -> int:
    """Forward attention FLOPs of all layers over B causal sequences of S."""
    pairs = causal_pairs(S, cfg.get("swa_window"))
    return cfg["n_layers"] * 4 * cfg["head_dim"] * cfg["n_heads"] * B * pairs


def prefill_flops(cfg: dict, B: int, S: int) -> int:
    """Model FLOPs of a prefill of B prompts of S tokens to each one's
    last-position logits."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    return (2 * cfg["n_layers"] * layer_weights(cfg) * B * S + 2 * d * V * B
            + attention_flops(cfg, B, S))


def train_flops(cfg: dict, B: int, S: int) -> int:
    """Model FLOPs of one training step on B sequences of S tokens: forward
    and backward, the LM head on every token."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    return (6 * (cfg["n_layers"] * layer_weights(cfg) + d * V) * B * S
            + 3 * attention_flops(cfg, B, S))


def flash_launch_bound_s(cfg: dict, B: int, S: int) -> float:
    """The bound of one flash-attention forward launch of one layer over B
    causal bf16 sequences of S tokens."""
    nbytes, flops = attention_work(B, S, S, cfg["n_heads"], cfg["n_kv_heads"],
                                   cfg["head_dim"], True, cfg.get("swa_window"), 2)
    return bound_s(flops, nbytes)
