"""The work of the hybrid (``reference/jamba.py``) counted from its shapes:
the model FLOPs of a prefill, and the bytes and operations of one Mamba-1
selective scan.  Nothing here imports the program.

Model FLOPs (``prefill_flops``) count the matrix products a token passes
through, 2 a weight: per Mamba layer ``in_proj`` (d x 2 di), ``x_proj``
(di x (R + 2N)), ``dt_proj`` (R x di) and ``out_proj`` (di x d); per
attention layer its projections ``d (H + 2 KV) dh + H dh d`` and ``4 dh``
a causal (query, key) pair and query head; per FFN the dense SwiGLU ``3 d
f`` or the router ``d E`` and ``top_k`` experts of ``3 d f``; and the LM
head ``d V`` on each request's last position.  The scan (about 0.1% at 16k
tokens), the conv and the norms are left out.
"""

from __future__ import annotations

from .counts import PEAK_HBM_BYTES_S, causal_pairs
from .reference.jamba import dims, layer_kind

#: NVIDIA H100 SXM data sheet: fp32 FLOP/s outside the tensor cores, the
#: rate the scan's operations run at
PEAK_FP32_FLOPS = 67e12


def layer_weights(cfg: dict, i: int) -> int:
    """Weights of layer i's matrix products that each token passes through."""
    n = dims(cfg)
    d, di, f = n["d"], n["di"], n["f"]
    mixer, ffn = layer_kind(cfg, i)
    if mixer == "attn":
        w = d * (n["H"] + 2 * n["KV"]) * n["dh"] + n["H"] * n["dh"] * d
    else:
        w = d * 2 * di + di * (n["R"] + 2 * n["N"]) + n["R"] * di + di * d
    return w + (d * n["E"] + n["K"] * 3 * d * f if ffn == "moe" else 3 * d * f)


def prefill_flops(cfg: dict, B: int, S: int) -> int:
    """Model FLOPs of a prefill of B prompts of S tokens to each one's
    last-position logits."""
    n = dims(cfg)
    layers = range(n["L"])
    n_attn = sum(layer_kind(cfg, i)[0] == "attn" for i in layers)
    return (2 * sum(layer_weights(cfg, i) for i in layers) * B * S + 2 * n["d"] * n["V"] * B
            + n_attn * 4 * n["dh"] * n["H"] * B * causal_pairs(S, None))


def n_mamba(cfg: dict) -> int:
    return sum(layer_kind(cfg, i)[0] == "mamba" for i in range(cfg["num_hidden_layers"]))


def scan_work(cfg: dict, B: int, S: int) -> tuple[int, int]:
    """(bytes, operations) one selective scan of one layer over B prompts of
    S tokens must move and do: u in the compute type and dt in fp32 read
    once, B and C read once, y written once, A, D and the final state;
    5 N operations per (token, channel)."""
    n = dims(cfg)
    di, N = n["di"], n["N"]
    elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    nbytes = (B * S * di * (elem + 4 + elem) + 2 * B * S * N * elem
              + 4 * di * N + 4 * di + 4 * B * di * N)
    return nbytes, 5 * N * di * B * S


def scan_bound_s(cfg: dict, B: int, S: int) -> float:
    """The least time one scan could take: the larger of its bytes over the
    HBM peak and its operations over the fp32 peak."""
    nbytes, ops = scan_work(cfg, B, S)
    return max(nbytes / PEAK_HBM_BYTES_S, ops / PEAK_FP32_FLOPS)
