"""Mixture-of-Experts FFN with top-k routing and scatter dispatch, ported
from ``repro/models/moe.py``.

Tokens are scattered into per-expert capacity buffers (no (T, E, C)
one-hot dispatch tensor), the expert FFNs run as one batched product over
(E, C, D), and the outputs gather back weighted by the renormalised router
probabilities.  The semantics are the reference's to the token: the router
runs in fp32, each (token, slot) takes its place in its expert's queue in
token-major order, and a slot past the capacity is dropped.  Two layouts
differ from the reference's, for the card's sake, not the result's: the
queue places are a running count along each expert's row of an
(E, T*K) one-hot (a scan along the inner axis; the reference's scan down
the (T*K, E) columns took 3 ms a layer on an H100 at 2048 tokens), and the
kept slots are written into the buffers directly, the dropped ones into a
spare row past the capacity that is cut off (the reference adds zeroed
sources at the last place; an add with accumulation took 0.7 ms a layer).

The reference's sharding pins (``moe_shard_constraints``) raise: the port
has no sharding yet (ROADMAP A12).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import ArchConfig
from .layers import _normal


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    """The router (fp32, as in the reference) and the stacked experts'
    (E, d, f) / (E, f, d) weights."""
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.n_experts
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(f * 2 * cfg.n_layers)
    p = {
        "router": {"w": _normal(gen, (d, E), torch.float32, scale_in)},
        "wi": _normal(gen, (E, d, f), dtype, scale_in),
        "wo": _normal(gen, (E, f, d), dtype, scale_out),
    }
    if cfg.gated_mlp:
        p["wg"] = _normal(gen, (E, d, f), dtype, scale_in)
    return p


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def moe_apply(p, x, cfg: ArchConfig):
    """x: (B, S, D) -> (y: (B, S, D), {"moe_aux": load-balance loss,
    "moe_drop_frac": share of (token, slot) pairs dropped})."""
    if cfg.moe_shard_constraints:
        raise NotImplementedError(
            f"moe_apply: moe_shard_constraints={cfg.moe_shard_constraints!r} needs the "
            "port's sharding rules, ROADMAP A12 (distribution)")
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = capacity(T, cfg)
    xt = x.reshape(T, D)

    logits = xt.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    gate, idx = torch.topk(probs, K, dim=-1)                     # (T, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)  # renorm

    # position of each (token, slot) within its expert queue, token-major
    expert = idx.reshape(T * K)
    hot = (torch.arange(E, device=x.device)[:, None] == expert).to(torch.int32)  # (E, T*K)
    pos = torch.cumsum(hot, dim=1, dtype=torch.int32).gather(0, expert[None])[0] - 1
    keep = pos < C                                               # capacity drop

    # scatter tokens into (E, C, D) buffers: the dropped slots into row C, cut off
    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((expert, torch.where(keep, pos, C)), xt.repeat_interleave(K, dim=0))
    buf = buf[:, :C]
    pos_c = torch.where(keep, pos, C - 1)

    # batched expert FFN: (E, C, D) x (E, D, F)
    h_in = torch.bmm(buf, p["wi"].to(x.dtype))
    if "wg" in p:
        h = F.silu(torch.bmm(buf, p["wg"].to(x.dtype))) * h_in
    else:
        h = F.gelu(h_in, approximate="tanh")  # jax.nn.gelu's default
    out_buf = torch.bmm(h, p["wo"].to(x.dtype))

    # gather back + weighted combine over the K slots
    gathered = out_buf[expert, pos_c]                            # (T*K, D)
    gathered = gathered * (keep[:, None] * gate.reshape(T * K)[:, None]).to(x.dtype)
    y = gathered.reshape(T, K, D).sum(dim=1)

    # GShard/Switch load-balance auxiliary loss
    me = probs.mean(dim=0)                                       # (E,)
    ce = hot.sum(dim=1).float() / T                              # fraction routed
    aux_loss = E * torch.sum(me * ce) / K
    return y.reshape(B, S, D), {"moe_aux": aux_loss,
                                "moe_drop_frac": 1.0 - keep.float().mean()}
