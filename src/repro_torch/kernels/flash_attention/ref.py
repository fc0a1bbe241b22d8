"""Plain PyTorch versions of the flash-attention forward and of the Hopper
backward kernel's algebra.

``attention_ref`` materialises the score matrix (the oracle, counterpart of
``repro/kernels/flash_attention/ref.py``).  ``chunked_attention`` streams
over KV chunks with an online softmax: the arithmetic of the Hopper kernel,
the CPU path of ``ops.flash_attention`` and the model's CPU attention
(counterpart of ``repro/models/layers.py::chunked_attention``); with
``return_lse`` it also returns each row's log-sum-exp, the statistics the
kernel's forward hands its backward.  ``flash_attention_bwd_ref`` is that
backward's algebra: P from the saved log-sum-exp, D = rowsum(dO o O),
dS = P (dP - D), dK and dV summed over each kv head's query group.
All take q: (B, Sq, H, dh), k/v: (B, Skv, KV, dh); query head ``h`` reads
kv head ``h // (H // KV)``.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from ...sharding.rules import local_heads, logical_constraint


def _mask(q_pos, k_pos, *, causal, window):
    mask = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None):
    """fp32 softmax over the full (Sq, Skv) score matrix."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(dh)
    dev = q.device
    mask = _mask(torch.arange(Sq, device=dev), torch.arange(Skv, device=dev),
                 causal=causal, window=window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)  # fully-masked rows
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, window: int | None = None,
                      chunk: int = 1024, q_offset: int = 0, accum_bf16: bool = False,
                      shard_constrain: bool = False, return_lse: bool = False):
    """Online-softmax attention over KV chunks of ``chunk`` rows; never
    holds more than an (Sq, chunk) score block.  fp32 statistics and
    accumulator; fully masked rows give 0.  ``accum_bf16`` (the
    reference's ``attn_accum_bf16``) takes P.V and the accumulator in
    bf16, as the reference's chunked path does.  ``shard_constrain`` pins
    k and v to (batch, kv_heads) under the active sharding rules, as the
    reference pins its KV chunks.  ``DTensor``s run it on each rank's local
    batch rows and heads (``sharding.rules.local_heads``).  ``return_lse``
    (plain tensors only) returns (out, lse): lse (B, H, Sq) fp32, the natural
    log-sum-exp of each row's scaled scores, -inf for a row that sees no
    key."""
    if shard_constrain:
        k = logical_constraint(k, "batch", None, "kv_heads", None)
        v = logical_constraint(v, "batch", None, "kv_heads", None)
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        return local_heads(q, k, v, lambda q, k, v: chunked_attention(
            q, k, v, causal=causal, window=window, chunk=chunk, q_offset=q_offset,
            accum_bf16=accum_bf16))
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, dh).float() * (1.0 / math.sqrt(dh))
    q_pos = torch.arange(Sq, device=dev) + q_offset
    m = torch.full((B, KV, G, Sq), float("-inf"), device=dev)
    l = torch.zeros((B, KV, G, Sq), device=dev)
    acc = torch.zeros((B, KV, G, Sq, dh), device=dev,
                      dtype=torch.bfloat16 if accum_bf16 else torch.float32)
    for start in range(0, Skv, chunk):
        k_i = k[:, start:start + chunk].float()
        v_i = v[:, start:start + chunk].float()
        k_pos = torch.arange(start, start + k_i.shape[1], device=dev)
        mask = _mask(q_pos, k_pos, causal=causal, window=window)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_i)
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)  # masked rows
        p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0.0)
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        if accum_bf16:
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.bfloat16(), v_i.bfloat16())
            acc = acc * corr[..., None].bfloat16() + pv
        else:
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, v_i)
        m = m_new
    out = acc.float() / torch.clamp(l, min=1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4)  # (B, Sq, KV, G, dh)
    out = out.reshape(B, Sq, H, dh).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(torch.isinf(m), float("-inf"), m + torch.log(l))
    return out, lse.reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool, window: int | None = None,
                            round_operands: bool = False):
    """(dq, dk, dv) of attention from its output ``o``, each row's natural
    log-sum-exp ``lse`` (B, H, Sq) of the scaled scores and the output's
    gradient ``do``, in fp32, cast to the inputs' dtype: P = exp(s - lse)
    (0 where masked), dP = dO V^T, D = rowsum(dO o O), dS = P (dP - D),
    dV = P^T dO, dK = scale dS^T Q and dQ = scale dS K, dK and dV summed over
    the G query heads of each kv head.  A row that sees no key gives zero
    gradients.  ``round_operands`` rounds P and dS to bf16 before the
    products that take them, as the kernel does.  Materialises the
    (Sq, Skv) blocks: a plain version for tests, the algebra of the Hopper
    backward kernel."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(dh)
    qg, dog, og = (t.reshape(B, Sq, KV, G, dh).float() for t in (q, do, o))
    kf, vf = k.float(), v.float()
    mask = _mask(torch.arange(Sq, device=q.device), torch.arange(Skv, device=q.device),
                 causal=causal, window=window)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    p = torch.exp(s - lse.float().reshape(B, KV, G, Sq)[..., None]).masked_fill(~mask, 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    d = (dog * og).sum(-1).permute(0, 2, 3, 1)  # (B, KV, G, Sq)
    ds = p * (dp - d[..., None])
    if round_operands:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    return dq.reshape(B, Sq, H, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
