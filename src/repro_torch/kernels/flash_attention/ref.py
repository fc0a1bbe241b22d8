"""Plain PyTorch versions of the flash-attention forward.

``attention_ref`` materialises the score matrix (the oracle, counterpart of
``repro/kernels/flash_attention/ref.py``).  ``chunked_attention`` streams
over KV chunks with an online softmax: the arithmetic of the Hopper kernel,
the CPU path of ``ops.flash_attention`` and the model's CPU attention
(counterpart of ``repro/models/layers.py::chunked_attention``).
All take q: (B, Sq, H, dh), k/v: (B, Skv, KV, dh); query head ``h`` reads
kv head ``h // (H // KV)``.
"""

from __future__ import annotations

import math

import torch


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
                      chunk: int = 1024, q_offset: int = 0, accum_bf16: bool = False):
    """Online-softmax attention over KV chunks of ``chunk`` rows; never
    holds more than an (Sq, chunk) score block.  fp32 statistics and
    accumulator; fully masked rows give 0.  ``accum_bf16`` (the
    reference's ``attn_accum_bf16``) takes P.V and the accumulator in
    bf16, as the reference's chunked path does."""
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
    return out.reshape(B, Sq, H, dh).to(q.dtype)
