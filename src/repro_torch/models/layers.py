"""Layers of the dense path, ported from ``repro/models/layers.py``.

Plain functions on tensors.  Parameters are nested dicts whose path names
and layouts are the reference's (linear weights ``(d_in, d_out)``), so a
JAX parameter tree carries across as a byte copy.  Init helpers draw from
an explicit ``torch.Generator`` and allocate on its device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention_auto
from ..kernels.flash_attention.ref import chunked_attention  # noqa: F401  (the reference's layers.chunked_attention)
from .common import ArchConfig


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def _normal(gen: torch.Generator, shape, dtype, scale):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype)


def linear_init(gen, d_in, d_out, dtype, bias=False, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), dtype, scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-5):
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (split-half rotation in fp32)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: (..., S, H, Dh); positions: (..., S) integer."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA + optional bias + optional sliding window)
# ---------------------------------------------------------------------------
def attention_init(gen, cfg: ArchConfig, dtype):
    dh = cfg.head_dim
    return {
        "wq": linear_init(gen, cfg.d_model, cfg.n_heads * dh, dtype,
                          bias=cfg.qkv_bias),
        "wk": linear_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype,
                          bias=cfg.qkv_bias),
        "wv": linear_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype,
                          bias=cfg.qkv_bias),
        "wo": linear_init(gen, cfg.n_heads * dh, cfg.d_model, dtype,
                          scale=1.0 / math.sqrt(cfg.n_heads * dh * 2 * cfg.n_layers)),
    }


def _qkv(p, x, x_kv, cfg):
    B, S = x.shape[:2]
    dh = cfg.head_dim
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, dh)
    kv_src = x if x_kv is None else x_kv
    Skv = kv_src.shape[1]
    k = linear(p["wk"], kv_src).reshape(B, Skv, cfg.n_kv_heads, dh)
    v = linear(p["wv"], kv_src).reshape(B, Skv, cfg.n_kv_heads, dh)
    return q, k, v


def full_attention(q, k, v, *, causal, window=None, q_offset=0,
                   kv_positions=None):
    """Softmax attention over the full score matrix.
    q: (B,Sq,H,dh) k/v: (B,Skv,KV,dh)."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores * (1.0 / math.sqrt(dh))
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = (torch.arange(k.shape[1], device=q.device) if kv_positions is None
             else kv_positions)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, dh)


def attention_apply(p, x, cfg: ArchConfig, *, causal=True, positions=None,
                    use_rope=True):
    """Full-sequence (prefill) self-attention; returns (out, (k, v)).
    ``cfg.attn_impl == "full"`` takes the plain full-matrix path, as in
    the reference; any other value takes ``flash_attention_auto``.
    ``cfg.attn_shard_constraints`` raises: the port has no sharding yet."""
    if cfg.attn_shard_constraints:
        raise NotImplementedError(
            "attention_apply: attn_shard_constraints needs the port's sharding "
            "rules, ROADMAP A12 (distribution)")
    B, S = x.shape[:2]
    q, k, v = _qkv(p, x, None, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.attn_impl == "full":
        out = full_attention(q, k, v, causal=causal, window=cfg.swa_window)
    else:
        out = flash_attention_auto(q, k, v, causal=causal,
                                   window=cfg.swa_window, cfg=cfg)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return linear(p["wo"], out), (k, v)


def attention_decode(p, x, cache_k, cache_v, pos: int, cfg: ArchConfig, *,
                     use_rope=True):
    """One-token decode against a fixed-size KV cache.

    x: (B, 1, d); cache_k/v: (B, S_max, KV, dh); pos: int.  The new k/v
    are written into the caches in place at ``pos`` (the reference returns
    updated copies from ``dynamic_update_slice``).  Returns
    (out, cache_k, cache_v).
    """
    B = x.shape[0]
    dh = cfg.head_dim
    q = linear(p["wq"], x).reshape(B, 1, cfg.n_heads, dh)
    k_new = linear(p["wk"], x).reshape(B, 1, cfg.n_kv_heads, dh)
    v_new = linear(p["wv"], x).reshape(B, 1, cfg.n_kv_heads, dh)
    if use_rope:
        pos_arr = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos_arr, cfg.rope_theta)
        k_new = apply_rope(k_new, pos_arr, cfg.rope_theta)
    cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)
    kv_pos = torch.arange(cache_k.shape[1], device=x.device)
    mask_pos = kv_pos <= pos
    if cfg.swa_window is not None:
        mask_pos &= kv_pos > pos - cfg.swa_window
    KV = cache_k.shape[2]
    qg = q.reshape(B, KV, cfg.n_heads // KV, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k).float()
    s = s * (1.0 / math.sqrt(dh))
    s = torch.where(mask_pos[None, None, None, :], s, -1e30)
    p_attn = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p_attn, cache_v)
    out = out.reshape(B, 1, cfg.n_heads * dh)
    return linear(p["wo"], out), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------
def mlp_init(gen, cfg: ArchConfig, dtype):
    out_scale = 1.0 / math.sqrt(cfg.d_ff * 2 * cfg.n_layers)
    if cfg.gated_mlp:
        return {
            "wi": linear_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "wg": linear_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "wo": linear_init(gen, cfg.d_ff, cfg.d_model, dtype,
                              scale=out_scale),
        }
    return {
        "wi": linear_init(gen, cfg.d_model, cfg.d_ff, dtype, bias=True),
        "wo": linear_init(gen, cfg.d_ff, cfg.d_model, dtype, bias=True,
                          scale=out_scale),
    }


def mlp_apply(p, x, cfg: ArchConfig):
    if cfg.gated_mlp:
        h = F.silu(linear(p["wg"], x)) * linear(p["wi"], x)
    else:
        h = F.gelu(linear(p["wi"], x), approximate="tanh")  # jax.nn.gelu's default
    return linear(p["wo"], h)


# ---------------------------------------------------------------------------
# sequence-chunked cross-entropy (never materializes full logits)
# ---------------------------------------------------------------------------
def chunked_xent(embed_table, x, labels, *, chunk: int):
    """x: (B, S, d) final hidden; labels: (B, S) integer (-1 = ignore);
    embed_table: (V, d).  Mean token xent over the valid labels, with the
    logits of ``chunk`` positions at a time in fp32, so the (B, S, V)
    logits tensor never exists.  The reference's ``z_weight`` and
    ``unroll`` options are left out: its loss never sets them."""
    B, S, D = x.shape
    V = embed_table.shape[0]
    if S % chunk:
        raise ValueError(f"chunked_xent: S={S} is not a multiple of chunk={chunk}")
    table = embed_table.to(x.dtype)
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = 0
    for start in range(0, S, chunk):
        xi, li = x[:, start:start + chunk], labels[:, start:start + chunk]
        logits = (xi @ table.T).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li.clamp(0, V - 1).long()[..., None])[..., 0]
        valid = li >= 0
        tot = tot + torch.where(valid, lse - gold, 0.0).sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1)
