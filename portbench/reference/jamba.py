"""Plain PyTorch reference of AI21's Jamba, the ``jamba`` model type of
Hugging Face's ``modeling_jamba.py`` (arXiv:2403.19887, 2408.12570), as the
configuration file ``portbench/configs/ai21-jamba2-mini.json`` states it.

Layer i is attention where ``i % attn_layer_period == attn_layer_offset``
and Mamba-1 elsewhere; its FFN is routed experts where ``i %
expert_layer_period == expert_layer_offset`` and a dense SwiGLU elsewhere.
Each layer is ``x += mixer(rmsnorm(x))``, then ``x += ffn(rmsnorm(x))``.

- Mamba-1: ``[u, z] = in_proj(h)``; ``u = silu(causal depthwise conv(u) +
  bias)``; ``[dt, B, C] = x_proj(u)``, each RMS-normed with its own scale;
  ``dt = softplus(dt_proj(dt) + dt_bias)``; ``A = -exp(A_log)``, one decay
  per (channel, state); the scan ``s_t = exp(dt_t A) s_{t-1} + dt_t B_t u_t``,
  ``y_t = C_t . s_t + D u_t``; ``out_proj(y * silu(z))``.
- Attention: causal grouped-query attention, no positional encoding.
- Experts: the router's softmax in fp32, the top-k taken and not
  renormalised; each expert a SwiGLU, holding its capacity of (token,
  choice) pairs in token-major order and dropping the rest, as the
  program does (``reference/model.py::capacity``).

It reads the stacked weights by the paths of the program's parameter tree
(``kinds/prefill_hybrid.py::leaves``) and upcasts each weight where it is
used, so a bf16 model far larger than its fp32 copy would be is read in
place.  It imports nothing of the program.  The scan is the exact
recurrence, one step at a time, vectorised over channels and states; the
decays and inputs of ``SCAN_BLOCK`` steps are formed in one operation each.
Attention forms its scores ``Q_BLOCK`` query rows at a time.

``precision`` is "fp32" (float32, TF32 off: ``model.exact_matmuls``) or
"fp8" (every matrix product's operands rounded to float8 e4m3, ``model.mm``):
the control that a program computing below bf16 must fail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .model import capacity, mm, rmsnorm

#: query rows a block of attention scores holds: 1 GiB of fp32 scores at
#: 65536 keys and 32 heads
Q_BLOCK = 128
#: time steps whose decays and inputs one operation forms
SCAN_BLOCK = 256
#: token rows a SwiGLU's hidden holds: 0.94 GB of fp32 at width 14336
ROW_BLOCK = 16384


def dims(cfg: dict) -> dict:
    """The sizes the model is built from, by short names."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(d=d, L=cfg["num_hidden_layers"], H=H, KV=cfg["num_key_value_heads"], dh=d // H,
                f=cfg["intermediate_size"], V=cfg["vocab_size"], E=cfg["num_experts"],
                K=cfg["num_experts_per_tok"], N=cfg["mamba_d_state"], R=cfg["mamba_dt_rank"],
                di=cfg["mamba_expand"] * d, conv=cfg["mamba_d_conv"],
                period=cfg["attn_layer_period"], eps=cfg["rms_norm_eps"])


def layer_kind(cfg: dict, i: int) -> tuple[str, str]:
    """(mixer "attn" or "mamba", ffn "moe" or "dense") of layer i."""
    mixer = "attn" if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"] else "mamba"
    moe = i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]
    return mixer, "moe" if moe else "dense"


def layer_params(w: dict, cfg: dict, i: int) -> dict:
    """Layer i's weights, {name under the layer: tensor}, out of the
    stacked ``{path: tensor}``: layer i is entry i % period of block
    i // period."""
    block, j = divmod(i, cfg["attn_layer_period"])
    pre = f"blocks/layers/{j}/"
    return {k[len(pre):]: t[block] for k, t in w.items() if k.startswith(pre)}


def attention(q, k, v, precision):
    """Causal softmax attention, query head h reading kv head h // (H / KV);
    q (B, S, H, dh), k / v (B, S, KV, dh).  Scores are formed ``Q_BLOCK``
    query rows at a time over the keys they can see."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    out = torch.empty_like(q)
    for s0 in range(0, S, Q_BLOCK):
        s1 = min(S, s0 + Q_BLOCK)
        keep = (torch.arange(s1, device=q.device)[None, :]
                <= torch.arange(s0, s1, device=q.device)[:, None])
        s = mm(q[:, :, s0:s1], k[:, :, :s1].transpose(-1, -2), precision) / math.sqrt(dh)
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        out[:, :, s0:s1] = mm(p, v[:, :, :s1], precision)
    return out.transpose(1, 2)


def scan(u, dt, A, Bm, Cm):
    """The exact recurrence, fp32: u, dt (B, S, di); A (di, N); Bm, Cm (B,
    S, N).  Returns y (B, S, di) without the D term."""
    B, S, di = u.shape
    s = torch.zeros((B, di, A.shape[1]), dtype=torch.float32, device=u.device)
    y = torch.empty_like(u)
    for t0 in range(0, S, SCAN_BLOCK):
        t1 = min(S, t0 + SCAN_BLOCK)
        d = dt[:, t0:t1, :, None]
        decay = torch.exp(d * A)                                   # (B, L, di, N)
        inp = d * u[:, t0:t1, :, None] * Bm[:, t0:t1, None, :]     # (B, L, di, N)
        states = torch.empty_like(decay)
        for j in range(t1 - t0):
            s = torch.addcmul(inp[:, j], decay[:, j], s, out=states[:, j])
        y[:, t0:t1] = torch.einsum("bldn,bln->bld", states, Cm[:, t0:t1])
    return y


def mamba(h, p, cfg: dict, precision):
    """The Mamba-1 mixer over h (B, S, d)."""
    n = dims(cfg)
    S, di, N, R = h.shape[1], n["di"], n["N"], n["R"]
    u, z = mm(h, p["mamba/in_proj/w"].float(), precision).split(di, dim=-1)
    w = p["mamba/conv_w"].float()                                   # (k, di)
    k = w.shape[0]
    up = F.pad(u, (0, 0, k - 1, 0))
    conv = p["mamba/conv_b"].float() + sum(up[:, i:i + S] * w[i] for i in range(k))
    u = F.silu(conv)
    dt, Bm, Cm = mm(u, p["mamba/x_proj/w"].float(), precision).split([R, N, N], dim=-1)
    dt = rmsnorm(dt, p["mamba/dt_norm/scale"].float(), n["eps"])
    Bm = rmsnorm(Bm, p["mamba/b_norm/scale"].float(), n["eps"])
    Cm = rmsnorm(Cm, p["mamba/c_norm/scale"].float(), n["eps"])
    dt = F.softplus(mm(dt, p["mamba/dt_proj/w"].float(), precision) + p["mamba/dt_bias"].float())
    y = scan(u, dt, -torch.exp(p["mamba/A_log"].float()), Bm, Cm) + p["mamba/D"].float() * u
    return mm(y * F.silu(z), p["mamba/out_proj/w"].float(), precision)


def self_attention(h, p, cfg: dict, precision):
    n = dims(cfg)
    B, S, _ = h.shape
    H, KV, dh = n["H"], n["KV"], n["dh"]
    q = mm(h, p["attn/wq/w"].float(), precision).reshape(B, S, H, dh)
    k = mm(h, p["attn/wk/w"].float(), precision).reshape(B, S, KV, dh)
    v = mm(h, p["attn/wv/w"].float(), precision).reshape(B, S, KV, dh)
    o = attention(q, k, v, precision).reshape(B, S, H * dh)
    return mm(o, p["attn/wo/w"].float(), precision)


def swiglu(h, wi, wg, wo, precision):
    """SwiGLU over the rows of h, ``ROW_BLOCK`` at a time."""
    wi, wg, wo = wi.float(), wg.float(), wo.float()
    rows = h.reshape(-1, h.shape[-1])
    out = torch.cat([mm(F.silu(mm(r, wg, precision)) * mm(r, wi, precision), wo, precision)
                     for r in rows.split(ROW_BLOCK)])
    return out.reshape(*h.shape[:-1], wo.shape[-1])


def experts(h, p, cfg: dict, precision):
    """Routed SwiGLU experts over h (B, S, d): each token's top-k experts by
    the router's fp32 softmax, weighted by those probabilities as they are
    (no renormalisation); an expert takes its (token, choice) pairs in
    token-major order up to its capacity and drops the rest."""
    B, S, d = h.shape
    T, E, K = B * S, cfg["num_experts"], cfg["num_experts_per_tok"]
    x = h.reshape(T, d)
    probs = torch.softmax(mm(x, p["moe/router/w"].float(), precision), dim=-1)
    gate, idx = torch.topk(probs, K, dim=-1)
    gate, flat = gate.reshape(T * K), idx.reshape(T * K)
    C = capacity(T, {"top_k": K, "n_experts": E, "capacity_factor": cfg["capacity_factor"]})
    y = torch.zeros_like(x)
    for e in range(E):
        kept = torch.nonzero(flat == e)[:C, 0]
        if kept.numel():
            tok = kept // K
            out = swiglu(x[tok], p["moe/wi"][e], p["moe/wg"][e], p["moe/wo"][e], precision)
            y.index_add_(0, tok, out * gate[kept][:, None])
    return y.reshape(B, S, d)


def layer(x, p, cfg: dict, i: int, precision):
    mixer, ffn = layer_kind(cfg, i)
    eps = cfg["rms_norm_eps"]
    h = rmsnorm(x, p["norm1/scale"].float(), eps)
    x = x + (self_attention if mixer == "attn" else mamba)(h, p, cfg, precision)
    h = rmsnorm(x, p["norm2/scale"].float(), eps)
    if ffn == "moe":
        return x + experts(h, p, cfg, precision)
    return x + swiglu(h, p["mlp/wi/w"], p["mlp/wg/w"], p["mlp/wo/w"], precision)


@torch.no_grad()
def last_logits(w: dict, tokens, cfg: dict, precision="fp32"):
    """(B, V) logits of each prompt's last position, fp32."""
    x = w["embed/table"][tokens].float()
    for i in range(cfg["num_hidden_layers"]):
        x = layer(x, layer_params(w, cfg, i), cfg, i, precision)
    x = rmsnorm(x[:, -1], w["final_norm/scale"].float(), cfg["rms_norm_eps"])
    return mm(x, w["lm_head/w"].float(), precision)
