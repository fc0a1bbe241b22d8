"""Plain PyTorch reference of the two architectures the benchmark runs: a
decoder-only transformer with grouped-query attention (causal, optionally
within a sliding window), rotary embeddings, RMSNorm, and a SwiGLU FFN or
top-k routed SwiGLU experts with capacity-limited dispatch; its
cross-entropy loss, and AdamW.

It follows the configuration files under ``portbench/configs/`` and reads
the parameters by the paths of ``portbench/weights.py``.  It imports
nothing of the program: every quantity the program derives (positions,
rotary angles, the experts' queues and capacity, the load-balance loss,
the learning rate of each step) is worked out again here.

``precision`` is "fp32" (the reference: float32, TF32 off) or "fp8": every
matrix product's operands rounded to float8 e4m3 with one scale a tensor
(the rounding passes gradients straight through), the control that a
program computing below the configuration's bf16 must fail.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0
#: query rows a block of the attention scores holds
Q_BLOCK = 512
#: positions a block of the LM head's logits holds
LOGIT_BLOCK = 1024


def exact_matmuls(torch_mod=torch) -> None:
    """fp32 products in fp32: TF32 off."""
    torch_mod.backends.cuda.matmul.allow_tf32 = False
    torch_mod.backends.cudnn.allow_tf32 = False


def rounded(x, precision: str):
    if precision == "fp32":
        return x
    if precision == "fp8":
        s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
        return x + (q - x).detach()
    raise ValueError(f"unknown precision {precision!r}")


def mm(a, b, precision: str):
    return rounded(a, precision) @ rounded(b, precision)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """Split-half rotary embedding of x (B, S, H, dh) at positions 0..S-1."""
    S, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window, precision):
    """Causal softmax attention, query head h reading kv head h // (H / KV),
    keys within ``window`` of the query; q (B, S, H, dh), k / v (B, S, KV,
    dh).  Scores are formed Q_BLOCK query rows at a time over the keys the
    band can reach."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    outs = []
    for s0 in range(0, S, Q_BLOCK):
        s1 = min(S, s0 + Q_BLOCK)
        lo = 0 if window is None else max(0, s0 - window + 1)
        qp = torch.arange(s0, s1, device=q.device)[:, None]
        kp = torch.arange(lo, s1, device=q.device)[None, :]
        keep = kp <= qp
        if window is not None:
            keep = keep & (kp > qp - window)
        s = mm(q[:, :, s0:s1], k[:, :, lo:s1].transpose(-1, -2), precision) / math.sqrt(dh)
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(mm(p, v[:, :, lo:s1], precision))
    return torch.cat(outs, dim=2).transpose(1, 2)


def capacity(n_tokens: int, moe: dict) -> int:
    """Slots an expert holds: the tokens' top-k choices spread evenly, times
    the capacity factor, rounded up to a multiple of 8 (8 at least)."""
    c = math.ceil(n_tokens * moe["top_k"] * moe["capacity_factor"] / moe["n_experts"])
    return max(8, -(-c // 8) * 8)


def experts(h, p, moe: dict, precision):
    """Routed SwiGLU experts over h (B, S, d): every token's top-k experts
    by the router's softmax, their gates renormalised to sum to 1; each
    expert takes its (token, choice) pairs in token-major order up to its
    capacity and drops the rest.  Returns (y, load-balance loss)."""
    B, S, d = h.shape
    T, E, K = B * S, moe["n_experts"], moe["top_k"]
    x = h.reshape(T, d)
    probs = torch.softmax(mm(x, p["router"], precision), dim=-1)
    gate, idx = torch.topk(probs, K, dim=-1)
    gate = (gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)).reshape(T * K)
    flat = idx.reshape(T * K)
    C = capacity(T, moe)
    y = torch.zeros_like(x)
    routed = torch.zeros(E, dtype=torch.float32, device=x.device)
    for e in range(E):
        pairs = torch.nonzero(flat == e)[:, 0]
        routed[e] = pairs.numel()
        kept = pairs[:C]
        if kept.numel() == 0:
            continue
        tok = kept // K
        he = x[tok]
        out = mm(F.silu(mm(he, p["wg"][e], precision)) * mm(he, p["wi"][e], precision),
                 p["wo"][e], precision)
        y = y.index_add(0, tok, out * gate[kept][:, None])
    aux = E * torch.sum(probs.mean(0) * routed / T) / K
    return y.reshape(B, S, d), aux


def layer(x, p, cfg: dict, precision):
    """One pre-norm block: attention, then the FFN, each added back."""
    B, S, _ = x.shape
    H, KV, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta, a, f = cfg["norm_eps"], cfg["rope_theta"], p["attn"], p["ffn"]
    h = rmsnorm(x, p["norm1"], eps)
    q = rope(mm(h, a["wq"], precision).reshape(B, S, H, dh), theta)
    k = rope(mm(h, a["wk"], precision).reshape(B, S, KV, dh), theta)
    v = mm(h, a["wv"], precision).reshape(B, S, KV, dh)
    o = attention(q, k, v, cfg.get("swa_window"), precision).reshape(B, S, H * dh)
    x = x + mm(o, a["wo"], precision)
    h = rmsnorm(x, p["norm2"], eps)
    if cfg.get("moe") is None:
        y = mm(F.silu(mm(h, f["wg"], precision)) * mm(h, f["wi"], precision), f["wo"], precision)
        return x + y, torch.zeros((), device=x.device)
    y, aux = experts(h, f, cfg["moe"], precision)
    return x + y, aux


def layer_params(w: dict, cfg: dict, i: int) -> dict:
    """Layer ``i``'s tensors out of the stacked ``{path: tensor}`` weights."""
    lay = "blocks/layers/0/"
    ffn = (lay + "mlp/{}/w") if cfg.get("moe") is None else (lay + "moe/{}")
    p = {"norm1": w[lay + "norm1/scale"][i], "norm2": w[lay + "norm2/scale"][i],
         "attn": {n: w[f"{lay}attn/{n}/w"][i] for n in ("wq", "wk", "wv", "wo")},
         "ffn": {n: w[ffn.format(n)][i] for n in ("wi", "wg", "wo")}}
    if cfg.get("moe") is not None:
        p["ffn"]["router"] = w[lay + "moe/router/w"][i]
    return p


def hidden(w: dict, tokens, cfg: dict, precision="fp32", remat=False):
    """Final normed hidden states (B, S, d) and the summed load-balance
    loss.  ``remat`` recomputes each layer in the backward (memory only)."""
    x = w["embed/table"][tokens]
    aux = torch.zeros((), device=x.device)
    for i in range(cfg["n_layers"]):
        p = layer_params(w, cfg, i)
        if remat:
            x, a = checkpoint(layer, x, p, cfg, precision, use_reentrant=False)
        else:
            x, a = layer(x, p, cfg, precision)
        aux = aux + a
    return rmsnorm(x, w["final_norm/scale"], cfg["norm_eps"]), aux


def head(w: dict, cfg: dict):
    """The LM head as (V, d): the embedding table when tied."""
    return w["embed/table"] if cfg["tie_embeddings"] else w["lm_head/w"].T


def loss(w: dict, tokens, labels, cfg: dict, precision="fp32"):
    """Mean next-token cross-entropy over the labels >= 0, plus the MoE
    load-balance loss times its weight.  Returns (loss, xent)."""
    x, aux = hidden(w, tokens, cfg, precision, remat=True)
    table = head(w, cfg)
    tot = torch.zeros((), device=x.device)
    for s0 in range(0, x.shape[1], LOGIT_BLOCK):
        lab = labels[:, s0:s0 + LOGIT_BLOCK]
        logits = mm(x[:, s0:s0 + LOGIT_BLOCK], table.T, precision)
        nll = torch.logsumexp(logits, -1) - logits.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
        tot = tot + torch.where(lab >= 0, nll, 0.0).sum()
    xent = tot / (labels >= 0).sum().clamp(min=1)
    aux_w = cfg["moe"]["aux_weight"] if cfg.get("moe") else 0.0
    return xent + aux_w * aux, xent


@torch.no_grad()
def last_logits(w: dict, tokens, cfg: dict, precision="fp32"):
    """(B, V) logits of each prompt's last position."""
    x, _ = hidden(w, tokens, cfg, precision)
    return mm(x[:, -1], head(w, cfg).T, precision)


def lr_at(step: int, o: dict) -> float:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine to
    ``min_ratio`` of it at ``total_steps``."""
    if step < o["warmup_steps"]:
        return o["peak_lr"] * step / max(o["warmup_steps"], 1)
    prog = min(max((step - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    r = o.get("min_ratio", 0.1)
    return o["peak_lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(w: dict, grads: dict, m: dict, v: dict, step: int, o: dict, dtypes: dict) -> dict:
    """One AdamW step in place on fp32 ``w``: gradients clipped to a global
    norm of ``clip_norm``, bias-corrected moments, decoupled weight decay on
    every leaf; each parameter then stored in its served type (``dtypes``),
    as the configuration keeps it.  Returns the clipped gradients."""
    gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(o["clip_norm"] / torch.clamp(gn, min=1e-9), max=1.0)
    lr = lr_at(step, o)
    c1, c2 = 1 - o["b1"] ** step, 1 - o["b2"] ** step
    clipped = {}
    for k, g in grads.items():
        g = g * scale
        clipped[k] = g
        m[k].mul_(o["b1"]).add_((1 - o["b1"]) * g)
        v[k].mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
        upd = (m[k] / c1) / (torch.sqrt(v[k] / c2) + o["eps"]) + o["weight_decay"] * w[k]
        w[k].copy_((w[k] - lr * upd).to(dtypes[k]).float())
    return clipped


def train(w: dict, batches, cfg: dict, o: dict, dtypes: dict, precision="fp32") -> dict:
    """Trains fp32 copies of the weights ``w`` ({path: tensor}, changed in
    place) over ``batches`` [(tokens, labels)] and returns each step's loss,
    each leaf's first clipped gradient and its norm, and each leaf's change
    over all the steps."""
    start = {k: t.clone() for k, t in w.items()}
    m = {k: torch.zeros_like(t) for k, t in w.items()}
    v = {k: torch.zeros_like(t) for k, t in w.items()}
    losses, first = [], None
    for i, (tokens, labels) in enumerate(batches):
        leaves = {k: t.detach().requires_grad_() for k, t in w.items()}
        total, _ = loss(leaves, tokens, labels, cfg, precision)
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
        losses.append(float(total.detach()))
        clipped = adamw(w, grads, m, v, i + 1, o, dtypes)
        if first is None:
            first = clipped
        del leaves, grads, clipped
    change = {k: float((w[k] - start[k]).norm()) for k in w}
    return {"losses": losses, "grads": first, "grad_norms": {k: float(g.norm()) for k, g in first.items()},
            "change_norms": change}
