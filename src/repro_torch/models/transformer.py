"""Dense decoder stack, ported from ``repro/models/transformer.py``.

Blocks are stacked on a leading axis as in the reference (one layer per
block for the dense family), and the reference's ``lax.scan`` over blocks
is a Python loop over that axis.  ``remat="block"`` (the reference's
``jax.checkpoint`` in ``_scan_blocks``) is ``torch.utils.checkpoint`` around
each block while autograd records; the backward then runs each block's
forward once more.  The KV cache keeps the reference layout
``(n_blocks, n_attn, B, S_max, KV, dh)``.  The families with mamba, rwkv,
MoE, encoder or vision layers come in later slices of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import ArchConfig
from .layers import (_normal, attention_apply, attention_decode,
                     attention_init, chunked_xent, linear_init, mlp_apply,
                     mlp_init, rmsnorm, rmsnorm_init)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _index(tree, i):
    """Block ``i`` of the stacked blocks (views, no copy)."""
    return _tree_map(lambda x: x[i], tree)


# ===========================================================================
# block = attention + dense FFN
# ===========================================================================
def block_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    layer = {"norm1": rmsnorm_init(cfg.d_model, dtype, gen.device),
             "norm2": rmsnorm_init(cfg.d_model, dtype, gen.device),
             "attn": attention_init(gen, cfg, dtype),
             "mlp": mlp_init(gen, cfg, dtype)}
    return {"layers": [layer]}


def block_apply(bp, x, cfg: ArchConfig, *, causal=True, collect_cache=False):
    """Full-sequence pass through one block.  Returns (x, cache)."""
    cache = {"attn_k": [], "attn_v": []}
    for layer in bp["layers"]:
        h = rmsnorm(layer["norm1"], x, cfg.norm_eps)
        out, (k, v) = attention_apply(layer["attn"], h, cfg, causal=causal)
        if collect_cache:
            cache["attn_k"].append(k)
            cache["attn_v"].append(v)
        x = x + out
        h = rmsnorm(layer["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(layer["mlp"], h, cfg)
    return x, ({k: torch.stack(v) for k, v in cache.items()}
               if collect_cache else {})


def block_decode(bp, x, pos: int, cfg: ArchConfig, cache):
    """One-token pass; ``cache`` holds this block's (n_attn, B, S_max, KV,
    dh) tensors and is updated in place."""
    for j, layer in enumerate(bp["layers"]):
        h = rmsnorm(layer["norm1"], x, cfg.norm_eps)
        out, _, _ = attention_decode(layer["attn"], h, cache["attn_k"][j],
                                     cache["attn_v"][j], pos, cfg)
        x = x + out
        h = rmsnorm(layer["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(layer["mlp"], h, cfg)
    return x, cache


# ===========================================================================
# full model
# ===========================================================================
def init_params(gen: torch.Generator, cfg: ArchConfig):
    """Random parameters on ``gen.device``, in ``cfg.param_dtype``."""
    dtype = _dtype(cfg.param_dtype)
    scale = 1.0 / math.sqrt(cfg.d_model)
    params = {
        "embed": {"table": _normal(gen, (cfg.vocab_size, cfg.d_model),
                                   dtype, scale)},
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    blocks = [block_init(gen, cfg, dtype) for _ in range(cfg.n_blocks)]
    params["blocks"] = _tree_map(lambda *xs: torch.stack(xs), *blocks)
    del blocks
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                        dtype, scale=scale)
    return params


def _embed(params, tokens, cfg: ArchConfig):
    return params["embed"]["table"][tokens].to(_dtype(cfg.compute_dtype))


def final_hidden(params, batch, cfg: ArchConfig, collect_cache=False):
    """Returns (normed hidden (B, S, d), cache stacked over blocks)."""
    x = _embed(params, batch["tokens"], cfg)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    caches = []
    for i in range(cfg.n_blocks):
        bp = _index(params["blocks"], i)
        if remat:
            x, cache = checkpoint(block_apply, bp, x, cfg, causal=True,
                                  collect_cache=collect_cache, use_reentrant=False)
        else:
            x, cache = block_apply(bp, x, cfg, causal=True,
                                   collect_cache=collect_cache)
        caches.append(cache)
    caches = ({k: torch.stack([c[k] for c in caches]) for k in caches[0]}
              if collect_cache else {})
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), caches


def loss_fn(params, batch, cfg: ArchConfig):
    """Mean next-token xent of ``batch["tokens"]`` against
    ``batch["labels"]`` (-1 ignored).  Returns (loss, metrics) as the
    reference does; the dense family has no MoE auxiliary loss, so
    ``loss == xent`` and ``moe_aux`` is 0."""
    x, _ = final_hidden(params, batch, cfg)
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["lm_head"]["w"].T)
    xent = chunked_xent(table, x, batch["labels"],
                        chunk=min(cfg.logit_chunk, x.shape[1]))
    return xent, {"xent": xent, "moe_aux": xent.new_zeros(())}


def logits_last(params, x_last, cfg: ArchConfig):
    """x_last: (B, 1, d) -> (B, 1, V) fp32."""
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["lm_head"]["w"].T)
    return (x_last @ table.to(x_last.dtype).T).float()


def prefill(params, batch, cfg: ArchConfig, pad_to: int | None = None):
    """Builds a serving cache; returns (last-token logits, cache, pos).

    ``pad_to`` sizes the attention KV cache for subsequent decode."""
    x, caches = final_hidden(params, batch, cfg, collect_cache=True)
    S = batch["tokens"].shape[1]
    if pad_to is not None and pad_to > S:
        for key in ("attn_k", "attn_v"):
            # (nb, n_attn, B, S, KV, dh): zero-pad the sequence axis
            caches[key] = F.pad(caches[key], (0, 0, 0, 0, 0, pad_to - S))
    return logits_last(params, x[:, -1:, :], cfg), caches, S


def decode_step(params, cache, token, pos: int, cfg: ArchConfig):
    """token: (B, 1) integer; pos: int.  Returns (logits, cache); the
    cache is updated in place at ``pos``."""
    x = _embed(params, token, cfg)
    for i in range(cfg.n_blocks):
        x, _ = block_decode(_index(params["blocks"], i), x, pos, cfg,
                            _index(cache, i))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_last(params, x, cfg), cache


def make_decode_cache(cfg: ArchConfig, batch: int, max_seq: int, device,
                      dtype=None):
    """Zero KV cache for serving."""
    dtype = dtype or _dtype(cfg.compute_dtype)
    shape = (cfg.n_blocks, 1, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"attn_k": torch.zeros(shape, dtype=dtype, device=device),
            "attn_v": torch.zeros(shape, dtype=dtype, device=device)}
