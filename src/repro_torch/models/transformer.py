"""Model stack, ported from ``repro/models/transformer.py``.

A model is a stack of blocks, each a list of (mixer, ffn) layers as the
reference's ``_layer_kinds`` gives them: the mixer attention, the mamba2
mixer (jamba) or the rwkv6 time mix; the ffn a dense MLP, MoE or the rwkv
channel mix.  An encoder-decoder (whisper) adds an encoder stack of the
same blocks, run non-causally over ``batch["audio_embeds"]``, and a
cross-attention branch in every decoder layer; a VLM (llava) puts the
projected ``batch["image_embeds"]`` in place of the first token
embeddings.  Blocks are stacked on a leading axis as in the reference,
and the reference's ``lax.scan`` over blocks is a Python loop over that
axis.
``remat="block"`` (the reference's ``jax.checkpoint`` in ``_scan_blocks``)
is ``torch.utils.checkpoint`` around each block while autograd records;
the backward then runs each block's forward once more.  ``remat="dots"``
(the reference's ``dots_with_no_batch_dims_saveable`` policy over the
decoder blocks) is the same checkpoint with a selective policy
(``DOTS_SAVEABLE``): the outputs of matrix products with no batch
dimension are saved and everything else is recomputed; the encoder gets
no remat under it, as in the reference.  The decode caches
keep the reference layouts, ``(n_blocks, n_attn, B, S_max, KV, dh)`` for
attention and ``(n_blocks, n_mamba or n_rwkv, B, ...)`` for the recurrent
layers, and are updated in place.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels.ssm_scan import ops as ssm_ops
from ..sharding.rules import logical_constraint
from .common import ArchConfig
from .convert import tree_map
from .layers import (_normal, attention_apply, attention_decode,
                     attention_init, chunked_xent, embed_lookup, linear, linear_init,
                     mlp_apply, mlp_init, rmsnorm, rmsnorm_init)
from .moe import moe_apply, moe_init
from .ssm import ssm_decode_step

def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _index(tree, i):
    """Block ``i`` of the stacked blocks (views, no copy)."""
    return tree_map(lambda x: x[i], tree)


# ===========================================================================
# mamba2 mixer (jamba's SSM layers)
# ===========================================================================
def _mamba_dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


def mamba_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    """The projections in ``dtype``; ``A_log``, ``dt_bias`` and ``D`` in
    fp32, as in the reference."""
    s = cfg.ssm
    d, (d_inner, H) = cfg.d_model, _mamba_dims(cfg)
    K = s.d_state
    dev = gen.device
    return {
        "wx": linear_init(gen, d, d_inner, dtype),
        "wz": linear_init(gen, d, d_inner, dtype),
        "wB": linear_init(gen, d, K, dtype),
        "wC": linear_init(gen, d, K, dtype),
        "wdt": linear_init(gen, d, H, dtype),
        "out": linear_init(gen, d_inner, d, dtype,
                           scale=1.0 / math.sqrt(d_inner * 2 * cfg.n_layers)),
        "conv_w": _normal(gen, (s.d_conv, d_inner), dtype, 0.5),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)),
        "dt_bias": torch.full((H,), -4.6, dtype=torch.float32, device=dev),  # softplus ~ 0.01
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm_y": rmsnorm_init(d_inner, dtype, dev),
    }


def _zeros_along(x, dim: int, n: int):
    """Zeros shaped as ``x`` but with ``n`` entries along ``dim``, in x's
    placements when ``x`` is a ``DTensor`` (``zeros_like`` of slices of
    it): concatenated to ``x``, they pad it as ``F.pad`` does, which torch
    2.11's DTensor cannot redistribute for (its planner's ``IndexError``)."""
    size = x.shape[dim]
    parts = [torch.zeros_like(x.narrow(dim, 0, min(size, n - i))) for i in range(0, n, size)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _shift(x, i: int):
    """x delayed by ``i`` steps along axis 1, zeros first:
    ``F.pad(x, (0, 0, i, 0))[:, :S]``."""
    S = x.shape[1]
    if i >= S:
        return torch.zeros_like(x)
    return torch.cat([_zeros_along(x, 1, i), x[:, :S - i]], dim=1)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv via shifts.  x: (B, S, D); w: (k, D); state:
    (B, k - 1, D) trailing inputs from the previous segment, or None."""
    kk, S = w.shape[0], x.shape[1]
    y = x * w[kk - 1]
    ext = None if state is None else torch.cat([state, x], dim=1)
    for i in range(1, kk):
        if ext is None:
            shifted = _shift(x, i)
        else:
            start = state.shape[1] - i
            shifted = ext[:, start:start + S]
        y = y + shifted * w[kk - 1 - i]
    return y


def mamba_apply(p, x, cfg: ArchConfig, state=None):
    """x: (B, S, d).  Returns (y, (ssm_state, conv_state)).  The scan runs
    through ``ssm_ops.ssm_scan`` with one log decay per (b, t, h) and q, k
    the (B, S, K) projections C_t and B_t expanded over the heads, as views:
    the kernel reads them in place."""
    s = cfg.ssm
    B, S, _ = x.shape
    d_inner, H = _mamba_dims(cfg)
    K, dh = s.d_state, s.head_dim
    xz = linear(p["wx"], x)
    z = linear(p["wz"], x)
    conv_state_in = None if state is None else state[1]
    xc = F.silu(_causal_conv(xz, p["conv_w"].to(x.dtype), conv_state_in))
    xc = logical_constraint(xc, "batch", None, "model")
    Bt = linear(p["wB"], x)                          # (B, S, K)
    Ct = linear(p["wC"], x)                          # (B, S, K)
    dt = F.softplus(linear(p["wdt"], x).float() + p["dt_bias"])  # (B, S, H)
    g = (-torch.exp(p["A_log"]) * dt)[..., None]     # (B, S, H, 1) log decay
    v = xc.reshape(B, S, H, dh) * dt.to(x.dtype)[..., None]  # dt-scaled input
    q = Ct[:, :, None, :].expand(B, S, H, K)
    k = Bt[:, :, None, :].expand(B, S, H, K)
    y, ssm_state = ssm_ops.ssm_scan(q, k, v, g, initial_state=None if state is None else state[0],
                                    chunk=min(s.chunk, S), subchunk=min(s.subchunk, S),
                                    scalar_decay=True,
                                    io_dtype=torch.bfloat16 if cfg.ssm_bf16_io
                                    else torch.float32)
    y = y + p["D"].to(x.dtype)[None, None, :, None] * xc.reshape(B, S, H, dh)
    y = rmsnorm(p["norm_y"], y.reshape(B, S, d_inner) * F.silu(z), cfg.norm_eps)
    # (the reference's slice: a prompt shorter than d_conv - 1 keeps fewer rows)
    conv_state = (xz[:, S - (s.d_conv - 1):] if state is None
                  else torch.cat([conv_state_in, xz], dim=1)[:, -(s.d_conv - 1):])
    return linear(p["out"], y), (ssm_state, conv_state)


def mamba_decode(p, x, cfg: ArchConfig, state):
    """One token.  x: (B, 1, d); state = (ssm (B, H, K, V) fp32, conv
    (B, k - 1, d_inner)).  The plain one-token step, as in the reference."""
    s = cfg.ssm
    B = x.shape[0]
    d_inner, H = _mamba_dims(cfg)
    K, dh = s.d_state, s.head_dim
    ssm_state, conv_state = state
    xz = linear(p["wx"], x)                          # (B, 1, d_inner)
    z = linear(p["wz"], x)
    ext = torch.cat([conv_state, xz], dim=1)         # (B, k, d_inner)
    xc = F.silu(torch.einsum("bkd,kd->bd", ext, p["conv_w"].to(x.dtype)))[:, None]
    Bt, Ct = linear(p["wB"], x), linear(p["wC"], x)
    dt = F.softplus(linear(p["wdt"], x).float() + p["dt_bias"])[:, 0]  # (B, H)
    g = -torch.exp(p["A_log"]) * dt                  # (B, H)
    v = xc.reshape(B, H, dh) * dt.to(x.dtype)[..., None]
    q = Ct[:, 0, None, :].expand(B, H, K)
    k = Bt[:, 0, None, :].expand(B, H, K)
    y, ssm_new = ssm_decode_step(q, k, v, g[..., None].expand(B, H, K), ssm_state)
    y = y + p["D"].to(x.dtype)[None, :, None] * xc.reshape(B, H, dh)
    y = rmsnorm(p["norm_y"], y.reshape(B, 1, d_inner) * F.silu(z), cfg.norm_eps)
    return linear(p["out"], y), (ssm_new, ext[:, 1:])


# ===========================================================================
# rwkv6 mixer + channel mix ("Finch": data-dependent decay)
# ===========================================================================
def _rwkv_dims(cfg: ArchConfig):
    dh = cfg.ssm.head_dim
    return cfg.d_model // dh, dh


def rwkv_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    d = cfg.d_model
    H, dh = _rwkv_dims(cfg)
    r = cfg.ssm.decay_rank
    dev = gen.device
    p = {
        "wr": linear_init(gen, d, d, dtype),
        "wk": linear_init(gen, d, d, dtype),
        "wv": linear_init(gen, d, d, dtype),
        "wg": linear_init(gen, d, d, dtype),
        "out": linear_init(gen, d, d, dtype,
                           scale=1.0 / math.sqrt(d * 2 * cfg.n_layers)),
        "decay_w1": _normal(gen, (d, r), dtype, 1.0 / math.sqrt(d)),
        "decay_w2": _normal(gen, (r, d), dtype, 1.0 / math.sqrt(r)),
        "decay_bias": torch.full((d,), -2.0, dtype=torch.float32, device=dev),
        "u": _normal(gen, (H, dh), torch.float32, 0.5),
        "ln_y": rmsnorm_init(d, dtype, dev),
    }
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        p[name] = torch.full((d,), 0.5, dtype=dtype, device=dev)
    return p


def _token_shift(x, prev=None):
    """x_{t-1} stream; prev: (B, 1, d) carried across segments."""
    if prev is None:
        return _shift(x, 1)
    return torch.cat([prev, x], dim=1)[:, :x.shape[1]]


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _log_decay(p, x, xs):
    """The data-dependent decay (the Finch contribution): the LoRA in x's
    dtype, then fp32 for ``-exp(decay_bias + lora)`` (< 0)."""
    xw = _mix(x, xs, p["mu_w"])
    # through ``linear``: sharded, each product's partial sums reduce at once
    lora = linear({"w": p["decay_w2"]}, torch.tanh(linear({"w": p["decay_w1"]}, xw)))
    return -torch.exp(p["decay_bias"] + lora.float())


def rwkv_time_mix(p, x, cfg: ArchConfig, state=None):
    """Returns (y, (ssm_state, last_x)).  x: (B, S, d).  The recurrence runs
    through ``kernels.ssm_scan.ops.ssm_scan``: the Hopper kernel on CUDA,
    the plain chunked form on the CPU.  (The op is looked up at call time:
    the kernel package imports ``models.ssm``, so a name bound at import
    would be a cycle.)"""
    B, S, d = x.shape
    H, dh = _rwkv_dims(cfg)
    prev = None if state is None else state[1]
    xs = _token_shift(x, prev)
    r = linear(p["wr"], _mix(x, xs, p["mu_r"])).reshape(B, S, H, dh)
    k = linear(p["wk"], _mix(x, xs, p["mu_k"])).reshape(B, S, H, dh)
    v = linear(p["wv"], _mix(x, xs, p["mu_v"])).reshape(B, S, H, dh)
    gate = F.silu(linear(p["wg"], _mix(x, xs, p["mu_g"])))
    if cfg.ssm_shard_constraints:
        # keep head-sharded activations head-sharded through the mixer
        r, k, v = (logical_constraint(t, "batch", None, "model", None) for t in (r, k, v))
        gate = logical_constraint(gate, "batch", None, "model")
    log_w = _log_decay(p, x, xs).reshape(B, S, H, dh)
    ssm_in = None if state is None else state[0]
    y, ssm_state = ssm_ops.ssm_scan(r, k, v, log_w, u=p["u"], initial_state=ssm_in,
                                    chunk=min(cfg.ssm.chunk, S),
                                    subchunk=min(cfg.ssm.subchunk, S),
                                    io_dtype=torch.bfloat16 if cfg.ssm_bf16_io
                                    else torch.float32)
    y = y.reshape(B, S, d)
    y = rmsnorm(p["ln_y"], y, cfg.norm_eps) * gate  # ln_y over all of d
    return linear(p["out"], y), (ssm_state, x[:, -1:, :])


def rwkv_time_mix_decode(p, x, cfg: ArchConfig, state):
    """One token, x: (B, 1, d); state: (ssm (B, H, dh, dh) fp32, last x).
    Returns (y, (new ssm state, x)); the plain step, as in the reference."""
    B, _, d = x.shape
    H, dh = _rwkv_dims(cfg)
    ssm_state, xs = state
    r = linear(p["wr"], _mix(x, xs, p["mu_r"])).reshape(B, H, dh)
    k = linear(p["wk"], _mix(x, xs, p["mu_k"])).reshape(B, H, dh)
    v = linear(p["wv"], _mix(x, xs, p["mu_v"])).reshape(B, H, dh)
    gate = F.silu(linear(p["wg"], _mix(x, xs, p["mu_g"])))
    log_w = _log_decay(p, x, xs).reshape(B, H, dh)
    y, ssm_new = ssm_decode_step(r, k, v, log_w, ssm_state, u=p["u"])
    y = y.reshape(B, 1, d)
    y = rmsnorm(p["ln_y"], y, cfg.norm_eps) * gate
    return linear(p["out"], y), (ssm_new, x)


def cmix_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wk": linear_init(gen, d, f, dtype),
        "wv": linear_init(gen, f, d, dtype,
                          scale=1.0 / math.sqrt(f * 2 * cfg.n_layers)),
        "wr": linear_init(gen, d, d, dtype),
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=gen.device),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=gen.device),
    }


def cmix_apply(p, x, cfg: ArchConfig, state=None):
    """rwkv channel mix; returns (y, last x).  ``state``: (B, 1, d) or None.
    Under ``ssm_shard_constraints`` the (B, S, d_ff) hidden stays sharded
    over "model", as the reference pins it."""
    xs = _token_shift(x, state)
    kk = torch.square(F.relu(linear(p["wk"], _mix(x, xs, p["mu_k"]))))
    if cfg.ssm_shard_constraints:
        kk = logical_constraint(kk, "batch", None, "model")
    rr = torch.sigmoid(linear(p["wr"], _mix(x, xs, p["mu_r"])))
    return rr * linear(p["wv"], kk), x[:, -1:, :]


# ===========================================================================
# block = a list of (mixer, ffn) layers
# ===========================================================================
def _layer_kinds(cfg: ArchConfig) -> list[tuple[str, str]]:
    """[(mixer, ffn)] per layer inside one block: mixer "attn", "mamba" or
    "rwkv"; ffn "dense", "moe" or "cmix"."""
    out = []
    for i, mixer in enumerate(cfg.block_pattern()):
        if mixer == "rwkv":
            out.append(("rwkv", "cmix"))
        else:
            out.append((mixer, cfg.ffn_kind(i)))
    return out


def block_init(gen: torch.Generator, cfg: ArchConfig, dtype, cross_attention=False):
    """One block's layers; with ``cross_attention`` each layer also has
    ``norm_x`` and ``xattn`` (the encoder-decoder's decoder blocks)."""
    layers = []
    for mixer, ffn in _layer_kinds(cfg):
        layer = {"norm1": rmsnorm_init(cfg.d_model, dtype, gen.device),
                 "norm2": rmsnorm_init(cfg.d_model, dtype, gen.device)}
        init = {"attn": attention_init, "mamba": mamba_init, "rwkv": rwkv_init}[mixer]
        layer[mixer] = init(gen, cfg, dtype)
        name, init = {"dense": ("mlp", mlp_init), "moe": ("moe", moe_init),
                      "cmix": ("cmix", cmix_init)}[ffn]
        layer[name] = init(gen, cfg, dtype)
        if cross_attention:
            layer["norm_x"] = rmsnorm_init(cfg.d_model, dtype, gen.device)
            layer["xattn"] = attention_init(gen, cfg, dtype)
        layers.append(layer)
    return {"layers": layers}


def block_apply(bp, x, cfg: ArchConfig, *, causal=True, enc_out=None, collect_cache=False):
    """Full-sequence pass through one block.  Returns (x, cache, aux): the
    cache holds only the kinds this block has, aux is the sum of its MoE
    layers' load-balance losses (fp32, 0 without MoE).  With ``enc_out``
    (B, S_enc, d), each layer cross-attends to it between its mixer and its
    ffn (under the profiler range ``cross_attention``), and the cache gains
    that branch's ``cross_k`` / ``cross_v``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = {"attn_k": [], "attn_v": [], "ssm": [], "conv": [], "shift_t": [],
             "shift_c": [], "cross_k": [], "cross_v": []}
    for layer, (mixer, ffn) in zip(bp["layers"], _layer_kinds(cfg)):
        h = rmsnorm(layer["norm1"], x, cfg.norm_eps)
        if mixer == "attn":
            out, (k, v) = attention_apply(layer["attn"], h, cfg, causal=causal)
            kept = {"attn_k": k, "attn_v": v}
        elif mixer == "mamba":
            out, (s_ssm, s_conv) = mamba_apply(layer["mamba"], h, cfg)
            kept = {"ssm": s_ssm, "conv": s_conv}
        else:
            out, (s_ssm, last) = rwkv_time_mix(layer["rwkv"], h, cfg)
            kept = {"ssm": s_ssm, "shift_t": last}
        x = x + out
        if enc_out is not None:
            with record_function("cross_attention"):
                h = rmsnorm(layer["norm_x"], x, cfg.norm_eps)
                out, (kept["cross_k"], kept["cross_v"]) = attention_apply(
                    layer["xattn"], h, cfg, causal=False, x_kv=enc_out)
                x = x + out
        h = rmsnorm(layer["norm2"], x, cfg.norm_eps)
        if ffn == "dense":
            out = mlp_apply(layer["mlp"], h, cfg)
        elif ffn == "moe":
            out, moe_aux = moe_apply(layer["moe"], h, cfg)
            aux = aux + moe_aux["moe_aux"]
        else:
            out, kept["shift_c"] = cmix_apply(layer["cmix"], h, cfg)
        x = logical_constraint(x + out, "batch", None, None)
        if collect_cache:
            for key, t in kept.items():
                cache[key].append(t)
    return x, {k: torch.stack(v) for k, v in cache.items() if v}, aux


def block_decode(bp, x, pos: int, cfg: ArchConfig, cache):
    """One-token pass; ``cache`` holds this block's stacked state tensors
    ((n_attn, B, S_max, KV, dh) KV caches; (n_mamba or n_rwkv, B, ...)
    recurrent states) and is updated in place.  Each kind of state has its
    own counter, advanced where the state is read: a mamba layer has no
    channel mix, so its ``ssm`` counter advances in the mixer branch.  The
    cross-attention caches (``cross_k`` / ``cross_v``, the encoder's keys and
    values from the prefill) are read, never written."""
    n = {"attn": 0, "ssm": 0, "shift_c": 0, "cross": 0}
    for layer, (mixer, ffn) in zip(bp["layers"], _layer_kinds(cfg)):
        h = rmsnorm(layer["norm1"], x, cfg.norm_eps)
        if mixer == "attn":
            j = n["attn"]
            out, _, _ = attention_decode(layer["attn"], h, cache["attn_k"][j],
                                         cache["attn_v"][j], pos, cfg)
            n["attn"] += 1
        elif mixer == "mamba":
            j = n["ssm"]
            out, (s_ssm, s_conv) = mamba_decode(layer["mamba"], h, cfg,
                                                (cache["ssm"][j], cache["conv"][j]))
            cache["ssm"][j].copy_(s_ssm)
            cache["conv"][j].copy_(s_conv)
            n["ssm"] += 1
        else:
            j = n["ssm"]
            out, (s_ssm, last) = rwkv_time_mix_decode(
                layer["rwkv"], h, cfg, (cache["ssm"][j], cache["shift_t"][j]))
            cache["ssm"][j].copy_(s_ssm)
            cache["shift_t"][j].copy_(last)
            n["ssm"] += 1
        x = x + out
        if "xattn" in layer:
            j = n["cross"]
            h = rmsnorm(layer["norm_x"], x, cfg.norm_eps)
            out, _, _ = attention_decode(layer["xattn"], h, None, None, pos, cfg,
                                         cross_kv=(cache["cross_k"][j], cache["cross_v"][j]))
            n["cross"] += 1
            x = x + out
        h = rmsnorm(layer["norm2"], x, cfg.norm_eps)
        if ffn == "dense":
            out = mlp_apply(layer["mlp"], h, cfg)
        elif ffn == "moe":
            out, _ = moe_apply(layer["moe"], h, cfg)
        else:
            j = n["shift_c"]
            out, last_c = cmix_apply(layer["cmix"], h, cfg, state=cache["shift_c"][j])
            cache["shift_c"][j].copy_(last_c)
            n["shift_c"] += 1
        x = x + out
    return x, cache


# ===========================================================================
# full model
# ===========================================================================
def init_params(gen: torch.Generator, cfg: ArchConfig):
    """Random parameters on ``gen.device``, in ``cfg.param_dtype``: an
    encoder-decoder adds ``enc_blocks`` (``n_encoder_layers`` blocks without
    cross-attention, stacked) and ``enc_norm``, a VLM ``vision_proj``."""
    dtype = _dtype(cfg.param_dtype)
    scale = 1.0 / math.sqrt(cfg.d_model)
    params = {
        "embed": {"table": _normal(gen, (cfg.vocab_size, cfg.d_model),
                                   dtype, scale)},
        "final_norm": rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    blocks = [block_init(gen, cfg, dtype, cross_attention=cfg.is_encdec)
              for _ in range(cfg.n_blocks)]
    params["blocks"] = tree_map(lambda *xs: torch.stack(xs), *blocks)
    del blocks
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                        dtype, scale=scale)
    if cfg.is_encdec:
        enc = [block_init(gen, cfg, dtype) for _ in range(cfg.encdec.n_encoder_layers)]
        params["enc_blocks"] = tree_map(lambda *xs: torch.stack(xs), *enc)
        del enc
        params["enc_norm"] = rmsnorm_init(cfg.d_model, dtype, gen.device)
    if cfg.vlm is not None:
        params["vision_proj"] = linear_init(gen, cfg.vlm.patch_dim, cfg.d_model, dtype)
    return params


def _embed(params, tokens, cfg: ArchConfig, batch=None):
    """Token embeddings in ``cfg.compute_dtype``; for a VLM with
    ``batch["image_embeds"]`` (B, n_image, patch_dim), the first n_image
    positions are the projected image embeddings instead."""
    x = embed_lookup(params["embed"]["table"], tokens).to(_dtype(cfg.compute_dtype))
    if cfg.vlm is not None and batch is not None and "image_embeds" in batch:
        img = linear(params["vision_proj"], batch["image_embeds"].to(x.dtype))
        n_img, S = img.shape[1], x.shape[1]
        if S < n_img:
            raise ValueError(f"_embed: a prompt of {S} tokens is shorter than its "
                             f"{n_img} image positions")
        x = torch.cat([img, x[:, n_img:]], dim=1)
    return logical_constraint(x, "batch", None, None)


#: the ops whose outputs ``remat="dots"`` saves: a product with no batch
#: dimension.  ``x @ W`` of a 3-D x dispatches as a view and ``aten.mm``;
#: attention's einsums and the MoE experts' ``torch.bmm`` carry a batch
#: dimension (``aten.bmm``) and are recomputed, as the reference's
#: ``"ecd,edf->ecf"`` is.  The kernels are ctypes calls the dispatcher never
#: sees: they run again in the recompute, into buffers allocated there.
DOTS_SAVEABLE = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVEABLE
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, encoder: bool = False) -> str:
    """The remat that applies while autograd records: "block", "dots" or
    "none"; the encoder has none under "dots"."""
    if not torch.is_grad_enabled() or (encoder and cfg.remat == "dots"):
        return "none"
    return cfg.remat


def _run_block(bp, x, cfg: ArchConfig, remat: str, **kw):
    """``block_apply``, under ``torch.utils.checkpoint`` for ``remat``
    "block", under it with the ``DOTS_SAVEABLE`` policy for "dots", and
    plain for any other value, as the reference's ``_scan_blocks``."""
    if remat == "block":
        return checkpoint(block_apply, bp, x, cfg, use_reentrant=False, **kw)
    if remat == "dots":
        return checkpoint(block_apply, bp, x, cfg, use_reentrant=False,
                          context_fn=partial(create_selective_checkpoint_contexts,
                                             _dots_policy), **kw)
    return block_apply(bp, x, cfg, **kw)


def _encode(params, audio_embeds, cfg: ArchConfig):
    """The encoder: ``audio_embeds`` (B, S_enc, d) in ``cfg.compute_dtype``
    through the non-causal encoder blocks (self-attention with RoPE, as the
    reference has it), then ``enc_norm``."""
    x = audio_embeds.to(_dtype(cfg.compute_dtype))
    remat = _remat(cfg, encoder=True)
    for i in range(cfg.encdec.n_encoder_layers):
        x, _, _ = _run_block(_index(params["enc_blocks"], i), x, cfg, remat, causal=False)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def final_hidden(params, batch, cfg: ArchConfig, collect_cache=False):
    """Returns (normed hidden (B, S, d), the MoE load-balance loss summed
    over blocks (fp32), cache stacked over blocks).  An encoder-decoder
    encodes ``batch["audio_embeds"]`` first (under the profiler range
    ``encoder``)."""
    enc_out = None
    if cfg.is_encdec:
        with record_function("encoder"):
            enc_out = _encode(params, batch["audio_embeds"], cfg)
    x = _embed(params, batch["tokens"], cfg, batch)
    remat = _remat(cfg)
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_blocks):
        x, cache, aux_i = _run_block(_index(params["blocks"], i), x, cfg, remat, causal=True,
                                     enc_out=enc_out, collect_cache=collect_cache)
        aux = aux + aux_i
        caches.append(cache)
    caches = ({k: torch.stack([c[k] for c in caches]) for k in caches[0]}
              if collect_cache else {})
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux, caches


def loss_fn(params, batch, cfg: ArchConfig, aux_weight: float = 0.01):
    """Mean next-token xent of ``batch["tokens"]`` against
    ``batch["labels"]`` (-1 ignored), plus ``aux_weight`` times the MoE
    load-balance loss (0 without MoE).  Returns (loss, {"xent", "moe_aux"})
    as the reference does."""
    x, aux, _ = final_hidden(params, batch, cfg)
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["lm_head"]["w"].T)
    xent = chunked_xent(table, x, batch["labels"],
                        chunk=min(cfg.logit_chunk, x.shape[1]))
    return xent + aux_weight * aux, {"xent": xent, "moe_aux": aux}


def logits_last(params, x_last, cfg: ArchConfig):
    """x_last: (B, 1, d) -> (B, 1, V) fp32."""
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["lm_head"]["w"].T)
    return (x_last @ table.to(x_last.dtype).T).float()


def prefill(params, batch, cfg: ArchConfig, pad_to: int | None = None):
    """Builds a serving cache; returns (last-token logits, cache, pos).

    ``pad_to`` sizes the attention KV cache for subsequent decode."""
    x, _, caches = final_hidden(params, batch, cfg, collect_cache=True)
    S = batch["tokens"].shape[1]
    if pad_to is not None and pad_to > S and "attn_k" in caches:
        for key in ("attn_k", "attn_v"):
            # (nb, n_attn, B, S, KV, dh): zero-pad the sequence axis
            caches[key] = torch.cat([caches[key], _zeros_along(caches[key], -3, pad_to - S)],
                                    dim=-3)
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
                      dtype=None, enc_len: int | None = None):
    """Zero decode cache: KV caches for attention layers; for mamba layers
    the fp32 recurrent state (d_state x head_dim) and the last d_conv - 1
    inputs of the conv; for rwkv layers the fp32 recurrent state and the
    two token-shift rows; for an encoder-decoder the cross-attention keys
    and values of ``enc_len`` (default ``n_audio_ctx``) encoder positions."""
    dtype = dtype or _dtype(cfg.compute_dtype)
    kinds = _layer_kinds(cfg)
    nb = cfg.n_blocks
    n_attn = sum(1 for m, _ in kinds if m == "attn")
    n_mamba = sum(1 for m, _ in kinds if m == "mamba")
    n_rwkv = sum(1 for m, _ in kinds if m == "rwkv")
    cache = {}
    if n_attn:
        shape = (nb, n_attn, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        cache["attn_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["attn_v"] = torch.zeros(shape, dtype=dtype, device=device)
    if n_mamba:
        d_inner, H = _mamba_dims(cfg)
        cache["ssm"] = torch.zeros((nb, n_mamba, batch, H, cfg.ssm.d_state, cfg.ssm.head_dim),
                                   dtype=torch.float32, device=device)
        cache["conv"] = torch.zeros((nb, n_mamba, batch, cfg.ssm.d_conv - 1, d_inner),
                                    dtype=dtype, device=device)
    if n_rwkv:
        H, hd = _rwkv_dims(cfg)
        cache["ssm"] = torch.zeros((nb, n_rwkv, batch, H, hd, hd),
                                   dtype=torch.float32, device=device)
        for key in ("shift_t", "shift_c"):
            cache[key] = torch.zeros((nb, n_rwkv, batch, 1, cfg.d_model),
                                     dtype=dtype, device=device)
    if cfg.is_encdec:
        shape = (nb, len(kinds), batch, enc_len or cfg.encdec.n_audio_ctx,
                 cfg.n_kv_heads, cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache
