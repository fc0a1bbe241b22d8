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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from ..kernels.flash_attention.ops import flash_attention_auto
from ..kernels.flash_attention.ref import chunked_attention  # noqa: F401  (the reference's layers.chunked_attention)
from ..sharding.rules import (layout, lift, local_heads, logical_constraint, mesh_coord,
                              shard_dims)
from .common import ArchConfig


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
class MetaInit:
    """Stands in for the generator of an init that only wants shapes and
    dtypes: every leaf lands on the ``meta`` device, as the reference's
    ``jax.eval_shape(api.init, key)`` gives ``ShapeDtypeStruct``s."""

    device = torch.device("meta")


def _normal(gen: torch.Generator, shape, dtype, scale):
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype)


def linear_init(gen, d_in, d_out, dtype, bias=False, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), dtype, scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p, x):
    y = reduce_partial(x @ p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _replicate_partial(t):
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


class _ReducePartial(torch.autograd.Function):
    """The identity on a ``DTensor``, whose forward and backward each reduce
    partial sums (``_replicate_partial``)."""

    @staticmethod
    def forward(ctx, y):
        return _replicate_partial(y)

    @staticmethod
    def backward(ctx, g):
        return _replicate_partial(g)


def reduce_partial(y):
    """``y`` with the partial sums of a ``DTensor`` reduced (an all-reduce
    over each mesh dim where it is ``Partial``), and so its gradient, as XLA
    reduces a product whose contracted dim is sharded.  Left partial, the
    sum would flow into the next product, and DTensor, which picks each
    op's layout by the bytes it moves, would gather that product's weight
    and run it whole on every rank rather than reduce the activation."""
    if not isinstance(y, DTensor):
        return y
    return _ReducePartial.apply(y) if y.requires_grad else _replicate_partial(y)


class _GradAsInput(torch.autograd.Function):
    """The identity on a ``DTensor``, whose gradient is redistributed to the
    input's placements (partial ones made whole)."""

    @staticmethod
    def forward(ctx, t):
        ctx.placements = [Replicate() if p.is_partial() else p for p in t.placements]
        return t

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def grad_as_input(t):
    """``t``, its gradient left in t's placements.  A parameter used twice
    (a tied embedding: the lookup and the LM head) then gets both uses'
    gradients in one layout, which DTensor adds as they are: torch 2.11
    plans the sum of a ``Shard`` and a ``Partial`` gradient by turning the
    ``Shard`` into a ``Partial``, which it cannot do."""
    if not isinstance(t, DTensor) or not t.requires_grad:
        return t
    return _GradAsInput.apply(t)


def embed_lookup(table, tokens):
    """``table[tokens]``.  A ``DTensor`` table is looked up on each rank's
    local tensors through ``local_map``, as a vocab-parallel embedding: a
    rank takes the rows of its vocab slice (the table's ``Shard(0)``; its
    width gathered, as ZeRO-3 gathers a weight where it is used) for its
    batch rows, zeros for the tokens outside the slice, and the pieces sum
    over the vocab's mesh dims (``reduce_partial``).  DTensor's own rules
    (torch 2.11) fail there: the backward of ``table[tokens]`` is an
    ``index_put`` it cannot place, and that of ``index_select`` an
    ``index_add`` given the global index count on a 3-D mesh."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh, (table, tokens) = lift(table, tokens)
    vdims, nv = shard_dims(table, 0)
    bdims = [i for i in shard_dims(tokens, 0)[0] if i not in vdims]
    wp, tp = layout(mesh.ndim, (vdims, Shard(0))), layout(mesh.ndim, (bdims, Shard(0)))
    rows = table.shape[0] // nv

    def local(w, t):
        t = t - mesh_coord(mesh, vdims) * rows
        held = (t >= 0) & (t < rows)
        return torch.where(held[..., None], w[t.clamp(0, rows - 1)], 0)

    x = local_map(local, out_placements=list(layout(mesh.ndim, (bdims, Shard(0)),
                                                    (vdims, Partial()))),
                  in_placements=(wp, tp),
                  in_grad_placements=(layout(mesh.ndim, (bdims, Partial()), (vdims, Shard(0))),
                                      tp),
                  device_mesh=mesh, redistribute_inputs=True)(table, tokens)
    return reduce_partial(x)


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


def split_dim(t, dim: int, n: int):
    """``t`` with dim ``dim`` split into (n, size // n): (..., n_heads * dh)
    into heads, or heads into (kv heads, group).  A ``DTensor`` whose dim
    ``dim`` is cut over mesh dims whose product does not divide ``n`` (8 kv
    heads under a 16-wide model axis) is first redistributed to be cut over
    the largest leading run of those mesh dims that does, and whole on the
    rest: DTensor cannot view a dim cut into pieces that straddle the new
    outer dim (XLA's partitioner reshards by itself in the reference)."""
    dim = dim % t.dim()
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        cut = [i for i, p in enumerate(t.placements) if p == Shard(dim)]
        keep, prod = 0, 1
        while keep < len(cut) and n % (prod * mesh.size(cut[keep])) == 0:
            prod *= mesh.size(cut[keep])
            keep += 1
        if keep < len(cut):
            t = t.redistribute(mesh, [Replicate() if i in cut[keep:] else p
                                      for i, p in enumerate(t.placements)])
    return t.reshape(*t.shape[:dim], n, t.shape[dim] // n, *t.shape[dim + 1:])


def _qkv(p, x, x_kv, cfg):
    q = split_dim(linear(p["wq"], x), -1, cfg.n_heads)
    kv_src = x if x_kv is None else x_kv
    k = split_dim(linear(p["wk"], kv_src), -1, cfg.n_kv_heads)
    v = split_dim(linear(p["wv"], kv_src), -1, cfg.n_kv_heads)
    return q, k, v


def full_attention(q, k, v, *, causal, window=None, q_offset=0,
                   kv_positions=None):
    """Softmax attention over the full score matrix.
    q: (B,Sq,H,dh) k/v: (B,Skv,KV,dh).  ``DTensor``s run it on each rank's
    local batch rows and heads (``local_heads``)."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        return local_heads(q, k, v, lambda q, k, v: full_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            kv_positions=kv_positions))
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
                    x_kv=None, use_rope=True):
    """Full-sequence (prefill) attention; returns (out, (k, v)).
    Self-attention (``x_kv`` None) takes the plain full-matrix path when
    ``cfg.attn_impl == "full"``, as in the reference, and
    ``flash_attention_auto`` for any other value.  Cross-attention (keys and
    values from ``x_kv``) has no RoPE and always takes ``full_attention``,
    as the reference's ``layers.py:205`` does.
    ``cfg.attn_shard_constraints`` pins q to (batch, heads) and k, v to
    (batch, kv_heads) under the active sharding rules."""
    B, S = x.shape[:2]
    q, k, v = _qkv(p, x, x_kv, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope and x_kv is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.attn_shard_constraints:
        q = logical_constraint(q, "batch", None, "model", None)
        k = logical_constraint(k, "batch", None, "kv_heads", None)
        v = logical_constraint(v, "batch", None, "kv_heads", None)
    if cfg.attn_impl == "full" or x_kv is not None:
        out = full_attention(q, k, v, causal=causal, window=cfg.swa_window)
    else:
        out = flash_attention_auto(q, k, v, causal=causal,
                                   window=cfg.swa_window, cfg=cfg)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return linear(p["wo"], out), (k, v)


def _write_at(cache, pos, new):
    """``cache[:, pos] = new[:, 0]`` in place; cache (B, S_max, ...), new
    (B, 1, ...), ``pos`` an int or a 0-d integer tensor, which is never
    read on the host.  A ``DTensor`` cache is written through each rank's
    local shard: one cut over S_max (the KV cache when its heads do not
    divide the model axis) by the ranks whose shard holds ``pos``, at its
    local row (DTensor's own indexing would write row ``pos`` of every
    rank's shard); with a tensor ``pos`` every rank writes its row nearest
    ``pos``, with itself where its shard does not hold ``pos``."""
    new = new.to(cache.dtype)
    if not isinstance(cache, DTensor):
        if isinstance(pos, torch.Tensor):
            cache.index_copy_(1, pos.reshape(1).long(), new)
        else:
            cache[:, pos] = new[:, 0]
        return
    mesh = cache.device_mesh
    new = new.redistribute(mesh, [Replicate() if p == Shard(1) else p for p in cache.placements])
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, cache.placements)
    local, row = cache.to_local(), new.to_local()
    if isinstance(pos, torch.Tensor):
        pos = pos.to_local() if isinstance(pos, DTensor) else pos
        i = (pos - offset[1]).clamp(0, shape[1] - 1).reshape(1).long()
        held = (pos >= offset[1]) & (pos < offset[1] + shape[1])
        local.index_copy_(1, i, torch.where(held, row, local.index_select(1, i)))
    elif offset[1] <= pos < offset[1] + shape[1]:
        local[:, pos - offset[1]] = row[:, 0]


def attention_decode(p, x, cache_k, cache_v, pos, cfg: ArchConfig, *,
                     use_rope=True, cross_kv=None):
    """One-token decode against a fixed-size KV cache.

    x: (B, 1, d); cache_k/v: (B, S_max, KV, dh); pos: an int or a 0-d
    integer tensor (the decode cell's abstract ``pos``).  The new k/v
    are written into the caches in place at ``pos`` (the reference returns
    updated copies from ``dynamic_update_slice``).  With ``cross_kv`` =
    (k, v), the encoder's (B, S_enc, KV, dh), the token attends to every
    one of those positions, without RoPE, and no cache is written.
    Returns (out, cache_k, cache_v).
    """
    B = x.shape[0]
    dh = cfg.head_dim
    q = split_dim(linear(p["wq"], x), -1, cfg.n_heads)
    if cross_kv is not None:
        k, v = cross_kv
        mask_pos = torch.ones(k.shape[1], dtype=torch.bool, device=x.device)
    else:
        k_new = split_dim(linear(p["wk"], x), -1, cfg.n_kv_heads)
        v_new = split_dim(linear(p["wv"], x), -1, cfg.n_kv_heads)
        if use_rope:
            # a tensor ``pos`` is broadcast, not read: no host sync, and none on ``meta``
            pos_arr = (pos.to(torch.int32).expand(B, 1) if isinstance(pos, torch.Tensor)
                       else torch.full((B, 1), pos, dtype=torch.int32, device=x.device))
            q = apply_rope(q, pos_arr, cfg.rope_theta)
            k_new = apply_rope(k_new, pos_arr, cfg.rope_theta)
        _write_at(cache_k, pos, k_new)
        _write_at(cache_v, pos, v_new)
        k, v = cache_k, cache_v
        kv_pos = torch.arange(k.shape[1], device=x.device)
        mask_pos = kv_pos <= pos
        if cfg.swa_window is not None:
            mask_pos &= kv_pos > pos - cfg.swa_window
    qg = split_dim(q, 2, k.shape[2])  # (B, 1, KV, G, dh)
    attend = _attend_sharded if isinstance(k, DTensor) else _attend_one
    out = attend(qg, k, v, mask_pos).reshape(B, 1, cfg.n_heads * dh)
    return linear(p["wo"], out), cache_k, cache_v


def _scores(qg, k, mask_pos):
    """(B, KV, G, S) fp32 scores of one query position, masked to -1e30."""
    s = torch.einsum("bqkgd,bskd->bkgs", qg, k).float()
    s = s * (1.0 / math.sqrt(qg.shape[-1]))
    return torch.where(mask_pos[None, None, None, :], s, -1e30)


def _attend_one(qg, k, v, mask_pos):
    """One query position against a KV cache: qg (B, 1, KV, G, dh), k / v
    (B, S, KV, dh), mask_pos (S,) -> (B, 1, KV, G, dh) in qg's dtype."""
    p_attn = torch.softmax(_scores(qg, k, mask_pos), dim=-1).to(qg.dtype)
    return torch.einsum("bkgs,bskd->bkgd", p_attn, v)[:, None]


def _attend_sharded(qg, k, v, mask_pos):
    """``_attend_one`` of ``DTensor``s, on each rank's local tensors through
    ``local_map`` in k's layout: batch rows (``Shard(0)``), kv heads
    (``Shard(2)``) and cache positions (``Shard(1)``: a KV cache cut over
    S_max).  DTensor's own dispatch of the einsums plans redistributions for
    minutes on a 3-D mesh, and over cut positions torch 2.11 sizes their
    local views wrongly.  Over cut positions the softmax takes two passes,
    as flash decoding splits a cache: each rank's row maxima reduce to the
    global ones (``Partial("max")``), then each rank's exp-weighted sum of v
    and its normaliser reduce as partial sums and divide."""
    kp = tuple(p if p in (Shard(0), Shard(1), Shard(2)) else Replicate() for p in k.placements)
    mesh, (qg, k, v, mask_pos) = lift(qg, k, v, mask_pos)
    seq = [i for i, p in enumerate(kp) if p == Shard(1)]
    qp = tuple(Replicate() if i in seq else p for i, p in enumerate(kp))
    if not seq:
        return local_map(_attend_one, out_placements=list(qp), device_mesh=mesh,
                         in_placements=(qp, kp, kp, (Replicate(),) * mesh.ndim),
                         redistribute_inputs=True)(qg, k, v, mask_pos)
    mp = layout(mesh.ndim, (seq, Shard(0)))

    def stat(over_seq):  # placements of (B, KV, G) statistics
        return tuple(over_seq if i in seq else Shard(1) if p == Shard(2) else p
                     for i, p in enumerate(kp))

    m = local_map(lambda q, k, msk: _scores(q, k, msk).amax(-1),
                  out_placements=list(stat(Partial("max"))), in_placements=(qp, kp, mp),
                  device_mesh=mesh, redistribute_inputs=True)(qg, k, mask_pos)
    m = m.redistribute(mesh, stat(Replicate()))

    def sums(q, k, v, msk, m):
        p_attn = torch.exp(_scores(q, k, msk) - m[..., None])
        return (torch.einsum("bkgs,bskd->bkgd", p_attn.to(q.dtype), v)[:, None],
                p_attn.sum(-1))

    out_p = tuple(Partial() if i in seq else p for i, p in enumerate(qp))
    acc, l = local_map(sums, out_placements=(list(out_p), list(stat(Partial()))),
                       in_placements=(qp, kp, kp, mp, stat(Replicate())), device_mesh=mesh,
                       redistribute_inputs=True)(qg, k, v, mask_pos, m)
    acc, l = _replicate_partial(acc), _replicate_partial(l)
    return (acc.float() / l[:, None, :, :, None]).to(qg.dtype)


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
    table = grad_as_input(embed_table).to(x.dtype)
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = 0
    for start in range(0, S, chunk):
        xi, li = x[:, start:start + chunk], labels[:, start:start + chunk]
        # sharded, the chunk's logits are gathered over the vocab first: DTensor's
        # gather of a vocab-sharded tensor leaves a masked partial that the
        # indexing below cannot reduce
        logits = logical_constraint((xi @ table.T).float(), "batch", None, None)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li.clamp(0, V - 1).long()[..., None])[..., 0]
        valid = li >= 0
        tot = tot + torch.where(valid, lse - gold, 0.0).sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1)
