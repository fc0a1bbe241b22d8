"""Mixture-of-Experts FFN with top-k routing and scatter dispatch, ported
from ``repro/models/moe.py``.

Tokens are scattered into per-expert capacity buffers (no (T, E, C)
one-hot dispatch tensor), the expert FFNs run as one batched product over
(E, C, D), and the outputs gather back weighted by the router
probabilities of the top-k, renormalised to sum to 1 (``MoEConfig.renormalize``;
AI21's Jamba weighs by the raw softmax probabilities).  The semantics are the reference's to the token: the router
runs in fp32, each (token, slot) takes its place in its expert's queue in
token-major order, and a slot past the capacity is dropped.  Two layouts
differ from the reference's, for the card's sake, not the result's: the
queue places are a running count along each expert's row of an
(E, T*K) one-hot (a scan along the inner axis; the reference's scan down
the (T*K, E) columns took 3 ms a layer on an H100 at 2048 tokens), and the
kept slots are written into the buffers directly, the dropped ones into a
spare row past the capacity that is cut off (the reference adds zeroed
sources at the last place; an add with accumulation took 0.7 ms a layer).

``moe_shard_constraints`` pins the dispatch buffers as the reference does:
``"expert"`` shards them over experts, ``"capacity"`` over experts and
capacity slots (``sharding.rules.logical_constraint``, the identity with
no rules installed).

Sharded (``DTensor``s), the scatter, the expert FFN and the gather run on
each rank's local tensors through ``local_map`` (``_local_dispatch``,
``_local_experts``, ``_local_combine``): a rank holds the experts its mesh
coordinate gives it, the (token, slot) rows of its batch rows and, unpinned,
its share of each expert's capacity slots, and its pieces sum over the
other ranks.  DTensor's own rules for ``index_put`` and ``index`` on an
expert-sharded buffer (torch 2.11) size the result wrongly or fail, and
the layout it picks for the expert products depends on the torch version.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..obs.ranges import span
from ..sharding.rules import layout, lift, logical_constraint, mesh_coord, shard_dims
from .common import ArchConfig
from .layers import _normal, reduce_partial


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


def _top_k(probs, k: int):
    """``torch.topk(probs, k, dim=-1)``.  A ``DTensor`` goes through
    ``local_map`` on its rows, the expert dim whole: DTensor caches the
    sharding of ``topk`` by its input's spec alone, not by ``k``, so a
    second ``topk`` of an input like the first's but another ``k`` (dbrx's
    top 4 after jamba's top 2, in one process) would take the first one's
    global shape."""
    if not isinstance(probs, DTensor):
        return torch.topk(probs, k, dim=-1)
    rows = tuple(p if p == Shard(0) else Replicate() for p in probs.placements)
    return local_map(lambda t: torch.topk(t, k, dim=-1), out_placements=(rows, rows),
                     in_placements=(rows,), device_mesh=probs.device_mesh,
                     redistribute_inputs=True)(probs)


def _expert_layout(src, wi, T: int):
    """(mesh, expert mesh dims, token mesh dims) of a sharded MoE layer: the
    mesh dims that cut the experts' weights by expert, and those that cut
    the (T*K, D) token rows ``src`` into whole tokens."""
    mesh = src.device_mesh
    edims = shard_dims(wi, 0)[0] if isinstance(wi, DTensor) else []
    tdims = [i for i in shard_dims(src, 0)[0] if i not in edims]
    if T % math.prod(mesh.size(i) for i in tdims):
        tdims = []
    return mesh, edims, tdims


def _held(mesh, edims, e, n_local: int):
    """(local expert index, whether this rank holds the expert) of the
    global expert indices ``e``, this rank holding ``n_local`` experts."""
    e = e - mesh_coord(mesh, edims) * n_local
    held = (e >= 0) & (e < n_local)
    return torch.where(held, e, 0), held


def _local_dispatch(lay, src, expert, slot, E: int, C: int):
    """The (E, C, D) buffers of a sharded layer: each rank scatters its
    token rows into the experts it holds (a row of another rank's expert,
    and a dropped one, into the spare row C, cut off); every (expert,
    slot) is written by one token, so the buffers are the sum of the
    ranks' over the token mesh dims (``Partial``)."""
    mesh, edims, tdims = lay
    n_local = E // math.prod(mesh.size(i) for i in edims)
    _, (src, expert, slot) = lift(src, expert, slot)
    rows = layout(mesh.ndim, (tdims, Shard(0)))

    def local(x, e, c):
        e, held = _held(mesh, edims, e, n_local)
        buf = torch.zeros((n_local, C + 1, x.shape[-1]), dtype=x.dtype, device=x.device)
        return buf.index_put((e, torch.where(held, c, C)), x)[:, :C]

    return local_map(local, out_placements=list(layout(mesh.ndim, (tdims, Partial()),
                                                       (edims, Shard(0)))),
                     in_placements=(rows, rows, rows),
                     in_grad_placements=(layout(mesh.ndim, (tdims, Shard(0)),
                                                (edims, Partial())), rows, rows),
                     device_mesh=mesh, redistribute_inputs=True)(src, expert, slot)


def _to_slots(buf):
    """Unpinned, the dispatch buffers' partial sums reduce-scattered over
    their capacity slots on the mesh dims where they are partial (when the
    slots divide): each rank then runs the expert products on its own
    slots (``_local_experts``), not every rank on all of them."""
    mesh = buf.device_mesh
    cut = [i for i, p in enumerate(buf.placements) if p.is_partial()]
    if not cut or buf.shape[1] % math.prod(mesh.size(i) for i in cut):
        return buf
    return buf.redistribute(mesh, [Shard(1) if i in cut else p
                                   for i, p in enumerate(buf.placements)])


def _experts(buf, w):
    """The batched expert FFN: (E, C, D) buffers through each expert's
    (E, D, F) / (E, F, D) weights.  Where autograd records nothing (a
    prefill) on a plain tensor, the gate's SiLU and product run in place
    in its (E, C, F) buffer: two such buffers at a time, not four (9.4 GB,
    not 18.8, at 64k tokens and 16 experts of width 14336).  A ``DTensor``
    cannot keep a partial sum's placement through an in-place op."""
    h_in = torch.bmm(buf, w["wi"].to(buf.dtype))
    if "wg" in w:
        g = torch.bmm(buf, w["wg"].to(buf.dtype))
        if g.requires_grad or isinstance(g, DTensor):
            h = F.silu(g) * h_in
        else:
            h = F.silu(g, inplace=True).mul_(h_in)
        del h_in
    else:
        h = F.gelu(h_in, approximate="tanh")  # jax.nn.gelu's default
    return torch.bmm(h, w["wo"].to(buf.dtype))


def _local_experts(lay, buf, p):
    """``_experts`` of a sharded layer whose capacity slots are cut over
    ranks, on each rank's experts and slots through ``local_map``: the
    buffers keep their slots' ``Shard(1)`` and their experts' mesh dims, the
    weights are gathered whole but for the experts (as ZeRO-3 gathers a
    weight where it is used), and their gradients sum over the slots' mesh
    dims.  Left to DTensor, the layout depends on the torch version: torch
    2.11 ran dbrx's and jamba's expert products over every slot on every
    data rank.  With few slots (a decode step) gathering the weights costs
    more than the products: there the slots stay whole and DTensor cuts
    the products' inner dims."""
    mesh, edims, _ = lay
    sdims = [i for i, pl in enumerate(buf.placements) if pl == Shard(1) and i not in edims]
    bp = layout(mesh.ndim, (sdims, Shard(1)), (edims, Shard(0)))
    wp = layout(mesh.ndim, (edims, Shard(0)))
    wgrad = layout(mesh.ndim, (sdims, Partial()), (edims, Shard(0)))
    names = [n for n in ("wi", "wg", "wo") if n in p]
    _, (buf, *ws) = lift(buf, *(p[n] for n in names))
    return local_map(lambda b, *w: _experts(b, dict(zip(names, w))), out_placements=list(bp),
                     in_placements=(bp, *[wp] * len(names)),
                     in_grad_placements=(bp, *[wgrad] * len(names)),
                     device_mesh=mesh, redistribute_inputs=True)(buf, *ws)


def _local_combine(lay, out_buf, expert, slot, weight, K: int):
    """(T, D): each token's K expert outputs ``out_buf[expert, slot]``
    weighted and summed, of a sharded layer: each rank gathers the rows of
    its tokens from the experts it holds (all their slots), so the sum is
    partial over the expert mesh dims (``Partial``)."""
    mesh, edims, tdims = lay
    n_local = out_buf.shape[0] // math.prod(mesh.size(i) for i in edims)
    _, (out_buf, expert, slot, weight) = lift(out_buf, expert, slot, weight)
    rows = layout(mesh.ndim, (tdims, Shard(0)))
    part = layout(mesh.ndim, (tdims, Shard(0)), (edims, Partial()))

    def local(ob, e, c, w):
        e, held = _held(mesh, edims, e, n_local)
        g = torch.where(held[:, None], ob[e, c], 0) * w
        return g.reshape(-1, K, g.shape[-1]).sum(dim=1)

    return local_map(local, out_placements=list(part),
                     in_placements=(layout(mesh.ndim, (edims, Shard(0))), rows, rows, rows),
                     in_grad_placements=(layout(mesh.ndim, (tdims, Partial()), (edims, Shard(0))),
                                         rows, rows, part),
                     device_mesh=mesh, redistribute_inputs=True)(out_buf, expert, slot, weight)


def moe_apply(p, x, cfg: ArchConfig):
    """x: (B, S, D) -> (y: (B, S, D), {"moe_aux": load-balance loss,
    "moe_drop_frac": share of (token, slot) pairs dropped}).  Routing and
    the scatter run under the profiler range ``moe/dispatch``, the expert
    products under ``moe/experts``, the gather and the weighted sum under
    ``moe/combine``."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = capacity(T, cfg)
    with span("moe/dispatch"):
        xt = x.reshape(T, D)

        logits = xt.float() @ p["router"]["w"].float()
        probs = torch.softmax(logits, dim=-1)                        # (T, E)
        gate, idx = _top_k(probs, K)                                 # (T, K)
        if m.renormalize:
            gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

        # position of each (token, slot) within its expert queue, token-major
        expert = idx.reshape(T * K)
        hot = (torch.arange(E, device=x.device)[:, None] == expert).to(torch.int32)  # (E, T*K)
        pos = torch.cumsum(hot, dim=1, dtype=torch.int32).gather(0, expert[None])[0] - 1
        keep = pos < C                                               # capacity drop

        # scatter tokens into (E, C, D) buffers: the dropped slots into row C, cut off
        pin = {"expert": ("expert", None, None),
               "capacity": ("expert", "batch", None)}.get(cfg.moe_shard_constraints)
        src = xt.repeat_interleave(K, dim=0)                         # (T*K, D)
        if pin:
            src = logical_constraint(src, "batch", None)
        lay = _expert_layout(src, p["wi"], T) if isinstance(src, DTensor) else None
        if lay:
            buf = _local_dispatch(lay, src, expert, torch.where(keep, pos, C), E, C)
            buf = reduce_partial(logical_constraint(buf, *pin) if pin else _to_slots(buf))
        else:
            buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
            buf = buf.index_put((expert, torch.where(keep, pos, C)), src)[:, :C]
        pos_c = torch.where(keep, pos, C - 1)

    # capacity slots cut over ranks (train and prefill): each rank runs its own;
    # else (a decode step's few slots) DTensor cuts the products' inner dims
    with span("moe/experts"):
        out_buf = (_local_experts(lay, buf, p) if lay and Shard(1) in buf.placements
                   else _experts(buf, p))
    if pin:
        out_buf = logical_constraint(out_buf, *pin)

    with span("moe/combine"):
        # gather back + weighted combine over the K slots
        weight = (keep[:, None] * gate.reshape(T * K)[:, None]).to(x.dtype)
        if lay:
            y = reduce_partial(_local_combine(lay, out_buf, expert, pos_c, weight, K))
        else:
            gathered = out_buf[expert, pos_c] * weight                # (T*K, D)
            y = gathered.reshape(T, K, D).sum(dim=1)

    # GShard/Switch load-balance auxiliary loss
    me = probs.mean(dim=0)                                       # (E,)
    ce = hot.sum(dim=1).float() / T                              # fraction routed
    aux_loss = E * torch.sum(me * ce) / K
    return y.reshape(B, S, D), {"moe_aux": aux_loss,
                                "moe_drop_frac": 1.0 - keep.float().mean()}
