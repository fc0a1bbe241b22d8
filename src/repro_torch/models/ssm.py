"""Chunked gated linear recurrence, ported from ``repro/models/ssm.py``:
the shared math under the jamba mamba layers (scalar-per-head decay) and
rwkv6 (per-key data-dependent decay, "Finch").

Recurrence (per batch b, head h; K = key dim, V = value dim):

    S_t = diag(a_t) @ S_{t-1} + k_t^T v_t          S in R^{K x V}
    y_t = q_t @ S_t                                 (mamba2; inclusive)
    y_t = q_t @ (S_{t-1} + diag(u) k_t^T v_t)       (rwkv6; u = bonus)

with a_t = exp(g_t), g_t <= 0.  Three plain versions:

* ``ssm_scan_ref``     -- the exact step recurrence (the oracle); the
  reference's ``lax.scan`` is a Python loop over T.
* ``ssm_scan_chunked`` -- the chunk-parallel form: an intra-(sub)chunk
  pairwise term plus the inter-chunk state carry.  Every exponent is a
  difference z_i - z_j (j <= i) of a decreasing cumulative log decay, so
  it is <= 0 and needs no clamp.  The reference's ``unroll`` has no
  meaning for a Python loop and is left out.
* ``ssm_decode_step``  -- one token.

All do their math in fp32 and return y in q's dtype and the state in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..sharding.rules import lift, logical_constraint


def ssm_scan_ref(q, k, v, log_decay, u=None, initial_state=None):
    """Exact recurrence.  Shapes:
      q, k: (B, T, H, K); v: (B, T, H, V); log_decay: (B, T, H, K)
      u: (H, K) or None; initial_state: (B, H, K, V) or None.
    Returns (y: (B, T, H, V), final_state: (B, H, K, V)).  float32 inside.
    """
    B, T, H, K = q.shape
    V = v.shape[-1]
    qf, kf, vf = (x.float() for x in (q, k, v))
    gf = log_decay.float()
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    uf = None if u is None else u.float()[None, :, :, None]
    ys = []
    for t in range(T):
        qt, kt, vt, gt = qf[:, t], kf[:, t], vf[:, t], gf[:, t]
        kv = kt[..., :, None] * vt[..., None, :]  # (B,H,K,V)
        if uf is None:
            S = torch.exp(gt)[..., None] * S + kv
            y = torch.einsum("bhk,bhkv->bhv", qt, S)
        else:
            y = torch.einsum("bhk,bhkv->bhv", qt, S + uf * kv)
            S = torch.exp(gt)[..., None] * S + kv
        ys.append(y)
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, H, V), dtype=torch.float32, device=q.device))
    return y.to(q.dtype), S


def _pad_time(x, pad):
    """Zero-pads axis 1 of a (B, T, H, D) tensor by ``pad`` steps."""
    return F.pad(x, (0, 0, 0, 0, 0, pad))


def ssm_scan_chunked(q, k, v, log_decay, u=None, initial_state=None,
                     chunk: int = 128, subchunk: int = 16,
                     scalar_decay: bool = False, shard_constrain: bool = False,
                     io_dtype=torch.float32):
    """Chunk-parallel equivalent of :func:`ssm_scan_ref`.

    ``scalar_decay=True`` asserts log_decay is constant over K (mamba2's
    per-head scalar), taking the cheap (R, R) pairwise path instead of the
    per-key (R, R, K) one.  ``log_decay`` may have a last axis of 1, which
    broadcasts over K.  ``shard_constrain`` pins the chunk operands to a
    (batch, heads) sharding under the active rules, as the reference does
    (``sharding.rules.logical_constraint``: the identity with no rules or
    on plain tensors).
    """
    B, T, H, K = q.shape
    V = v.shape[-1]
    L = min(chunk, T)
    pad = (-T) % L if L else 0
    if pad:  # zero k/v/g padding is inert to the recurrence
        y_pad, s_fin = ssm_scan_chunked(
            _pad_time(q, pad), _pad_time(k, pad), _pad_time(v, pad),
            _pad_time(log_decay, pad), u=u, initial_state=initial_state,
            chunk=L, subchunk=subchunk, scalar_decay=scalar_decay,
            shard_constrain=shard_constrain, io_dtype=io_dtype)
        return y_pad[:, :T], s_fin
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    if T == 0:
        return torch.zeros((B, 0, H, V), dtype=q.dtype, device=q.device), S
    R = min(subchunk, L)
    if L % R:
        raise ValueError(f"chunk={L} must divide by subchunk={R}")
    NC, NS = T // L, L // R

    qf = q.to(io_dtype).reshape(B, NC, L, H, K)
    kf = k.to(io_dtype).reshape(B, NC, L, H, K)
    vf = v.to(io_dtype).reshape(B, NC, L, H, V)
    gf = log_decay.float().expand(B, T, H, K).reshape(B, NC, L, H, K)
    if shard_constrain:
        spec = ("batch", None, None, "model", None)
        qf, kf, vf, gf = (logical_constraint(t, *spec) for t in (qf, kf, vf, gf))
    uf = None if u is None else u.float()

    dev = q.device
    mask = torch.tril(torch.ones((R, R), dtype=torch.bool, device=dev),
                      diagonal=-1 if uf is not None else 0)[None, :, :, None]
    ycs = []
    for c in range(NC):
        qc, kc, vc = qf[:, c].float(), kf[:, c].float(), vf[:, c].float()
        gc = gf[:, c]                   # (B, L, H, K)
        z = torch.cumsum(gc, dim=1)     # inclusive cumulative log decay
        # rwkv6 reads the state *before* the current step's decay: the
        # q-side exponent uses the exclusive cumsum z - g.
        zq_all = z - gc if uf is not None else z
        ys = []
        for s in range(NS):
            sl = slice(s * R, (s + 1) * R)
            qs, ks, vs = qc[:, sl], kc[:, sl], vc[:, sl]
            zs, zqs = z[:, sl], zq_all[:, sl]
            z_start = z[:, s * R - 1] if s > 0 else torch.zeros_like(z[:, 0])
            z_end = z[:, (s + 1) * R - 1]
            # inter: contribution of the running state S
            q_dec = qs * torch.exp(zqs - z_start[:, None])   # exp <= 1
            y = torch.einsum("brhk,bhkv->brhv", q_dec, S)
            # intra: pairwise within the sub-chunk.  A masked pair (j > i)
            # has a positive exponent that can overflow; it gets -inf, so exp
            # gives 0 and no inf reaches the sum or its gradient.  (The
            # reference's jnp form multiplies exp(...) by the mask and gives
            # nan once a sub-chunk's log decay sums below about -88; its Pallas
            # kernel selects, as here.)
            if scalar_decay:
                zh, zqh = zs[..., 0], zqs[..., 0]             # (B,R,H)
                E = torch.exp((zqh[:, :, None] - zh[:, None])
                              .masked_fill(~mask, float("-inf")))  # (B,R,R,H)
                A = torch.einsum("bihk,bjhk->bijh", qs, ks) * E
            else:
                # per-key decay: (R,R,K) pairwise in sub-chunks only
                Ez = torch.exp((zqs[:, :, None] - zs[:, None])
                               .masked_fill(~mask[..., None], float("-inf")))
                A = (qs[:, :, None] * ks[:, None] * Ez).sum(dim=-1)  # (B,R,R,H)
            y = y + torch.einsum("bijh,bjhv->bihv", A, vs)
            if uf is not None:  # rwkv6 current-token bonus
                bonus = (qs * uf * ks).sum(dim=-1)            # (B,R,H)
                y = y + bonus[..., None] * vs
            ys.append(y)
            # state carry to the next sub-chunk (all exponents <= 0)
            k_dec = ks * torch.exp(z_end[:, None] - zs)
            S = (torch.exp(z_end - z_start)[..., None] * S
                 + torch.einsum("brhk,brhv->bhkv", k_dec, vs))
        ycs.append(torch.cat(ys, dim=1))
    y = torch.stack(ycs, dim=1).reshape(B, T, H, V)
    return y.to(q.dtype), S


def ssm_decode_step(q, k, v, log_decay, state, u=None):
    """One-token decode: q, k: (B, H, K); v: (B, H, V); state: (B, H, K, V).
    Returns (y (B, H, V) in q's dtype, new state fp32).  A ``DTensor`` state
    runs the step on each rank's batch rows and heads, the state's layout
    (the step is local to a (b, h)): DTensor's own dispatch of its einsum
    plans redistributions for minutes on a 3-D mesh."""
    if not isinstance(state, DTensor):
        return _decode_step(q, k, v, log_decay, state, u)
    rows = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in state.placements)
    heads = tuple(Shard(0) if p == Shard(1) else Replicate() for p in rows)
    mesh, ts = lift(q, k, v, log_decay, state, u)
    return local_map(_decode_step, out_placements=(rows, rows), device_mesh=mesh,
                     in_placements=(rows,) * 5 + (None if u is None else heads,),
                     redistribute_inputs=True)(*ts)


def _decode_step(q, k, v, log_decay, state, u):
    qf, kf, vf = (x.float() for x in (q, k, v))
    gf = log_decay.float()
    kv = kf[..., :, None] * vf[..., None, :]
    if u is None:
        S_new = torch.exp(gf)[..., None] * state + kv
        y = torch.einsum("bhk,bhkv->bhv", qf, S_new)
    else:
        y = torch.einsum("bhk,bhkv->bhv", qf,
                         state + u.float()[None, :, :, None] * kv)
        S_new = torch.exp(gf)[..., None] * state + kv
    return y.to(q.dtype), S_new
