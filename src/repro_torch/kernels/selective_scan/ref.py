"""Plain PyTorch versions of the Mamba-1 selective scan: the exact step
recurrence (the oracle) and the chunk-parallel form (the CPU path of
``ops.selective_scan`` and the backward on either device).

Per batch row and channel c, with a state s of N:

    s_t[n] = exp(dt_t[c] A[c, n]) s_{t-1}[n] + dt_t[c] B_t[n] u_t[c]
    y_t[c] = sum_n C_t[n] s_t[n] + D[c] u_t[c]

Both compute in float32 (float64 inputs stay float64, for ``gradcheck``)
and return y in u's dtype and the final state in that compute type.
"""

from __future__ import annotations

import torch


def _compute_type(u) -> torch.dtype:
    return torch.promote_types(u.dtype, torch.float32)


def selective_scan_ref(u, dt, A, B, C, D=None, initial_state=None):
    """The exact recurrence, one step at a time.  u, dt: (Bt, T, Dc); A:
    (Dc, N); B, C: (Bt, T, N); D: (Dc,) or None; initial_state: (Bt, Dc, N)
    or None.  Returns (y (Bt, T, Dc), final state (Bt, Dc, N))."""
    ct = _compute_type(u)
    Bt, T, Dc = u.shape
    uf, df, Af, Bf, Cf = (t.to(ct) for t in (u, dt, A, B, C))
    s = (torch.zeros((Bt, Dc, A.shape[-1]), dtype=ct, device=u.device)
         if initial_state is None else initial_state.to(ct))
    ys = []
    for t in range(T):
        d = df[:, t, :, None]
        s = torch.exp(d * Af) * s + d * uf[:, t, :, None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", s, Cf[:, t]))
    y = torch.stack(ys, 1) if ys else uf.new_zeros((Bt, 0, Dc))
    if D is not None:
        y = y + D.to(ct) * uf
    return y.to(u.dtype), s


def selective_scan_chunked(u, dt, A, B, C, D=None, initial_state=None, *, chunk: int = 16):
    """The chunk-parallel form of :func:`selective_scan_ref`: T in chunks of
    ``chunk`` steps (the last may be shorter), the state carried once a
    chunk.  Within a chunk, with z the cumulative log decay from its start,

        s_t = exp(z_t) s_start + sum_{j <= t} exp(z_t - z_j) dt_j B_j u_j

    Every exponent is <= 0 (A < 0, dt >= 0), so none can overflow.  It forms
    (Bt, chunk, chunk, Dc, N) pairwise decays a chunk: a CPU and backward
    form for small shapes, not the card's."""
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be at least 1")
    ct = _compute_type(u)
    Bt, T, Dc = u.shape
    uf, df, Af, Bf, Cf = (t.to(ct) for t in (u, dt, A, B, C))
    s = (torch.zeros((Bt, Dc, A.shape[-1]), dtype=ct, device=u.device)
         if initial_state is None else initial_state.to(ct))
    ys = []
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        d = df[:, t0:t1, :, None]                                   # (Bt, L, Dc, 1)
        z = torch.cumsum(d * Af, dim=1)                             # (Bt, L, Dc, N)
        x = d * uf[:, t0:t1, :, None] * Bf[:, t0:t1, None, :]       # (Bt, L, Dc, N)
        L = t1 - t0
        keep = torch.ones((L, L), dtype=torch.bool, device=u.device).tril()[:, :, None, None]
        pair = torch.exp(torch.where(keep, z[:, :, None] - z[:, None], float("-inf")))
        states = torch.einsum("btjcn,bjcn->btcn", pair, x) + torch.exp(z) * s[:, None]
        ys.append(torch.einsum("btcn,btn->btc", states, Cf[:, t0:t1]))
        s = states[:, -1]
    y = torch.cat(ys, 1) if ys else uf.new_zeros((Bt, 0, Dc))
    if D is not None:
        y = y + D.to(ct) * uf
    return y.to(u.dtype), s


def selective_scan_step(u, dt, A, B, C, D, state):
    """One token: u, dt (Bt, Dc); B, C (Bt, N); state (Bt, Dc, N) fp32.
    Returns (y (Bt, Dc) in u's dtype, the new state)."""
    y, s = selective_scan_ref(u[:, None], dt[:, None], A, B[:, None], C[:, None], D, state)
    return y[:, 0], s
