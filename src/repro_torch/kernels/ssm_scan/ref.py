"""Plain PyTorch versions of the ssm_scan kernel: the exact step recurrence
(the oracle), the chunk-parallel form (the CPU path of ``ops.ssm_scan``),
and ``ssm_scan_blocked``, the Hopper kernel's own blocking written out in
plain PyTorch so that its algebra can be tested on the CPU.

``ssm_scan_ref`` and ``ssm_scan_chunked`` are re-exported from
``repro_torch.models.ssm``, so the kernel's oracle and the model's plain
path are the same code, as in the reference's ``ref.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...models.ssm import ssm_scan_chunked as ssm_scan_chunked  # noqa: F401
from ...models.ssm import ssm_scan_ref as ssm_scan_ref  # noqa: F401


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(eq: str, x, y, split: bool):
    """einsum ``eq`` of two fp32 operands; with ``split``, as the tensor
    cores would take it in TF32 with the 3-way split: hi = tf32(x), lo =
    tf32(x - hi), and x_hi y_hi + x_hi y_lo + x_lo y_hi in fp32."""
    if not split:
        return torch.einsum(eq, x, y)
    xh, yh = tf32_round(x), tf32_round(y)
    xl, yl = tf32_round(x - xh), tf32_round(y - yh)
    return torch.einsum(eq, xh, yh) + torch.einsum(eq, xh, yl) + torch.einsum(eq, xl, yh)


def _cumprod_excl(a, dim):
    """Exclusive running product along ``dim``: 1, a0, a0 a1, ..."""
    ones = torch.ones_like(a.narrow(dim, 0, 1))
    return torch.cumprod(torch.cat([ones, a.narrow(dim, 0, a.shape[dim] - 1)], dim), dim)


def ssm_scan_blocked(q, k, v, log_decay, u=None, initial_state=None, *,
                     chunk_len: int = 32, sub_len: int = 4, tf32_split: bool = False):
    """The Hopper kernel's blocking of :func:`ssm_scan_ref`, in plain PyTorch.

    T is walked in chunks of ``chunk_len`` tokens (a ragged end is padded
    with inert zeros), each cut into sub-chunks of ``sub_len``, and the
    state is carried once per chunk.  Every decay factor is a product of
    per-step decays a_t = exp(g_t) <= 1, so none can overflow:

    * w_i: decay from the start of i's sub-chunk to i's read point (to
      t = i - 1 with u, to i without); r_j: from j to its sub-chunk's end;
      D_s: across sub-chunk s; P_s / Q_s: across the sub-chunks before /
      after s; M_ab: across the sub-chunks strictly between b and a.
    * q' = q w, k' = k r, qd = q' P (= q e^{zq}), kd = k' Q (= k e^{z_L - z}).
    * diagonal R x R blocks exact: A_ij = sum_k q_ik k_jk prod a over
      (j, i) with u (j < i) or (j, i] without (j <= i);
    * off-diagonal blocks factorised about the end of b:
      A_ij = sum_k (q'_i M_ab)_k k'_jk, both sides <= 1;
    * y = qd S + A v + (q u k) v;  S <- D_L S + kd^T v.

    ``tf32_split=True`` rounds the operands of qd S, A v and kd^T v as the
    tensor-core kernel does (``_mm``); it builds A itself in fp32.
    Returns (y in q's dtype, final state fp32).  Used by the tests and
    ``chip_smoke.py``, never by the main path."""
    L, R = chunk_len, sub_len
    if L < 1 or R < 1 or L % R:
        raise ValueError(f"chunk_len={L} must divide by sub_len={R}")
    B, T, H, K = q.shape
    V = v.shape[-1]
    NS = L // R
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float().clone())
    pad = (-T) % L
    # (B, H, T, .) fp32, padded with inert steps (q = k = v = 0, g = 0)
    qf, kf, vf, gf = (F.pad(x.float().expand(B, T, H, x.shape[-1]).transpose(1, 2),
                            (0, 0, 0, pad))
                      for x in (q, k, v, log_decay.expand(B, T, H, K)))
    uf = None if u is None else u.float()[None, :, None, :]          # (1, H, 1, K)
    ys = []
    for c0 in range(0, T + pad, L):
        qc, kc, gc = (x[:, :, c0:c0 + L].reshape(B, H, NS, R, K) for x in (qf, kf, gf))
        vc = vf[:, :, c0:c0 + L]                                       # (B, H, L, V)
        a = torch.exp(gc)
        w = _cumprod_excl(a, 3) if uf is not None else torch.cumprod(a, 3)
        r = _cumprod_excl(a.flip(3), 3).flip(3)
        D = torch.prod(a, 3)                                           # (B, H, NS, K)
        P = _cumprod_excl(D, 2)
        Q = _cumprod_excl(D.flip(2), 2).flip(2)
        qp, kp = qc * w, kc * r
        qd = (qp * P[:, :, :, None]).reshape(B, H, L, K)
        kd = (kp * Q[:, :, :, None]).reshape(B, H, L, K)
        D_L = P[:, :, -1] * D[:, :, -1]
        A = torch.zeros((B, H, NS, R, NS, R), dtype=torch.float32, device=q.device)
        for sa in range(NS):
            m = torch.ones_like(D[:, :, 0])
            for sb in range(sa - 1, -1, -1):   # M_{a,b}, walking b down from a - 1
                A[:, :, sa, :, sb] = torch.einsum("bhik,bhjk->bhij",
                                                  qp[:, :, sa] * m[:, :, None], kp[:, :, sb])
                m = m * D[:, :, sb]
            # diagonal block: the exact decay between j and i's read point
            ad = a[:, :, sa]
            E = torch.zeros((B, H, R, R, K), dtype=torch.float32, device=q.device)
            for i in range(R):
                x = torch.ones_like(ad[:, :, 0])
                if uf is None:
                    E[:, :, i, i] = x
                for j in range(i - 1, -1, -1):
                    if uf is None or j < i - 1:
                        x = x * ad[:, :, j + 1]
                    E[:, :, i, j] = x
            A[:, :, sa, :, sa] = torch.einsum("bhik,bhjk,bhijk->bhij", qc[:, :, sa],
                                              kc[:, :, sa], E)
        A = A.reshape(B, H, L, L)
        y = _mm("bhlk,bhkv->bhlv", qd, S, tf32_split) + _mm("bhls,bhsv->bhlv", A, vc,
                                                             tf32_split)
        if uf is not None:
            qa, ka = qc.reshape(B, H, L, K), kc.reshape(B, H, L, K)
            y = y + (qa * uf * ka).sum(-1, keepdim=True) * vc
        S = D_L[..., None] * S + _mm("bhlk,bhlv->bhkv", kd, vc, tf32_split)
        ys.append(y)
    y = (torch.cat(ys, dim=2)[:, :, :T] if ys
         else torch.zeros((B, H, 0, V), dtype=torch.float32, device=q.device))
    return y.transpose(1, 2).to(q.dtype), S
