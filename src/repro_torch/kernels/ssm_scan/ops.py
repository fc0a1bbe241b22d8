"""Device dispatch for the chunked gated linear recurrence.

``ssm_scan`` has the signature of the reference's
``repro/kernels/ssm_scan/ops.py::ssm_scan``.  A CUDA tensor goes to the
Hopper kernel (``kernel.py``), a CPU tensor to the plain chunked version
(``ref.py``), any other device raises.  There is no fallback: a kernel
that fails to build or launch raises.

``chunk`` and ``subchunk`` shape the plain version, as they shape the TPU
kernel's blocks; the Hopper kernel walks T in its own steps and masks a
ragged end itself.  Both paths accept the same arguments: a ``chunk``
that ``subchunk`` does not divide raises on either device, and a
``log_decay`` of shape (B, T, H, 1) (mamba's per-head scalar) broadcasts
over K on either device (on CUDA the wrapper then copies it to a
contiguous (B, T, H, K) tensor).

``io_dtype`` and ``shard_constrain`` are the arguments the reference's
rwkv6 layer gives ``ssm_scan_chunked``: q, k and v are rounded to
``io_dtype`` before the fp32 math, and ``shard_constrain=True`` raises,
since the port has no sharding yet (ROADMAP A12).

The op is forward-only on CUDA, as the reference's kernel is: there is no
backward kernel, so a call that autograd would record through the kernel
raises (rwkv6 training, ROADMAP A9a).  The CPU path is plain PyTorch and
differentiable.
"""

from __future__ import annotations

import torch

from . import kernel
from ...models.ssm import _pad_time
from .ref import ssm_scan_chunked


def _check_chunks(chunk: int, subchunk: int) -> int:
    sub = min(subchunk, chunk)
    if chunk < 1 or sub < 1 or chunk % sub:
        raise ValueError(f"chunk={chunk} must divide by subchunk={sub}")
    return sub


def ssm_scan(q, k, v, log_decay, u=None, initial_state=None, *,
             chunk: int = 128, subchunk: int = 16, io_dtype=torch.float32,
             shard_constrain: bool = False):
    """q, k: (B, T, H, K); log_decay: (B, T, H, K) or (B, T, H, 1); v:
    (B, T, H, V); u: (H, K) or None; initial_state: (B, H, K, V) or None.
    Returns (y (B, T, H, V) in q's dtype, final state (B, H, K, V)
    float32)."""
    sub = _check_chunks(chunk, subchunk)
    if shard_constrain:
        raise NotImplementedError(
            "ssm_scan: shard_constrain needs the port's sharding rules, "
            "ROADMAP A12 (distribution)")
    log_decay = log_decay.expand(q.shape)
    dev = q.device
    if dev.type == "cuda":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (q, k, v, log_decay, u, initial_state)):
            raise NotImplementedError(
                "ssm_scan: the CUDA kernel has no backward; training through "
                "the scan on the card is ROADMAP A9a (rwkv6 training)")
        # the rounding ssm_scan_chunked does to its fp32 copies, in place of them
        q, k, v = (t.to(io_dtype).to(t.dtype)
                   if torch.finfo(io_dtype).eps > torch.finfo(t.dtype).eps else t
                   for t in (q, k, v))
        return kernel.ssm_scan_fwd(q, k, v, log_decay, u, initial_state)
    if dev.type == "cpu":
        # as the reference's ops: pad T up to a chunk multiple (zero k, v, g
        # are inert), run the chunked form, cut y back to T
        T = q.shape[1]
        pad = (-T) % chunk
        if pad:
            q, k, v, log_decay = (_pad_time(t, pad) for t in (q, k, v, log_decay))
        y, s_fin = ssm_scan_chunked(q, k, v, log_decay, u=u,
                                    initial_state=initial_state,
                                    chunk=chunk, subchunk=sub, io_dtype=io_dtype)
        return y[:, :T], s_fin
    raise ValueError(f"ssm_scan: no path for device {dev}")
