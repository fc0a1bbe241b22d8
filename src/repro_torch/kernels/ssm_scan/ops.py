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
over K on either device.  Nothing is expanded or copied on the way: the
kernel reads such a decay as one value per (b, t, h), and q and k through
their strides (mamba's are one row per (b, t), expanded over the heads).
``scalar_decay=True`` says the decay is constant over K, as the
reference's ``ssm_scan_chunked`` takes it: the plain path then forms the
(R, R, H) pairwise decays, not the (R, R, H, K) ones (1.07 GB per batch
row and sub-chunk at jamba's width).  The kernel computes the same
function either way.

``io_dtype`` and ``shard_constrain`` are the arguments the reference's
rwkv6 layer gives ``ssm_scan_chunked``: q, k and v are rounded to
``io_dtype`` before the fp32 math, and ``shard_constrain=True`` raises,
since the port has no sharding yet (ROADMAP A12).

Both run through ``SSMScan``, a ``torch.autograd.Function``.  Its forward
is the dispatch above.  The reference has no backward kernel: it trains
through ``jax.grad`` of ``ssm_scan_chunked``.  So the backward here
recomputes the plain chunked form under autograd from the saved inputs
and backpropagates through it, on either device; it launches no kernel.
The gradient of a (B, T, H, 1) decay comes back in that shape (the plain
form broadcasts it over K inside, and autograd sums over K).  The
``io_dtype`` rounding stays outside the Function, so autograd passes its
gradient straight through, as ``jax.grad`` of an ``astype`` does.
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


def _plain(q, k, v, log_decay, u, initial_state, chunk, subchunk, scalar_decay):
    """The plain path (the CPU forward; the backward on either device), as
    the reference's ops: pad T up to a chunk multiple (zero k, v, g are
    inert), run the chunked form, cut y back to T."""
    T = q.shape[1]
    pad = (-T) % chunk
    if pad:
        q, k, v, log_decay = (_pad_time(t, pad) for t in (q, k, v, log_decay))
    y, s_fin = ssm_scan_chunked(q, k, v, log_decay, u=u, initial_state=initial_state,
                                chunk=chunk, subchunk=subchunk, scalar_decay=scalar_decay)
    return y[:, :T], s_fin


class SSMScan(torch.autograd.Function):
    """Forward: kernel on CUDA, plain chunked on the CPU.  Backward: the
    gradient of the plain chunked form (``chunk``, ``subchunk``,
    ``scalar_decay``)."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay, u, initial_state, chunk: int, subchunk: int,
                scalar_decay: bool):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, log_decay, u, initial_state)
        ctx.chunks = (chunk, subchunk, scalar_decay)
        if q.device.type == "cuda":
            return kernel.ssm_scan_fwd(q, k, v, log_decay, u, initial_state)
        return _plain(q, k, v, log_decay, u, initial_state, *ctx.chunks)

    @staticmethod
    def backward(ctx, dy, ds):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        with torch.profiler.record_function("ssm_scan/plain_backward"):
            with torch.enable_grad():
                outs = _plain(*inputs, *ctx.chunks)
            # training reads y alone: the final state's gradient is None
            outs, grads = zip(*((o, d) for o, d in zip(outs, (dy, ds)) if d is not None))
            got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (*(next(got) if t is not None and t.requires_grad else None
                  for t in inputs), None, None, None)


def ssm_scan(q, k, v, log_decay, u=None, initial_state=None, *,
             chunk: int = 128, subchunk: int = 16, scalar_decay: bool = False,
             io_dtype=torch.float32, shard_constrain: bool = False):
    """q, k: (B, T, H, K); log_decay: (B, T, H, K) or (B, T, H, 1); v:
    (B, T, H, V); u: (H, K) or None; initial_state: (B, H, K, V) or None.
    ``scalar_decay``: the decay is constant over K (mamba).  Returns
    (y (B, T, H, V) in q's dtype, final state (B, H, K, V) float32)."""
    sub = _check_chunks(chunk, subchunk)
    if shard_constrain:
        raise NotImplementedError(
            "ssm_scan: shard_constrain needs the port's sharding rules, "
            "ROADMAP A12 (distribution)")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ssm_scan: no path for device {q.device}")
    # the rounding ssm_scan_chunked does to its fp32 copies, in place of them
    q, k, v = (t.to(io_dtype).to(t.dtype)
               if torch.finfo(io_dtype).eps > torch.finfo(t.dtype).eps else t
               for t in (q, k, v))
    return SSMScan.apply(q, k, v, log_decay, u, initial_state, chunk, sub, scalar_decay)
