"""Device dispatch for the chunked gated linear recurrence.

``ssm_scan`` has the signature of the reference's
``repro/kernels/ssm_scan/ops.py::ssm_scan``.  A CUDA tensor goes to the
Hopper kernel (``kernel.py``), a CPU tensor to the plain chunked version
(``ref.py``), and so does a ``meta`` tensor, whose FLOPs the dry run
counts (``launch/dryrun.py``); any other device raises.  There is no
fallback: a kernel that fails to build or launch raises.

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

``io_dtype`` is the argument the reference's rwkv6 layer gives
``ssm_scan_chunked``: q, k and v are rounded to it before the fp32 math.
Its other one, ``shard_constrain``, pins the chunk operands to (batch,
heads); it has no counterpart here, as a rank computes on its local
tensors, where a pin is the identity, and the layer pins the operands
before this call.

Sharded inputs (``DTensor``s) go through ``local_map``: neither the
kernel nor ``SSMScan`` knows DTensor, so each rank runs it on its local
batch rows and heads (``_local_heads``).

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from . import kernel
from ...obs.ranges import span
from ...models.ssm import _pad_time
from ...sharding.rules import layout, lift, shard_dims
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
        with span("ssm_scan/plain_backward"):
            with torch.enable_grad():
                outs = _plain(*inputs, *ctx.chunks)
            # training reads y alone: the final state's gradient is None
            outs, grads = zip(*((o, d) for o, d in zip(outs, (dy, ds)) if d is not None))
            got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (*(next(got) if t is not None and t.requires_grad else None
                  for t in inputs), None, None, None)


def _local_heads(q, k, v, log_decay, u, initial_state, scan):
    """``scan(q, k, v, log_decay, u, initial_state)`` on each rank's local
    tensors through ``local_map``.  v's ``Shard(0)`` (batch) and ``Shard(2)``
    (heads) set the layout; every other mesh dim is replicated (the scan
    needs whole sequences).  q, k and the decay follow v; ``u`` (H, K) is cut
    over the heads and the states (B, H, K, V) over batch and heads.  ``u``
    has no batch dim, so its gradient is a partial sum over the batch's mesh
    dims."""
    ref = next(t for t in (v, q, k, log_decay, u, initial_state) if isinstance(t, DTensor))
    (bdims, _), (hdims, _) = shard_dims(ref, 0), shard_dims(ref, 2)
    mesh, ts = lift(q, k, v, log_decay, u, initial_state)

    def place(batch, head):
        return layout(mesh.ndim, (bdims, batch), (hdims, head))

    seq, state = place(Shard(0), Shard(2)), place(Shard(0), Shard(1))
    has_u, has_s = u is not None, initial_state is not None
    in_place = (seq, seq, seq, seq, place(Replicate(), Shard(0)) if has_u else None,
                state if has_s else None)
    grad_place = in_place[:4] + (place(Partial(), Shard(0)) if has_u else None, in_place[5])
    return local_map(scan, out_placements=(seq, state), in_placements=in_place,
                     in_grad_placements=grad_place, device_mesh=mesh,
                     redistribute_inputs=True)(*ts)


def ssm_scan(q, k, v, log_decay, u=None, initial_state=None, *,
             chunk: int = 128, subchunk: int = 16, scalar_decay: bool = False,
             io_dtype=torch.float32):
    """q, k: (B, T, H, K); log_decay: (B, T, H, K) or (B, T, H, 1); v:
    (B, T, H, V); u: (H, K) or None; initial_state: (B, H, K, V) or None.
    ``scalar_decay``: the decay is constant over K (mamba).  Returns
    (y (B, T, H, V) in q's dtype, final state (B, H, K, V) float32)."""
    sub = _check_chunks(chunk, subchunk)
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"ssm_scan: no path for device {q.device}")
    # the rounding ssm_scan_chunked does to its fp32 copies, in place of them
    q, k, v = (t.to(io_dtype).to(t.dtype)
               if torch.finfo(io_dtype).eps > torch.finfo(t.dtype).eps else t
               for t in (q, k, v))
    scan = lambda *ts: SSMScan.apply(*ts, chunk, sub, scalar_decay)
    if any(isinstance(t, DTensor) for t in (q, k, v, log_decay, u, initial_state)):
        return _local_heads(q, k, v, log_decay, u, initial_state, scan)
    return scan(q, k, v, log_decay, u, initial_state)
