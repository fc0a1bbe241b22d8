"""Device dispatch for the Mamba-1 selective scan.

A CUDA tensor goes to the Hopper kernel (``kernel.py``), a CPU or ``meta``
tensor to the plain chunked form (``ref.py``); any other device raises.
There is no fallback: a kernel that fails to build or launch raises.

Both run through ``SelectiveScan``, a ``torch.autograd.Function`` whose
forward is that dispatch and whose backward recomputes the plain chunked
form under autograd from the saved inputs, on either device, and launches
no kernel, as ``ssm_scan.ops.SSMScan`` does.  The plain form's pairwise
decays make that backward one for small shapes: no cell trains a Mamba-1
model.
"""

from __future__ import annotations

import torch

from . import kernel
from ...obs.ranges import span
from .ref import selective_scan_chunked


class SelectiveScan(torch.autograd.Function):
    """Forward: kernel on CUDA, plain chunked elsewhere.  Backward: the
    gradient of the plain chunked form (``chunk``)."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D, initial_state, chunk: int):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u, dt, A, B, C, D, initial_state)
        ctx.chunk = chunk
        if u.device.type == "cuda":
            return kernel.selective_scan_fwd(u, dt, A, B, C, D, initial_state)
        return selective_scan_chunked(u, dt, A, B, C, D, initial_state, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, ds):
        if dy is None and ds is None:
            return (None,) * (len(ctx.saved_tensors) + 1)
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        with span("selective_scan/plain_backward"):
            with torch.enable_grad():
                outs = selective_scan_chunked(*inputs, chunk=ctx.chunk)
            outs, grads = zip(*((o, g) for o, g in zip(outs, (dy, ds)) if g is not None))
            got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (*(next(got) if t is not None and t.requires_grad else None for t in inputs),
                None)


def selective_scan(u, dt, A, B, C, D=None, initial_state=None, *, chunk: int = 16):
    """u, dt: (Bt, T, Dc); A: (Dc, N); B, C: (Bt, T, N); D: (Dc,) or None;
    initial_state: (Bt, Dc, N) or None.  Returns (y (Bt, T, Dc) in u's
    dtype, final state (Bt, Dc, N) float32).  ``chunk`` shapes the plain
    form only."""
    if u.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"selective_scan: no path for device {u.device}")
    return SelectiveScan.apply(u, dt, A, B, C, D, initial_state, chunk)
