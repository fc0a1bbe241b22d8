"""Device dispatch for flash attention, with a gradient.

``flash_attention`` takes (B, S, H, dh) tensors as the reference's
``repro/kernels/flash_attention/ops.py::flash_attention`` does.  A CUDA
tensor goes to the Hopper kernel (``kernel.py``), a CPU tensor to the
plain chunked version (``ref.py``), and so does a ``meta`` tensor: the dry
run (``launch/dryrun.py``) counts the FLOPs of the plain chunked form, as
the reference's dry run counts its default ``attn_impl="chunked"``.  Any
other device raises.  There is no fallback: a kernel that fails to build
or launch raises.

``flash_attention_auto`` is what the model layer calls.  Unlike the
reference, where ``cfg.attn_impl`` picks Pallas or chunked jnp, the
device picks the path; ``cfg`` sizes the KV chunks of the plain version,
and ``cfg.attn_accum_bf16`` takes its P.V and accumulator in bf16 as the
reference's chunked path does, on every device: on CUDA the kernel
computes that mode itself over KV chunks of the same ``chunk`` rows
(``kernel.flash_attention_fwd``'s ``accum_chunk``), on the CPU and on
``meta`` the plain chunked form does.

Both run through ``FlashAttention``, a ``torch.autograd.Function``.  Its
forward is the dispatch above.  The reference has no backward kernel: it
trains through ``jax.grad`` of ``chunked_attention``.  So the backward
here recomputes ``chunked_attention`` under autograd from the saved q, k,
v and backpropagates through it, on either device; it launches no kernel.

Sharded inputs (``DTensor``s, once a cell's params are distributed) go
through ``local_map``: neither the kernel nor ``FlashAttention`` knows
DTensor, so each rank runs it, the kernel on CUDA or the plain form on
the CPU, on its local batch rows and heads (``sharding.rules.local_heads``).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from . import kernel
from ...obs.ranges import span
from ...sharding.rules import local_heads
from .ref import chunked_attention

#: KV chunk of the CPU path of ``flash_attention`` (the TPU kernel's block)
CPU_CHUNK = 128


def _dispatch(q, k, v, *, causal, window, chunk, accum_bf16=False):
    if q.device.type == "cuda":
        return kernel.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                          accum_chunk=chunk if accum_bf16 else 0)
    if q.device.type in ("cpu", "meta"):
        return chunked_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                                 accum_bf16=accum_bf16)
    raise ValueError(f"flash_attention: no path for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Forward: kernel on CUDA, plain chunked on the CPU.  Backward: the
    gradient of the plain chunked version (``chunk`` KV rows at a time)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None, chunk: int,
                accum_bf16: bool = False):
        ctx.save_for_backward(q, k, v)
        ctx.attn = dict(causal=causal, window=window, chunk=chunk, accum_bf16=accum_bf16)
        return _dispatch(q, k, v, **ctx.attn)

    @staticmethod
    def backward(ctx, do):
        with span("flash_attention/plain_backward"):
            with torch.enable_grad():
                q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
                o = chunked_attention(q, k, v, **ctx.attn)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        # contiguous, as a sharded caller's reshape of them needs (DTensor views
        # its local shards and cannot copy; a plain reshape would copy anyway)
        return dq.contiguous(), dk.contiguous(), dv.contiguous(), None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh) -> (B, Sq, H, dh)."""
    attend = lambda q, k, v: FlashAttention.apply(q, k, v, causal, window, CPU_CHUNK)
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        return local_heads(q, k, v, attend)
    return attend(q, k, v)


def flash_attention_auto(q, k, v, *, causal, window, cfg):
    """Model-layer attention: the kernel on CUDA, and on the CPU the
    reference's default chunked path with its ``cfg.attn_chunk`` and
    ``cfg.attn_accum_bf16``; ``DTensor``s through ``local_heads``.  The
    reference's ``attn_shard_constraints`` pin of the KV chunks has no
    counterpart here: the layer pins k and v before this call, and a rank
    computes on its local tensors, where a pin is the identity."""
    chunk = min(cfg.attn_chunk, k.shape[1])
    attend = lambda q, k, v: FlashAttention.apply(q, k, v, causal, window, chunk,
                                                  cfg.attn_accum_bf16)
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        return local_heads(q, k, v, attend)
    return attend(q, k, v)
