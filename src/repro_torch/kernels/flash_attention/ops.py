"""Device dispatch for flash attention, with a gradient.

``flash_attention`` takes (B, S, H, dh) tensors as the reference's
``repro/kernels/flash_attention/ops.py::flash_attention`` does.  A CUDA
tensor goes to the Hopper kernel (``kernel.py``), a CPU tensor to the
plain chunked version (``ref.py``).  There is no fallback: a kernel that
fails to build or launch raises.

``flash_attention_auto`` is what the model layer calls.  Unlike the
reference, where ``cfg.attn_impl`` picks Pallas or chunked jnp, the
device picks the path; ``cfg`` sizes the KV chunks of the plain version,
and ``cfg.attn_accum_bf16`` takes its P.V and accumulator in bf16 as the
reference's chunked path does.  The Hopper kernel accumulates in fp32
only, so on CUDA ``attn_accum_bf16`` raises rather than run fp32.

Both run through ``FlashAttention``, a ``torch.autograd.Function``.  Its
forward is the dispatch above.  The reference has no backward kernel: it
trains through ``jax.grad`` of ``chunked_attention``.  So the backward
here recomputes ``chunked_attention`` under autograd from the saved q, k,
v and backpropagates through it, on either device; it launches no kernel.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import chunked_attention

#: KV chunk of the CPU path of ``flash_attention`` (the TPU kernel's block)
CPU_CHUNK = 128


def _dispatch(q, k, v, *, causal, window, chunk, accum_bf16=False):
    if accum_bf16 and q.device.type != "cpu":
        raise NotImplementedError(
            "flash_attention: attn_accum_bf16 has no Hopper kernel; the kernel "
            "accumulates P.V in fp32")
    if q.device.type == "cuda":
        return kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=chunk, accum_bf16=accum_bf16)
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
        with torch.profiler.record_function("flash_attention/plain_backward"):
            with torch.enable_grad():
                q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
                o = chunked_attention(q, k, v, **ctx.attn)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh) -> (B, Sq, H, dh)."""
    return FlashAttention.apply(q, k, v, causal, window, CPU_CHUNK)


def flash_attention_auto(q, k, v, *, causal, window, cfg):
    """Model-layer attention: the kernel on CUDA, and on the CPU the
    reference's default chunked path with its ``cfg.attn_chunk`` and
    ``cfg.attn_accum_bf16``."""
    return FlashAttention.apply(q, k, v, causal, window,
                                min(cfg.attn_chunk, k.shape[1]), cfg.attn_accum_bf16)
