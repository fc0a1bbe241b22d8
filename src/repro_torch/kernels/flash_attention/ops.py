"""Device dispatch for the flash-attention forward.

``flash_attention`` takes (B, S, H, dh) tensors as the reference's
``repro/kernels/flash_attention/ops.py::flash_attention`` does.  A CUDA
tensor goes to the Hopper kernel (``kernel.py``), a CPU tensor to the
plain chunked version (``ref.py``).  There is no fallback: a kernel that
fails to build or launch raises.

``flash_attention_auto`` is what the model layer calls.  Unlike the
reference, where ``cfg.attn_impl`` picks Pallas or chunked jnp, the
device picks the path; ``cfg`` only sizes the CPU path's KV chunks.
"""

from __future__ import annotations

from . import kernel
from .ref import chunked_attention

#: KV chunk of the CPU path of ``flash_attention`` (the TPU kernel's block)
CPU_CHUNK = 128


def _dispatch(q, k, v, *, causal, window, chunk):
    if q.device.type == "cuda":
        return kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=chunk)
    raise ValueError(f"flash_attention: no path for device {q.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh) -> (B, Sq, H, dh)."""
    return _dispatch(q, k, v, causal=causal, window=window, chunk=CPU_CHUNK)


def flash_attention_auto(q, k, v, *, causal, window, cfg):
    """Model-layer attention: the kernel on CUDA, and on the CPU the
    reference's default chunked path with its ``cfg.attn_chunk``."""
    return _dispatch(q, k, v, causal=causal, window=window,
                     chunk=min(cfg.attn_chunk, k.shape[1]))
