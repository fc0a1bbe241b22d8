"""ctypes binding of the Hopper flash-attention forward kernel.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::_attn_kernel``.  It reads
(B, S, H, dh) tensors in place through their strides, so no transpose or
padding pass runs in device memory first.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

SOURCE = "flash_attention/csrc/flash_attention.cu"
MAX_HEAD_DIM = 128

#: launches of the kernel since the last reset; only a launch adds to it
launches = 0


def _fn():
    fn = _build.load(SOURCE).repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, *, causal: bool, window: int | None):
    """q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh) CUDA tensors of one dtype
    (float32 or bfloat16) with unit stride on dh -> (B, Sq, H, dh)."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd: q, k, v must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention_fwd: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want one of float32, bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or H % KV or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} vs kv "
                         f"{tuple(k.shape)} (need H % KV == 0, dh <= 128)")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_fwd: head_dim must be contiguous")
    o = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, o)
                                         for i in range(3)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    int(q.dtype == torch.bfloat16), B, Sq, Skv, H, KV, dh,
                    strides, int(causal), -1 if window is None else int(window),
                    1.0 / math.sqrt(dh), stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    launches += 1
    return o
