"""ctypes binding of the Hopper flash-attention forward kernels.

The kernels (``csrc/flash_attention.cu``) replace the TPU kernel
``repro/kernels/flash_attention/kernel.py::_attn_kernel``.  They read
(B, S, H, dh) tensors in place through their strides, so no transpose or
padding pass runs in device memory first.  bf16 inputs that TMA can
describe (``tma_path``) go to the TMA / wgmma kernel, other bf16 inputs to
the mma.sync kernel, fp32 inputs to the CUDA-core kernel.  ``launches``
counts every launch; each path also counts its own.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

SOURCE = "flash_attention/csrc/flash_attention.cu"
MAX_HEAD_DIM = 128

#: launches since the last reset; only a launch adds to a count.
#: ``launches``: every launch, on any path
launches = 0
#: of those, the bf16 TMA / wgmma kernel's, the path of every shipped config
tma_launches = 0
#: ... the bf16 mma.sync kernel's, for inputs ``tma_path`` refuses
sync_launches = 0
#: ... the fp32 kernel's
f32_launches = 0

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p]
#: C entry point -> its argument types (the mma.sync / fp32 one takes is_bf16)
_SIGNATURES = {"repro_flash_attention_fwd_tma": _ARGS,
               "repro_flash_attention_fwd": _ARGS[:4] + [ctypes.c_int] + _ARGS[4:]}
_bound: dict = {}
_variant = None  # a library built from another version of SOURCE (load_variant)


def load_variant(lib: ctypes.CDLL | None) -> None:
    """Makes the wrapper launch the entry points of ``lib``, a library built
    from a changed copy of SOURCE (scripts/flash_ablation_torch.py times
    such copies), or those of SOURCE again when ``lib`` is None."""
    global _variant
    _variant = lib
    _bound.clear()


def _fn(name: str):
    """The C entry point ``name``, built, loaded and typed on first use."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.load(SOURCE) if _variant is None else _variant, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def tma_path(q, k, v) -> bool:
    """True if the TMA / wgmma kernel takes these (B, S, H, dh) tensors: bf16,
    dh a multiple of 8, every data pointer 16-byte aligned, and every batch,
    sequence and head stride of a dimension longer than 1 a positive multiple
    of 8 elements (16 bytes), as a TMA tensor map needs.  A function of
    dtypes, shapes, strides and pointers alone."""
    ts = (q, k, v)
    return _tma_ok(q.dtype, [t.shape for t in ts], [t.stride() for t in ts],
                   [t.data_ptr() for t in ts])


def _tma_ok(dtype, shapes, strides, ptrs) -> bool:
    if dtype != torch.bfloat16 or shapes[0][3] % 8:
        return False
    for shape, stride, ptr in zip(shapes, strides, ptrs):
        if ptr % 16:
            return False
        for n, st in zip(shape[:3], stride[:3]):
            if n != 1 and (st <= 0 or st % 8):
                return False
    return True


def flash_attention_fwd(q, k, v, *, causal: bool, window: int | None):
    """q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh) CUDA tensors of one dtype
    (float32 or bfloat16) with unit stride on dh -> (B, Sq, H, dh)."""
    global launches, tma_launches, sync_launches, f32_launches
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
    o = q.new_empty((B, Sq, H, dh))
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    strides = (ctypes.c_longlong * 12)(*qs[:3], *ks[:3], *vs[:3], *o.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    # the C entry point makes q's device current for the launch
    dev = q.device.index
    tail = (B, Sq, Skv, H, KV, dh, strides, int(causal),
            -1 if window is None else int(window), 1.0 / math.sqrt(dh), dev,
            torch._C._cuda_getCurrentRawStream(dev))
    tma = _tma_ok(q.dtype, (q.shape, k.shape, v.shape), (qs, ks, vs), ptrs)
    if tma:
        err = _fn("repro_flash_attention_fwd_tma")(*ptrs, *tail)
    else:
        err = _fn("repro_flash_attention_fwd")(*ptrs, int(q.dtype == torch.bfloat16), *tail)
    if err:
        path = "TMA" if tma else "mma.sync" if q.dtype == torch.bfloat16 else "fp32"
        raise RuntimeError(f"flash attention kernel launch failed ({path} path): error {err}")
    launches += 1
    if tma:
        tma_launches += 1
    elif q.dtype == torch.bfloat16:
        sync_launches += 1
    else:
        f32_launches += 1
    return o
