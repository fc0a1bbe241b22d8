"""ctypes binding of the Hopper flash-attention kernels, forward and backward.

The kernels (``csrc/flash_attention.cu``) replace the TPU kernel
``repro/kernels/flash_attention/kernel.py::_attn_kernel``.  They read
(B, S, H, dh) tensors in place through their strides, so no transpose or
padding pass runs in device memory first.  bf16 inputs that TMA can
describe (``tma_path``) go to the TMA / wgmma kernel, other bf16 inputs to
the mma.sync kernel, fp32 inputs to the CUDA-core kernel.  ``launches``
counts every launch; each path also counts its own.

``accum_chunk`` > 0 asks for the reference's ``attn_accum_bf16`` mode
(``repro/models/layers.py::chunked_attention`` with ``accum_bf16``): P.V
and the output accumulator in bf16 over KV chunks of ``accum_chunk`` rows,
m and l in fp32.  The mma.sync and fp32 kernels compute it; the TMA kernel
accumulates in fp32 only, so such calls go to the mma.sync kernel whatever
``tma_path`` says.  It is a numerics mode, not a speed path.

``with_lse`` runs the TMA kernel's instance that also writes each row's
log-sum-exp, in base 2 of the scaled scores, for ``flash_attention_bwd``:
the backward's three kernels (``attn_bwd_prep``, ``attn_bwd_main``,
``attn_bwd_dq``) for inputs the TMA kernel takes (``tma_path``) with fp32
accumulation.  ``bwd_launches`` counts the backward's main-kernel launches.
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
#: the backward kernel's launches (attn_bwd_main, one a backward; the prep
#: and dQ passes launch beside it), counted apart from the forward's
bwd_launches = 0

#: the ``accum_chunk`` mode's cases on the card (chip_smoke.py's kernel check
#: and tests/test_torch_gpu.py): B, Sq, Skv, H, KV, dh, causal, window and
#: the KV chunk; dh 64 / 120 / 128, causal, windowed and non-causal, chunks
#: of 256 and 1024 rows, chunks of 100 rows, whose ends fall inside the
#: kernels' 64-key tiles and 16-key k-steps, and the served h2o-danube-3-4b
#: 4 x 512 prefill's shape with its chunk, min(attn_chunk, Skv) = Skv: one
#: chunk, no fold inside the loop and one at the end, so the accumulator is
#: rounded to bf16 once before the output is
ACC_CASES = [((2, 512, 512, 8, 2, 64, True, None), 256),
             ((1, 1024, 1024, 8, 2, 120, True, 300), 256),
             ((2, 700, 700, 4, 4, 64, False, None), 256),
             ((1, 2048, 2048, 8, 2, 128, True, None), 1024),
             ((1, 1500, 1500, 16, 16, 64, False, None), 1024),
             ((1, 1300, 1300, 8, 2, 120, True, 1100), 1024),
             ((2, 333, 333, 4, 2, 64, True, None), 100),
             ((4, 512, 512, 32, 8, 120, True, 4096), 512)]
#: against the plain chunked form with accum_bf16 (ref.chunked_attention):
#: |got - plain| <= ACC_TOL * (|plain| + the row's mean |plain|).  Not
#: bit-equal: the kernel's row max moves per 64-key tile, not per chunk, so
#: it rounds P to bf16 at other scales.  A CPU mirror of the kernel's
#: algebra read at most 0.024 of that scale on such cases.
ACC_TOL = 2.0 ** -4
#: ... and against fp32 truth (ref.attention_ref on the same inputs): the
#: mean error over the row's mean |truth| is the plain form's within this
#: factor either way.  On an H100 the kernel read 0.984-0.997x on these
#: cases; the fp32-accumulating kernel on the same inputs 0.60-0.82x on
#: bf16 inputs (0.82x with one chunk) and below 0.001x on fp32 ones, and
#: must land outside it.
ACC_MEAN_RATIO = 1.1

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p]
#: C entry point -> its argument types (the mma.sync / fp32 one takes is_bf16,
#: the TMA one lse and its padded length)
_SIGNATURES = {"repro_flash_attention_fwd_tma": (_ARGS[:-2] + [ctypes.c_void_p, ctypes.c_int]
                                                 + _ARGS[-2:]),
               "repro_flash_attention_fwd": (_ARGS[:4] + [ctypes.c_int]
                                             + _ARGS[4:-2] + [ctypes.c_int] + _ARGS[-2:]),
               "repro_flash_attention_bwd": ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
                   ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3 + [
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p])}
#: rows of the padded (B, H, Sp) statistics: Sp is Sq rounded up to this (the
#: forward's q tile)
LSE_ROWS = 128
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


def flash_attention_fwd(q, k, v, *, causal: bool, window: int | None, accum_chunk: int = 0,
                        with_lse: bool = False):
    """q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh) CUDA tensors of one dtype
    (float32 or bfloat16) with unit stride on dh -> (B, Sq, H, dh).
    ``accum_chunk`` > 0: P.V and the accumulator in bf16 over KV chunks of
    that many rows (the mma.sync or fp32 kernel); 0: fp32 accumulation.
    ``with_lse`` (TMA-path inputs only): returns (o, lse), lse a
    (B, H, Sq) fp32 view, row stride Sq rounded up to ``LSE_ROWS``, of each
    row's log2-sum-exp2 of its scaled scores (natural lse x log2 e; -inf
    where no key is allowed)."""
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
    if accum_chunk < 0:
        raise ValueError(f"flash_attention_fwd: accum_chunk {accum_chunk} < 0")
    o = q.new_empty((B, Sq, H, dh))
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    strides = (ctypes.c_longlong * 12)(*qs[:3], *ks[:3], *vs[:3], *o.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    # the C entry point makes q's device current for the launch
    dev = q.device.index
    tail = (B, Sq, Skv, H, KV, dh, strides, int(causal),
            -1 if window is None else int(window), 1.0 / math.sqrt(dh), dev,
            torch._C._cuda_getCurrentRawStream(dev))
    tma = not accum_chunk and _tma_ok(q.dtype, (q.shape, k.shape, v.shape), (qs, ks, vs), ptrs)
    if with_lse and not tma:
        raise ValueError("flash_attention_fwd: with_lse needs inputs the TMA kernel takes "
                         "(bf16, TMA-describable, accum_chunk 0)")
    lse = None
    if with_lse:
        sp = -(-Sq // LSE_ROWS) * LSE_ROWS
        lse = torch.empty((B, H, sp), device=q.device, dtype=torch.float32)
    if tma:
        err = _fn("repro_flash_attention_fwd_tma")(
            *ptrs, *tail[:-2], None if lse is None else lse.data_ptr(),
            0 if lse is None else lse.shape[2], *tail[-2:])
    else:
        err = _fn("repro_flash_attention_fwd")(*ptrs, int(q.dtype == torch.bfloat16),
                                               *tail[:-2], int(accum_chunk), *tail[-2:])
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
    return o if lse is None else (o, lse[:, :, :Sq])


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, window: int | None):
    """The gradients (dq, dk, dv) of ``flash_attention_fwd`` on inputs
    ``tma_path`` takes, from its output ``o`` and ``lse`` (``with_lse``) and
    the output's gradient ``do``; bf16, dq in q's shape, dk and dv in k's,
    all contiguous.  dq's fp32 accumulator takes atomic adds, so its last
    bits may differ from run to run."""
    global bwd_launches
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if not (o.shape == do.shape == q.shape and o.dtype == do.dtype == torch.bfloat16):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype}, do "
                         f"{tuple(do.shape)} {do.dtype}, q {tuple(q.shape)}")
    sp = lse.stride(1)
    if lse.dtype != torch.float32 or lse.shape != (B, H, Sq) or lse.stride() != (H * sp, sp, 1) \
            or sp % LSE_ROWS:
        raise ValueError("flash_attention_bwd: lse must be flash_attention_fwd's (with_lse)")
    if not tma_path(q, k, v):
        raise ValueError("flash_attention_bwd: q, k, v must be inputs the TMA kernel takes")
    if not _tma_ok(do.dtype, [do.shape], [do.stride()], [do.data_ptr()]):
        do = do.contiguous()
    if o.stride(3) != 1 or do.stride(3) != 1 or o.data_ptr() % 4:
        raise ValueError("flash_attention_bwd: o and do need unit stride on dh")
    dev = q.device
    dd = torch.empty((B, H, sp), device=dev, dtype=torch.float32)
    acc = torch.empty((B, H, sp, 64 if dh <= 64 else 128), device=dev, dtype=torch.float32)
    dq = torch.empty((B, Sq, H, dh), device=dev, dtype=q.dtype)
    dk = torch.empty((B, Skv, KV, dh), device=dev, dtype=q.dtype)
    dv = torch.empty_like(dk)
    strides = (ctypes.c_longlong * 18)(*(st for t in (q, k, v, o, do, dq) for st in t.stride()[:3]))
    idx = dev.index
    err = _fn("repro_flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dd.data_ptr(), acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, Skv, H, KV, dh, strides, sp, int(causal), -1 if window is None else int(window),
        1.0 / math.sqrt(dh), idx, torch._C._cuda_getCurrentRawStream(idx))
    if err:
        raise RuntimeError(f"flash attention backward kernel launch failed: error {err}")
    bwd_launches += 1
    return dq, dk, dv
