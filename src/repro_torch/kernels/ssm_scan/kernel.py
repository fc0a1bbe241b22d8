"""ctypes binding of the Hopper gated-linear-recurrence kernel.

The kernel (``csrc/ssm_scan.cu``, the chunked recurrence) replaces the TPU
kernel ``repro/kernels/ssm_scan/kernel.py::_ssm_kernel``.  It reads q, k
and g in place through their (b, t, h) strides, with unit stride over K,
and a g of one log decay per (b, t, h) (mamba's (B, T, H, 1), or a
(B, T, H, K) that broadcasts one over K) as such: mamba's q and k, one row
per (b, t) expanded over the heads, and its g go in without a copy.  v is
read contiguous.  The kernel masks a ragged T itself, so no padding pass
runs in device memory.  It launches on the
current stream and does not synchronise.  The entry point is typed once,
on first use; ``load_variant`` points the wrapper at a library built from
another version of the source (``scripts/ssm_scan_torch.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

SOURCE = "ssm_scan/csrc/ssm_scan.cu"
MAX_K = 128

#: launches of the kernel since the last reset; only a launch adds to it
launches = 0

ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_bound = None     # the typed entry point, once loaded
_variant = None   # a library built from another version of SOURCE (load_variant)


def load_variant(path) -> None:
    """Makes the wrapper launch the entry point of the shared library at
    ``path``, built from a changed copy of SOURCE, or that of SOURCE again
    when ``path`` is None."""
    global _bound, _variant
    _variant = None if path is None else ctypes.CDLL(str(path))
    _bound = None


def _fn():
    """The C entry point, built, loaded and typed on first use."""
    global _bound
    if _bound is None:
        fn = (_build.load(SOURCE) if _variant is None else _variant).repro_ssm_scan_fwd
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def _strides(t: torch.Tensor) -> list[int]:
    """The (b, t, h) element strides of a 4-d ``t``; 0 on an axis of one
    entry, which is never stepped along."""
    return [0 if n == 1 else st for n, st in zip(t.shape[:3], t.stride()[:3])]


def _vec(t: torch.Tensor, row: int) -> int:
    """1 if every row of ``row`` elements of ``t`` (its last axis, unit
    stride) starts on a 16-byte boundary and fills whole 16-byte pieces."""
    size = t.element_size()
    return int(t.data_ptr() % 16 == 0 and (row * size) % 16 == 0
               and all(st * size % 16 == 0 for st in _strides(t)))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its last axis has unit stride (or one entry),
    else a contiguous copy."""
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def ssm_scan_fwd(q, k, v, g, u=None, s0=None):
    """q, k: (B, T, H, K), any strides with a unit one over K (a head stride
    of 0 too); g: (B, T, H, K) or (B, T, H, 1), one log decay per (b, t, h)
    for every k; v: (B, T, H, V); u: (H, K) or None; s0: (B, H, K, V) or
    None; all on one CUDA device.  q, k, v share one dtype (float32 or
    bfloat16); g, u and s0 are read as float32 (a g of another dtype is
    converted, a copy).  Returns (y (B, T, H, V) in q's dtype, s_fin
    (B, H, K, V) float32)."""
    global launches
    dev = q.device
    if not q.is_cuda or any(t.device != dev for t in (k, v, g, u, s0) if t is not None):
        raise ValueError("ssm_scan_fwd: all tensors must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"ssm_scan_fwd: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        "want one of float32, bfloat16")
    if (q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or g.dim() != 4
            or tuple(g.shape[:3]) != tuple(q.shape[:3]) or g.shape[3] not in (1, q.shape[3])):
        raise ValueError(f"ssm_scan_fwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, g {tuple(g.shape)}")
    B, T, H, K = q.shape
    V = v.shape[-1]
    if tuple(v.shape[:3]) != (B, T, H) or not 1 <= K <= MAX_K or V < 1:
        raise ValueError(f"ssm_scan_fwd: v {tuple(v.shape)} vs q {tuple(q.shape)} "
                         f"(need K <= {MAX_K})")
    if u is not None and tuple(u.shape) != (H, K):
        raise ValueError(f"ssm_scan_fwd: u {tuple(u.shape)}, want {(H, K)}")
    if s0 is not None and tuple(s0.shape) != (B, H, K, V):
        raise ValueError(f"ssm_scan_fwd: initial state {tuple(s0.shape)}, want {(B, H, K, V)}")
    q, k = _rows(q), _rows(k)
    v = v.contiguous()
    g = g.float()
    g_head = int(g.shape[3] == 1 or g.stride(3) == 0)  # one decay for every k
    g = g[..., :1] if g_head else _rows(g)
    u = None if u is None else u.float().contiguous()
    s0 = None if s0 is None else s0.float().contiguous()
    y = torch.empty((B, T, H, V), dtype=q.dtype, device=dev)
    s_fin = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    if B * H == 0:
        return y, s_fin
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                    None if u is None else u.data_ptr(),
                    None if s0 is None else s0.data_ptr(),
                    y.data_ptr(), s_fin.data_ptr(), int(q.dtype == torch.bfloat16),
                    B, T, H, K, V, *_strides(q), *_strides(k), *_strides(g), g_head,
                    _vec(q, K) & _vec(k, K), _vec(g, g.shape[3]), _vec(v, V), stream)
    if err:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, s_fin
