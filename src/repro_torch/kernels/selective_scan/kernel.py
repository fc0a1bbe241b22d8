"""ctypes binding of the Hopper Mamba-1 selective-scan kernel
(``csrc/selective_scan.cu``).

The kernel reads u, dt, B and C once and forms each step's decays
``exp(dt A)`` and inputs ``dt B u`` in registers: no (B, T, D, N) tensor
exists.  It takes contiguous rows, D a multiple of 32 and N = 16 (the
published Mamba-1 state); the wrapper copies an operand that is not
contiguous or not 16-byte aligned, and raises on any other shape.  It
launches on the current stream and does not synchronise.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

SOURCE = "selective_scan/csrc/selective_scan.cu"
#: the state size and the channel tile the kernel is built for
N_STATE, CHANNELS = 16, 32

#: launches of the kernel since the last reset; only a launch adds to it
launches = 0

ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_bound = None


def _fn():
    """The C entry point, built, loaded and typed on first use."""
    global _bound
    if _bound is None:
        fn = _build.load(SOURCE).repro_selective_scan_fwd
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def _dense(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous and 16-byte aligned (a copy if not)."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def selective_scan_fwd(u, dt, A, B, C, D=None, s0=None):
    """u: (Bt, T, Dc) float32 or bfloat16; dt: (Bt, T, Dc), read as float32;
    A: (Dc, N) float32; B, C: (Bt, T, N), read in u's dtype; D: (Dc,) or
    None; s0: (Bt, Dc, N) or None; all on one CUDA device.  Returns (y
    (Bt, T, Dc) in u's dtype, final state (Bt, Dc, N) float32)."""
    global launches
    dev = u.device
    if not u.is_cuda or any(t.device != dev for t in (dt, A, B, C, D, s0) if t is not None):
        raise ValueError("selective_scan_fwd: all tensors must be on one CUDA device")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"selective_scan_fwd: u is {u.dtype}; want float32 or bfloat16")
    Bt, T, Dc = u.shape
    N = A.shape[-1]
    if (tuple(dt.shape) != (Bt, T, Dc) or tuple(A.shape) != (Dc, N)
            or tuple(B.shape) != (Bt, T, N) or tuple(C.shape) != (Bt, T, N)
            or (D is not None and tuple(D.shape) != (Dc,))
            or (s0 is not None and tuple(s0.shape) != (Bt, Dc, N))):
        raise ValueError(f"selective_scan_fwd: shapes u {tuple(u.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    if N != N_STATE or Dc % CHANNELS:
        raise ValueError(f"selective_scan_fwd: needs N == {N_STATE} and D % {CHANNELS} == 0, "
                         f"got N {N}, D {Dc}")
    u, B, C = (_dense(t, u.dtype) for t in (u, B, C))
    dt, A = _dense(dt, torch.float32), _dense(A, torch.float32)
    D = None if D is None else _dense(D, torch.float32)
    s0 = None if s0 is None else _dense(s0, torch.float32)
    y = torch.empty((Bt, T, Dc), dtype=u.dtype, device=dev)
    s_fin = torch.empty((Bt, Dc, N), dtype=torch.float32, device=dev)
    if Bt * Dc == 0:
        return y, s_fin
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                    None if D is None else D.data_ptr(), None if s0 is None else s0.data_ptr(),
                    y.data_ptr(), s_fin.data_ptr(), int(u.dtype == torch.bfloat16),
                    Bt, T, Dc, N, stream)
    if err:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, s_fin
