"""ctypes binding of the Hopper lanesum32 checksum kernel.

The kernel (``csrc/checksum.cu``) replaces the TPU kernel
``repro/kernels/checksum/kernel.py::_checksum_kernel``.  It reads a
contiguous tensor's bytes in place, through its data pointer (storage
offset included), and adds the tensor's (a, b) into a 2-word slot of an
int32 tensor that the caller has zeroed.  It launches on the current
stream and does not synchronise.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

SOURCE = "checksum/csrc/checksum.cu"

#: launches of the kernel since the last reset; only a launch adds to it
launches = 0


def _fn():
    fn = _build.load(SOURCE).repro_lanesum32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lanesum32_into(x: torch.Tensor, out: torch.Tensor) -> None:
    """Adds the lanesum32 (a, b) of the row-major bytes of the contiguous
    CUDA tensor ``x`` into ``out``, a zeroed int32 CUDA tensor of 2
    elements (a row of a larger buffer is fine) on ``x``'s device."""
    global launches
    if not x.is_cuda:
        raise ValueError("lanesum32_into: x must be a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("lanesum32_into: x must be contiguous")
    if (out.device != x.device or out.dtype != torch.int32 or out.numel() != 2
            or not out.is_contiguous()):
        raise ValueError(f"lanesum32_into: out must be 2 contiguous int32 on {x.device}, "
                         f"got {tuple(out.shape)} {out.dtype} on {out.device}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(x.data_ptr(), x.numel() * x.element_size(), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"lanesum32 kernel launch failed: CUDA error {err}")
    launches += 1
