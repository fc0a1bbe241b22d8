"""Device dispatch for the lanesum32 checksum (paper §7 integrity).

``checksum_digest(x)`` is the digest of the row-major bytes of ``x``: the
bytes that ``x.contiguous().view(torch.uint8)`` holds and a checkpoint
writes.  A CUDA tensor goes to the Hopper kernel (``kernel.py``), a CPU
tensor to the plain PyTorch version (``ref.py``), any other device
raises.  There is no fallback: a kernel that fails to build or launch
raises.  ``checksum_digests`` digests many tensors of one device, one
kernel launch each, and reads all their sums back once.
Counterpart of ``repro/kernels/checksum/ops.py``.
"""

from __future__ import annotations

from typing import Iterable

import torch

from . import kernel
from .ref import digest_of, lanesum32_torch


def checksum_digests(xs: Iterable[torch.Tensor]) -> list[str]:
    """Digests of tensors that all lie on one device.  ``xs`` may be a
    generator: on CUDA each tensor's kernel is launched before the next
    tensor is made, so only one need exist at a time, and all (a, b)
    pairs are read back at the end, once."""
    sums, dev = [], None
    for x in xs:
        if dev is None:
            dev = x.device
            if dev.type not in ("cpu", "cuda"):
                raise ValueError(f"checksum_digest: no path for device {dev}")
        elif x.device != dev:
            raise ValueError("checksum_digests: tensors on more than one device")
        if dev.type == "cpu":
            sums.append(lanesum32_torch(x))
        else:
            out = torch.zeros(2, dtype=torch.int32, device=dev)
            kernel.lanesum32_into(x.contiguous(), out)
            sums.append(out)
    if sums and dev.type == "cuda":
        sums = torch.stack(sums).tolist()
    return [digest_of(a, b) for a, b in sums]


def checksum_digest(x: torch.Tensor) -> str:
    return checksum_digests([x])[0]
