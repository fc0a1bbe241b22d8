"""Peak live bytes of one eager run: the dry run's counterpart of the
temp bytes in XLA's ``memory_analysis()`` (``repro/launch/dryrun.py``).

XLA plans a compiled program's buffers and reports the temp bytes it
needs beside its arguments and outputs.  PyTorch runs eagerly and plans
nothing, so ``LiveBytes`` watches one run of the cell's step instead: a
dispatch mode that adds the bytes of each storage an op allocates, takes
them off when the storage is freed (a finalizer on the storage, whose
Python object lives exactly as long as the storage does), and keeps the
peak of the sum.  The storages alive before the run (the step's
arguments) are not counted, so the peak is the bytes the step needs above
its arguments: activations, the tensors autograd saves for the backward,
gradients, collective buffers and the outputs alive at that moment.

As ``roofline.comm.local_dispatch`` does for the counts, an op on a
``DTensor`` is handed back to DTensor, and the local ops it runs are the
ones counted, so the peak is one rank's.  On ``meta`` the bytes are
those of the shapes: no allocator rounding, no library workspaces, and
the forms that the dispatchers run there (the plain chunked attention
and scan) in place of the kernels.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .comm import local_dispatch


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages allocated while it is active and still
    alive (``live``), and their largest sum (``peak``)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held: set[int] = set()  # ids of the counted storages alive

    def _free(self, key: int, nbytes: int) -> None:
        self._held.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        counted, out = local_dispatch(func, types, args, kwargs)
        if not counted:
            return out
        # an output that shares an argument's storage (a view, an in-place
        # op) allocated nothing
        seen = {id(t.untyped_storage()) for t in (*args, *kwargs.values())
                if isinstance(t, torch.Tensor)}
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = id(storage)
            if key in seen or key in self._held:
                continue
            seen.add(key)
            nbytes = storage.nbytes()
            self._held.add(key)
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._free, key, nbytes)
        return out
