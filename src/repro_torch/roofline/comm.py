"""Collective bytes of an eager sharded run, the counterpart of
``repro/roofline/hlo.py``.

The reference parses the collectives out of the compiled per-device HLO
text.  PyTorch compiles nothing: DTensor issues each collective as it
redistributes, as a ``c10d_functional`` op on the rank's local tensor.
``CollectiveCounter`` is a dispatch mode that sees those ops and keeps
the reference's record, ``{"total", "by_op", "count"}``, in bytes per
rank under the reference's conventions (``hlo.py:4-16``):

  all-reduce          bytes = out
  all-gather          bytes = out        (the gathered buffer)
  reduce-scatter      bytes = out * G    (G = the group's size)
  all-to-all          bytes = out
  collective-permute  bytes = out

Only ops on plain tensors are counted (``local_dispatch``).  An op on a
``DTensor`` is handed back to DTensor, which runs it on the local tensors
and issues the collectives it needs; those reach the mode again as plain
ops.  So every count is of one rank's local shapes, as the reference's
post-SPMD HLO is.

A process group on CPU tensors (gloo, or the fake group of the dry run)
has no all-to-all, and DTensor there falls back to an all-gather and a
chunk (``shard_dim_alltoall`` warns when it does).  That all-gather is
counted as the all-to-all DTensor asked for: its bytes are the chunk's,
the gathered buffer over G.
"""

from __future__ import annotations

import sys
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

#: schema name -> (the reference's name, whether its bytes are out x G)
_COLLECTIVES = {
    "_c10d_functional::all_reduce": ("all-reduce", False),
    "_c10d_functional::all_reduce_": ("all-reduce", False),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", False),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", False),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", True),
    "_c10d_functional::all_to_all_single": ("all-to-all", False),
    "_dtensor::shard_dim_alltoall": ("all-to-all", False),
}


def _group_size(func, args) -> int:
    """G of an all-gather / reduce-scatter: the ``group_size`` argument."""
    names = [a.name for a in func._schema.arguments]
    return int(args[names.index("group_size")])


def _in_alltoall_fallback(depth: int = 32) -> bool:
    """Whether the caller is DTensor's all-gather fallback for an
    all-to-all (``shard_dim_alltoall`` on a CPU process group)."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def local_dispatch(func, types, args, kwargs):
    """(counted, out) of one dispatch under a counting mode.  An op on a
    ``DTensor`` is handed back to DTensor (``NotImplemented``, not counted):
    it runs the op on the local tensors, which reach the mode again.  Ops
    on or making other tensor subclasses (the ``FakeTensor``s of DTensor's
    own shape propagation, at global shapes) run uncounted.  Only ops on
    and to plain tensors count."""
    if any(issubclass(t, DTensor) for t in types):
        return False, NotImplemented
    out = func(*args, **(kwargs or {}))
    outs = out if isinstance(out, (tuple, list)) else (out,)
    plain = all(t is torch.Tensor for t in types) and all(
        type(o) is torch.Tensor for o in outs if isinstance(o, torch.Tensor))
    return plain, out


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives issued while it is active; ``record()`` gives
    the reference's ``{"total", "by_op", "count"}``."""

    def __init__(self):
        super().__init__()
        self.by_op: dict[str, int] = defaultdict(int)
        self.count: dict[str, int] = defaultdict(int)

    def record(self) -> dict:
        return {"total": int(sum(self.by_op.values())),
                "by_op": {k: int(v) for k, v in self.by_op.items()},
                "count": dict(self.count)}

    def collective(self, func, args, out) -> bool:
        """Counts ``func`` if it is a collective; returns whether it was."""
        entry = _COLLECTIVES.get(func._schema.name)
        if entry is None:
            return False
        op, times_g = entry
        nbytes = out.numel() * out.element_size()
        if op == "all-gather" and _in_alltoall_fallback():
            op, nbytes = "all-to-all", nbytes // _group_size(func, args)
        elif times_g:
            nbytes *= _group_size(func, args)
        self.by_op[op] += nbytes
        self.count[op] += 1
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        counted, out = local_dispatch(func, types, args, kwargs)
        if counted:
            self.collective(func, args, out)
        return out
