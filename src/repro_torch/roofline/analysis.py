"""Three-term roofline of a dry-run cell, after ``repro/roofline/analysis.py``.

    compute    = FLOPs / peak_FLOPs               (per chip, seconds)
    memory     = bytes / HBM_bw                   (per chip, seconds)
    collective = collective_bytes / link_bw       (per chip, seconds)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of the
compiled per-device program and collectives from its HLO.  PyTorch
compiles nothing, so the port counts one eager run of the cell's step on
``meta`` tensors instead (``launch/cells.py::lower_cell``), under
``CostCounter``, a dispatch mode that sees every aten op a rank runs on
its local tensors:

* ``flops``: ``torch.utils.flop_counter``'s formula for each op, at the
  local shapes, so per device, as XLA's are.  Its formulas cover matrix
  products, convolutions and attention; elementwise ops count 0, where
  XLA counts them.  Ops on ``DTensor``s are not
  counted at their global shapes: the mode hands them back to DTensor and
  counts the local ops DTensor runs for them (``comm.local_dispatch``), and
  the ops inside the kernels' ``local_map`` boundaries are local anyway.
* ``bytes``: the stand-in for XLA's "bytes accessed": the input and
  output bytes of every local aten op that is not a view, each op on its
  own.  Nothing is fused, so it is an upper estimate of the traffic;
  the record's ``note`` says so.
* ``coll``: the collectives, as ``comm.CollectiveCounter`` counts them.

The reference counts a ``lax.scan`` body once and extrapolates from 1-
and 2-block compiles; an eager run has no scan, but the dry run keeps
the same 1- and 2-block runs and ``extrapolate`` (full depth on a 512-rank
fake group would take hours).

MODEL_FLOPS (6*N*D dense / 6*N_active*D MoE; 2*N*D for inference)
measures how much of the counted compute is "useful".
"""

from __future__ import annotations

from collections import Counter
from dataclasses import asdict, dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .comm import CollectiveCounter, local_dispatch
from .hw import HW_V5E, Hardware


class CostCounter(CollectiveCounter):
    """Counts FLOPs, bytes and collectives of the local ops run while it
    is active (see the module docstring); ``record()`` gives
    ``cost_numbers``' input."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def record(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "coll": super().record()}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        counted, out = local_dispatch(func, types, args, kwargs)
        if not counted or self.collective(func, args, out) or func.is_view:
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        for t in (*args, *kwargs.values(), *(out if isinstance(out, (tuple, list)) else (out,))):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


class ProductCounter(TorchDispatchMode):
    """Counts the matrix products (``aten.mm``, ``aten.addmm``, ``aten.bmm``)
    dispatched while it is active, by op name (``ops``), and apart those
    dispatched while ``scope`` names one of ``scopes`` (``scoped``): the
    products ``remat="dots"`` saves (``mm``, ``addmm``) and recomputes
    (``bmm``).  The kernels are ctypes calls, never dispatched, so never
    counted."""

    PRODUCTS = ("mm", "addmm", "bmm")

    def __init__(self, scopes=()):
        super().__init__()
        self.ops = Counter()
        self.scope = None
        self.scoped = {name: Counter() for name in scopes}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        if name in self.PRODUCTS:
            self.ops[name] += 1
            if self.scope:
                self.scoped[self.scope][name] += 1
        return func(*args, **(kwargs or {}))


def cost_numbers(counted: dict) -> dict:
    """{'flops', 'bytes', 'coll': {...}} per device, from the record of one
    counted run (``CostCounter.record()``), and 'temp', the run's peak live
    bytes above its arguments, where the record has it
    (``launch.cells.lower_cell`` adds ``roofline.memory.LiveBytes``' peak)."""
    out = {"flops": float(counted["flops"]), "bytes": float(counted["bytes"]),
           "coll": counted["coll"]}
    if "temp" in counted:
        out["temp"] = float(counted["temp"])
    return out


def extrapolate(c1: dict, c2: dict, n_blocks: int) -> dict:
    """total = c1 + (n_blocks - 1) * max(c2 - c1, 0) elementwise.

    The peak live bytes ('temp') extrapolate the same way, though a peak
    is not a sum: in a train step it comes at the start of the backward,
    where every block's saved input (the block remat keeps one a block),
    its parameters' gradients so far and one block's recompute are alive,
    so each block adds its saved bytes once; in a prefill each block adds
    its KV cache.  tests/test_torch_memory.py holds the extrapolated peak
    to a full-depth count."""
    def lin(a, b):
        return a + (n_blocks - 1) * max(b - a, 0.0)

    by_op = {}
    ops = set(c1["coll"]["by_op"]) | set(c2["coll"]["by_op"])
    for op in ops:
        a = c1["coll"]["by_op"].get(op, 0)
        b = c2["coll"]["by_op"].get(op, 0)
        by_op[op] = int(lin(a, b))
    counts = {}
    for op in ops:
        a = c1["coll"]["count"].get(op, 0)
        b = c2["coll"]["count"].get(op, 0)
        counts[op] = int(lin(a, b))
    out = {
        "flops": lin(c1["flops"], c2["flops"]),
        "bytes": lin(c1["bytes"], c2["bytes"]),
        "coll": {"total": int(sum(by_op.values())), "by_op": by_op,
                 "count": counts},
    }
    if "temp" in c1 and "temp" in c2:
        out["temp"] = lin(c1["temp"], c2["temp"])
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_detail: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_global: float
    useful_ratio: float           # MODEL_FLOPS / (FLOPs * n_devices)
    peak_fraction: float          # useful-flops time / dominant term
    bytes_per_dev_argument: float = 0.0
    bytes_per_dev_temp: float | None = 0.0
    note: str = ""

    def to_dict(self):
        return asdict(self)


def _count_params(cfg) -> tuple[float, float]:
    """(total, active) parameter counts from the port's abstract tree on
    ``meta``."""
    from ..models.convert import flatten
    from ..models.registry import build
    total = active = 0.0
    for path, leaf in flatten(build(cfg, "meta").abstract_params()).items():
        n = float(leaf.numel())
        total += n
        if ("moe/wi" in path or "moe/wg" in path or "moe/wo" in path) \
                and cfg.moe is not None:
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    return total, active


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs for the whole (global) step."""
    total, active = _count_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    # decode: one token per sequence
    return 2.0 * active * shape.global_batch


def roofline_from_numbers(numbers: dict, *, arch: str, shape_name: str,
                          mesh_name: str, n_devices: int, cfg, shape,
                          memory_analysis=None, hw: Hardware = HW_V5E,
                          note: str = "") -> Roofline:
    """As the reference's; ``memory_analysis`` is any object with
    ``argument_size_in_bytes`` and ``temp_size_in_bytes``
    (``launch.cells.memory_analysis`` gives them, temps from the counted
    run's peak live bytes, or ``None`` where none was counted)."""
    flops = numbers["flops"]
    bytes_accessed = numbers["bytes"]
    coll = numbers["coll"]

    t_compute = flops / hw.peak_flops_bf16
    t_memory = bytes_accessed / hw.hbm_bw
    ici = hw.ici_bw_per_link * hw.ici_links
    t_coll = coll["total"] / ici
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)

    mf = model_flops(cfg, shape)
    useful = mf / max(flops * n_devices, 1.0)
    t_useful = mf / n_devices / hw.peak_flops_bf16
    peak_fraction = t_useful / max(max(terms.values()), 1e-30)

    r = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, n_devices=n_devices,
        hlo_flops_per_dev=flops, hlo_bytes_per_dev=bytes_accessed,
        coll_bytes_per_dev=float(coll["total"]), coll_detail=coll,
        t_compute=t_compute, t_memory=t_memory, t_collective=t_coll,
        bottleneck=bottleneck, model_flops_global=mf, useful_ratio=useful,
        peak_fraction=peak_fraction, note=note,
    )
    if memory_analysis is not None:
        r.bytes_per_dev_argument = float(memory_analysis.argument_size_in_bytes)
        temp = memory_analysis.temp_size_in_bytes
        r.bytes_per_dev_temp = None if temp is None else float(temp)
    return r


def roofline_terms(r: Roofline) -> str:
    return (f"{r.arch} x {r.shape} [{r.mesh}]: "
            f"compute {r.t_compute * 1e3:.1f} ms | "
            f"memory {r.t_memory * 1e3:.1f} ms | "
            f"collective {r.t_collective * 1e3:.1f} ms "
            f"-> {r.bottleneck}-bound; useful {r.useful_ratio:.2f}, "
            f"roofline fraction {r.peak_fraction:.2f}")
