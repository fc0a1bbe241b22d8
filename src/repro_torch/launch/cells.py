"""Cell assembly, ported from ``repro/launch/cells.py``: for one
(architecture x input shape x mesh) cell, the step function, the
shardings of its inputs and outputs, and its abstract inputs.

The reference returns ``NamedSharding``s for ``jax.jit`` to lower.  Here
each is a ``Sharding`` (a mesh and a spec, whose ``placements`` are
DTensor's), and the step runs eagerly on ``DTensor``s: ``distribute_like``
places concrete inputs by a sharding tree, the step runs under the cell's
axis rules (``sharding.rules``: the model's ``logical_constraint`` calls
redistribute there) and leaves its outputs in the out shardings.  The
shardings need only the mesh's shape, so a cell's trees can be built on
an object with a ``.shape`` dict, as the reference tests' ``FakeMesh``;
running a step needs a ``DeviceMesh`` (``launch/mesh.py``).

``lower_cell`` is the dry run's entry (``launch/dryrun.py``).  The
reference jits, lowers and compiles the cell; PyTorch runs eagerly, so
here the cell's abstract inputs are placed as ``DTensor``s whose local
shards are ``meta`` tensors, and the step runs once on them under
``roofline.CostCounter``, which counts each rank's FLOPs, bytes and
collectives, and ``roofline.LiveBytes``, which keeps the peak of the
bytes it holds above its arguments (the temps of ``memory_analysis``).  On a fake process group of the production mesh's size
(256 or 512 ranks in one process) that is the reference's pod-scale dry
run without a device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import get_config
from ..models.common import SHAPES, ArchConfig, ShapeConfig
from ..models.convert import flatten, tree_map
from ..models.registry import build, decode_specs, prefill_batch_specs, train_batch_specs
from ..optim import OptimizerConfig
from ..roofline.analysis import CostCounter
from ..roofline.memory import LiveBytes
from ..runtime.steps import (abstract_train_state, make_prefill_step, make_serve_step,
                             make_train_step)
from ..sharding.rules import (P, AxisRules, axis_rules, batch_spec, mesh_shape,
                              param_specs, placements, production_rules)


@dataclass(frozen=True)
class Sharding:
    """The counterpart of ``NamedSharding``: a spec on a mesh."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _axes_dividing(mesh, names: tuple[str, ...], size: int):
    """Largest prefix-combination of mesh axes whose product divides
    ``size``; returns tuple (possibly empty)."""
    shape = mesh_shape(mesh)
    chosen = []
    prod = 1
    for n in names:
        if n in shape and size % (prod * shape[n]) == 0:
            chosen.append(n)
            prod *= shape[n]
    return tuple(chosen)


def _maybe(axes):
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


@dataclass
class Cell:
    arch_id: str
    shape_name: str
    cfg: ArchConfig
    shape: ShapeConfig
    rules: AxisRules
    step_fn: Any
    in_shardings: Any
    out_shardings: Any
    abstract_inputs: tuple
    kind: str  # train | prefill | decode
    abstract_outputs: tuple = ()  # the outputs' shapes and dtypes, on ``meta``


def _dp_axes(mesh):
    return tuple(n for n in ("pod", "data") if n in mesh_shape(mesh))


def make_rules(cfg: ArchConfig, shape: ShapeConfig, mesh) -> AxisRules:
    sizes = mesh_shape(mesh)
    dp_size = 1
    for n in _dp_axes(mesh):
        dp_size *= sizes[n]
    return production_rules("pod" in sizes,
                            batch_divisible=shape.global_batch % dp_size == 0,
                            mesh=mesh)


def batch_sharding_tree(specs: dict, mesh, rules: AxisRules):
    """Shardings of a train / prefill batch dict: the batch dim over the
    data axes that divide it."""
    def leaf(s):
        return Sharding(mesh, P(*batch_spec(s.shape[0], mesh), *[None] * (s.dim() - 1)))

    return tree_map(leaf, specs)


def cache_sharding_tree(cache_specs, cfg: ArchConfig, shape: ShapeConfig, mesh):
    """Per-leaf cache shardings: batch over data axes when divisible; KV
    heads over "model" when divisible, else the cache sequence dim;
    long-context (B=1) shards sequence over everything."""
    sizes = mesh_shape(mesh)
    dp = _dp_axes(mesh)
    B = shape.global_batch
    n_model = sizes.get("model", 1)

    def leaf_spec(name, s):
        dims = [None] * s.dim()
        batch_axes = _axes_dividing(mesh, dp, B)
        if name in ("attn_k", "attn_v", "cross_k", "cross_v"):
            # (nb, n, B, S, KV, dh)
            dims[2] = _maybe(batch_axes)
            if s.shape[4] % n_model == 0:  # prefer sharding KV heads on "model"
                dims[4] = "model"
                seq_axes = _axes_dividing(
                    mesh, tuple(a for a in dp if a not in batch_axes), s.shape[3])
            else:
                seq_pool = tuple(a for a in ("data", "model", "pod")
                                 if a in sizes and a not in batch_axes)
                seq_axes = _axes_dividing(mesh, seq_pool, s.shape[3])
            dims[3] = _maybe(seq_axes)
        elif name == "ssm":
            # (nb, n, B, H, K, V)
            dims[2] = _maybe(batch_axes)
            if s.shape[3] % n_model == 0:
                dims[3] = "model"
        elif name in ("conv", "shift_t", "shift_c"):
            dims[2] = _maybe(batch_axes)
            if s.shape[-1] % n_model == 0:
                dims[-1] = "model"
        return Sharding(mesh, P(*dims))

    return {name: leaf_spec(name, s) for name, s in cache_specs.items()}


def _param_shardings(params, mesh, rules):
    with axis_rules(rules):
        specs = param_specs(params)
    return tree_map(lambda _, s: Sharding(mesh, s), params, specs)


def state_sharding_tree(state_specs, mesh, rules: AxisRules):
    return {
        "params": _param_shardings(state_specs["params"], mesh, rules),
        "opt": {"m": _param_shardings(state_specs["opt"]["m"], mesh, rules),
                "v": _param_shardings(state_specs["opt"]["v"], mesh, rules),
                "step": Sharding(mesh, P())},
    }


def distribute_like(tree, shardings, mesh):
    """``tree``'s tensors as ``DTensor``s on ``mesh``, each in the
    placements of its ``Sharding`` in ``shardings`` (a tree of the same
    structure); rank 0's values are the ones kept."""
    return tree_map(lambda t, sh: distribute_tensor(t, mesh, sh.placements), tree, shardings)


def _settle(tree, shardings):
    """Each ``DTensor`` of ``tree`` in its sharding's placements, as ``jit``'s
    out_shardings leave a result."""
    def leaf(t, sh):
        if isinstance(t, DTensor):
            return t.redistribute(t.device_mesh, sh.placements)
        return t

    return tree_map(leaf, tree, shardings)


def build_cell(arch_id: str, shape: str | ShapeConfig, mesh, cfg: ArchConfig | None = None,
               opt_cfg: OptimizerConfig | None = None, pad_to: int | None = None) -> Cell:
    """The cell of ``arch_id`` at ``shape`` (a name in ``SHAPES`` or a
    ``ShapeConfig``: the tests run small ones) on ``mesh``.  The step runs
    on the mesh's device type; on a mesh given only by its shape the cell
    holds its shardings and abstract inputs, and its step is not run.
    ``pad_to`` sizes a prefill's KV caches for the decode cell of that
    ``seq_len`` (``make_prefill_step``'s)."""
    cfg = cfg or get_config(arch_id)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    rules = make_rules(cfg, shape, mesh)
    api = build(cfg, getattr(mesh, "device_type", "meta"))
    opt_cfg = opt_cfg or OptimizerConfig()
    repl = Sharding(mesh, P())

    def ruled(fn, grad=True):
        def step(*args):
            with axis_rules(rules), implicit_replication(), torch.set_grad_enabled(grad):
                return fn(*args)
        return step

    if shape.kind == "train":
        state_specs = abstract_train_state(api, opt_cfg)
        state_sh = state_sharding_tree(state_specs, mesh, rules)
        bspecs = train_batch_specs(cfg, shape)
        batch_sh = batch_sharding_tree(bspecs, mesh, rules)
        raw_step = make_train_step(api, opt_cfg)
        metric_sh = tree_map(lambda _: repl, _metric_specs())

        def train_step(state, batch):
            state, metrics = raw_step(state, batch)
            return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                           for k, v in metrics.items()}

        return Cell(arch_id, shape.name, cfg, shape, rules, ruled(train_step),
                    (state_sh, batch_sh), (state_sh, metric_sh),
                    (state_specs, bspecs), "train", (state_specs, _metric_specs()))

    pspecs = api.abstract_params()
    psh = _param_shardings(pspecs, mesh, rules)
    bsp = batch_spec(shape.global_batch, mesh)
    if shape.kind == "prefill":
        bspecs = prefill_batch_specs(cfg, shape)
        batch_sh = batch_sharding_tree(bspecs, mesh, rules)
        # a prefill over S tokens leaves the caches a decode cache of S holds
        seq = max(shape.seq_len, pad_to or 0)
        cache_specs = api.make_cache(shape.global_batch, seq, abstract=True)
        cache_sh = cache_sharding_tree(cache_specs, cfg, shape, mesh)
        vmodel = "model" if cfg.vocab_size % mesh_shape(mesh).get("model", 1) == 0 else None
        logits_sh = Sharding(mesh, P(*bsp, None, vmodel))
        raw_step = make_prefill_step(api, pad_to=pad_to)

        def prefill_step(params, batch):
            logits, cache = raw_step(params, batch)
            return _settle(logits, logits_sh), _settle(cache, cache_sh)

        logits_spec = torch.empty((shape.global_batch, 1, cfg.vocab_size), dtype=torch.float32,
                                  device="meta")
        return Cell(arch_id, shape.name, cfg, shape, rules, ruled(prefill_step, grad=False),
                    (psh, batch_sh), (logits_sh, cache_sh), (pspecs, bspecs), "prefill",
                    (logits_spec, cache_specs))

    token_spec, pos_spec, cache_specs = decode_specs(cfg, shape)
    cache_sh = cache_sharding_tree(cache_specs, cfg, shape, mesh)
    tok_sh = Sharding(mesh, P(*bsp, None))
    raw_step = make_serve_step(api, greedy=True)

    def decode_step(params, cache, token, pos):
        token, cache = raw_step(params, cache, token, pos)
        return _settle(token, tok_sh), _settle(cache, cache_sh)

    return Cell(arch_id, shape.name, cfg, shape, rules, ruled(decode_step, grad=False),
                (psh, cache_sh, tok_sh, repl), (tok_sh, cache_sh),
                (pspecs, cache_specs, token_spec, pos_spec), "decode",
                (token_spec, cache_specs))


def _metric_specs():
    f32 = torch.empty((), dtype=torch.float32, device="meta")
    return {"loss": f32, "xent": f32, "moe_aux": f32, "grad_norm": f32, "lr": f32}


def rank_bytes(tree, shardings) -> int:
    """Bytes one rank holds of ``tree``'s tensors in their shardings'
    placements: each dim cut over the mesh dims that shard it, rounded up
    (the largest shard of an uneven cut)."""
    total = 0
    for t, sh in zip(flatten(tree).values(), flatten(shardings).values()):
        dims = list(t.shape)
        for i, p in enumerate(sh.placements):
            if isinstance(p, Shard):
                dims[p.dim] = math.ceil(dims[p.dim] / sh.mesh.size(i))
        total += math.prod(dims) * t.element_size()
    return total


def place_abstract(tree, shardings, mesh):
    """``tree``'s ``meta`` tensors as ``DTensor``s on ``mesh`` in their
    shardings' placements, each holding its rank's local shard on ``meta``:
    no data and no collective, as the reference's abstract inputs to
    ``lower``."""
    def leaf(t, sh):
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, sh.placements)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), mesh,
                                  sh.placements, run_check=False, shape=t.shape,
                                  stride=t.stride())

    return tree_map(leaf, tree, shardings)


@dataclass
class MemoryAnalysis:
    """The counterpart of a compiled cell's ``memory_analysis()``, per rank:
    argument and output bytes from the cell's placements, and the temps,
    the peak live bytes above the arguments of a counted run of the step
    (``lower_cell``'s ``"temp"``), or ``None`` where none was counted."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int | None = None


def memory_analysis(cell: Cell, temp_bytes: float | None = None) -> MemoryAnalysis:
    """``cell``'s per-rank argument and output bytes, and ``temp_bytes`` as
    its temps: a counted run's peak above the arguments (``lower_cell``),
    extrapolated to the cell's depth by the dry run."""
    return MemoryAnalysis(rank_bytes(cell.abstract_inputs, cell.in_shardings),
                          rank_bytes(cell.abstract_outputs, cell.out_shardings),
                          None if temp_bytes is None else int(temp_bytes))


def lower_cell(cell: Cell, mesh) -> dict:
    """Places the cell's abstract inputs on ``mesh`` by its in-shardings and
    runs its step once under ``CostCounter`` and ``LiveBytes`` (the dry
    run's entry).  Returns one rank's ``CostCounter.record()`` with
    ``"temp"``, the peak bytes the step held above its arguments."""
    args = [place_abstract(t, sh, mesh) for t, sh in zip(cell.abstract_inputs, cell.in_shardings)]
    with CostCounter() as counter, LiveBytes() as live:
        cell.step_fn(*args)
    return {**counter.record(), "temp": live.peak}
