"""Logical-axis sharding rules, ported from ``repro/sharding/rules.py``.

Model code annotates activations with *logical* axis names; a context
maps them to physical mesh axes per (mesh, arch, shape) cell, so the
same model runs unsharded, on a one-rank CUDA mesh, on a 2x2 test mesh
and (with a large enough process group) on the 16x16 single-pod and
2x16x16 multi-pod meshes.

Parameter shardings are derived from param-tree *path patterns*
(fnmatch) -> logical specs, resolved against the same rules: the ZeRO-3
+ TP layout of the reference.

The reference hands a ``PartitionSpec`` to XLA.  Here a spec is ``P``, a
tuple with the same normalisation (a one-axis tuple is the bare axis, an
empty one ``None``), so specs compare equal entry by entry with the
reference's.  ``placements`` turns a spec into DTensor placements, one
per mesh dim, and ``logical_constraint`` redistributes a ``DTensor`` to
them, where the reference calls ``with_sharding_constraint``.  PyTorch
runs eagerly, so that redistribution is the collective itself.
"""

from __future__ import annotations

import fnmatch
import math
import threading
from contextlib import contextmanager

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def _norm(axes):
    """An entry of a spec, normalised as ``PartitionSpec`` does: a tuple
    of one axis is that axis, an empty tuple is ``None``."""
    if isinstance(axes, (tuple, list)):
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else tuple(axes)
    return axes


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name or a tuple of names (``PartitionSpec``'s normalisation)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a torch ``DeviceMesh`` or of any object with
    a ``.shape`` dict (the reference tests' ``FakeMesh``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


class AxisRules:
    """Mapping logical axis name -> physical mesh axis (str, tuple or
    None).  Unknown logical names resolve to None (replicated).  When a
    mesh is attached, shardings that do not divide a dim are dropped
    (e.g. vocab 51865 on a 16-way model axis -> replicated)."""

    def __init__(self, mapping: dict[str, object] | None = None, mesh=None):
        self.mapping = dict(mapping or {})
        self.mesh = mesh

    def physical(self, logical: str | None):
        if logical is None:
            return None
        return _norm(self.mapping.get(logical))

    def physical_for_dim(self, logical: str | None, dim_size: int | None):
        axes = self.physical(logical)
        if axes is None or dim_size is None or self.mesh is None:
            return axes
        shape = mesh_shape(self.mesh)
        prod = 1
        for n in _names(axes):
            prod *= int(shape.get(n, 1))
        return None if dim_size % prod else axes

    def spec(self, *logical_axes) -> P:
        return P(*[self.physical(a) for a in logical_axes])


def _names(axes) -> tuple:
    return () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))


_state = threading.local()


def current_rules() -> AxisRules | None:
    return getattr(_state, "rules", None)


@contextmanager
def axis_rules(rules: AxisRules | dict | None):
    if isinstance(rules, dict):
        rules = AxisRules(rules)
    prev = current_rules()
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def logical_spec(*logical_axes) -> P:
    rules = current_rules()
    if rules is None:
        return P(*[None for _ in logical_axes])
    return rules.spec(*logical_axes)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` on the others.  A
    tuple such as ``("pod", "data")`` shards one dim over several mesh
    dims, in any order: DTensor cuts a dim over its mesh dims in the mesh's
    order, so ``("data", "model", "pod")`` (the reference's long-context
    cache spec) lays the pieces on the devices in another order than XLA
    does, with the same bytes on every rank.  A mesh dim of size 1 holds
    the whole tensor either way and gets ``Replicate()`` (DTensor refuses
    to drop a size-1 tensor dim it thinks is sharded)."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        for a in _names(axes):
            if a in sizes and sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def logical_constraint(x, *logical_axes):
    """Redistribute a ``DTensor`` to the active rules' spec; a no-op when
    no rules are installed (the unsharded run) or ``x`` is a plain tensor.
    As the reference's (which catches the error ``with_sharding_constraint``
    raises), a spec whose mesh axes do not divide their dim leaves ``x`` as
    it is, and so does a spec of all ``None``."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    spec = rules.spec(*logical_axes)
    if all(s is None for s in spec):
        return x
    mesh = x.device_mesh
    sizes = mesh_shape(mesh)
    for axes, n in zip(spec, x.shape):
        prod = 1
        for a in _names(axes):
            prod *= sizes.get(a, 1)
        if n % prod:
            return x
    return x.redistribute(mesh, placements(spec, mesh))


# ---------------------------------------------------------------------------
# kernel boundaries: the layout a ``local_map`` around a kernel runs in
# ---------------------------------------------------------------------------
def lift(*tensors):
    """(mesh, tensors): the mesh of the first ``DTensor`` among
    ``tensors``, and the tensors with each plain one made a replicated
    ``DTensor`` on it (every rank holds it whole); ``None`` stays ``None``."""
    mesh = next(t.device_mesh for t in tensors if isinstance(t, DTensor))
    rep = [Replicate()] * mesh.ndim
    return mesh, tuple(t if t is None or isinstance(t, DTensor)
                       else DTensor.from_local(t, mesh, rep, run_check=False)
                       for t in tensors)


def shard_dims(x, dim: int) -> tuple[list[int], int]:
    """(mesh dims, their product): the mesh dims on which ``DTensor`` ``x``
    is ``Shard(dim)``, or none (product 1) when their product does not
    divide ``x``'s size there, as a kernel needs whole, even pieces."""
    dims = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    n = math.prod(x.device_mesh.size(i) for i in dims)
    return (dims, n) if x.shape[dim] % n == 0 else ([], 1)


def layout(ndim: int, *pieces) -> tuple:
    """Placements for ``ndim`` mesh dims: each ``(mesh dims, placement)``
    of ``pieces`` on its dims, ``Replicate()`` on every other."""
    out = [Replicate()] * ndim
    for dims, placement in pieces:
        for i in dims:
            out[i] = placement
    return tuple(out)


def mesh_coord(mesh, dims) -> int:
    """This rank's linear index over the mesh dims ``dims``, major first
    (the order in which DTensor cuts a dim sharded over several)."""
    coord, r = mesh.get_coordinate(), 0
    for i in dims:
        r = r * mesh.size(i) + coord[i]
    return r


def local_heads(q, k, v, attend):
    """``attend(q, k, v)`` on each rank's local tensors through ``local_map``:
    attention is local to a (batch row, query head), so the flash kernel,
    the plain chunked form and the full-matrix form all run on local
    tensors, and no attention op reaches DTensor's sharding rules.
    q: (B, Sq, H, dh), k / v: (B, Skv, KV, dh).

    Batch rows keep q's ``Shard(0)`` and query heads its ``Shard(2)``; every
    other mesh dim is replicated (the kernel needs whole sequences).  Key /
    value heads follow the query heads' sharding when the mesh dims divide
    them.  When they do not (``kv_heads`` under a model axis it does not
    divide, so ``physical_for_dim`` dropped it), k and v stay replicated and
    each rank passes ``attend`` the one kv head its query heads read (local
    head ``h`` reads kv head ``h // G`` only within that slice); their
    gradient is then a partial sum over those mesh dims.  If the local query
    heads straddle two kv heads, the query heads are replicated instead."""
    mesh, (q, k, v) = lift(q, k, v)
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    bdims, _ = shard_dims(q, 0)
    hdims, nh = shard_dims(q, 2)
    sliced = bool(hdims) and KV % nh != 0
    if sliced and G % (H // nh):
        hdims, sliced = [], False
    qp = layout(mesh.ndim, (bdims, Shard(0)), (hdims, Shard(2)))
    kp = layout(mesh.ndim, (bdims, Shard(0)), ([] if sliced else hdims, Shard(2)))
    kgrad = layout(mesh.ndim, (bdims, Shard(0)), (hdims, Partial() if sliced else Shard(2)))

    def local(ql, kl, vl):
        if sliced:
            j = mesh_coord(mesh, hdims) * (H // nh) // G
            kl, vl = kl[:, :, j:j + 1], vl[:, :, j:j + 1]
        return attend(ql, kl, vl)

    return local_map(local, out_placements=list(qp), in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kgrad, kgrad), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


# ---------------------------------------------------------------------------
# production rule sets
# ---------------------------------------------------------------------------
def production_rules(multi_pod: bool, *, batch_divisible: bool = True,
                     shard_kv_heads: bool = True, mesh=None) -> AxisRules:
    dp = ("pod", "data") if multi_pod else ("data",)
    dp = dp if batch_divisible else None
    return AxisRules({
        "batch": dp,
        "fsdp": ("pod", "data") if multi_pod else ("data",),
        "model": ("model",),
        "expert": ("model",),
        "kv_seq": ("data",),               # long-context cache sharding
        "kv_heads": ("model",) if shard_kv_heads else None,
    }, mesh=mesh)


# ---------------------------------------------------------------------------
# parameter layout: path pattern -> logical axes per dim
# ---------------------------------------------------------------------------
#: fnmatch patterns over '/'-joined param paths.  First match wins.
#: None entries mean replicated dims; a leading '#' axis marks the
#: stacked-blocks dim (never sharded).
PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings / lm head: vocab over model, d over fsdp
    ("embed/table",            ("model", "fsdp")),
    ("lm_head/w",              ("fsdp", "model")),
    ("vision_proj/w",          (None, "fsdp")),
    # attention
    ("*wq/w",                  ("fsdp", "model")),
    ("*wk/w",                  ("fsdp", "model")),
    ("*wv/w",                  ("fsdp", "model")),
    ("*wo/w",                  ("model", "fsdp")),
    ("*wq/b",                  ("model",)),
    ("*wk/b",                  ("model",)),
    ("*wv/b",                  ("model",)),
    # dense MLP
    ("*mlp/wi/w",              ("fsdp", "model")),
    ("*mlp/wg/w",              ("fsdp", "model")),
    ("*mlp/wo/w",              ("model", "fsdp")),
    ("*mlp/wi/b",              ("model",)),
    ("*mlp/wo/b",              (None,)),
    # MoE: experts over the model axis (EP), d over fsdp
    ("*moe/router/w",          ("fsdp", None)),
    ("*moe/wi",                ("expert", "fsdp", None)),
    ("*moe/wg",                ("expert", "fsdp", None)),
    ("*moe/wo",                ("expert", None, "fsdp")),
    # mamba2
    ("*mamba/wx/w",            ("fsdp", "model")),
    ("*mamba/wz/w",            ("fsdp", "model")),
    ("*mamba/wB/w",            ("fsdp", None)),
    ("*mamba/wC/w",            ("fsdp", None)),
    ("*mamba/wdt/w",           ("fsdp", "model")),
    ("*mamba/out/w",           ("model", "fsdp")),
    ("*mamba/conv_w",          (None, "model")),
    ("*mamba/A_log",           ("model",)),
    ("*mamba/D",               ("model",)),
    ("*mamba/dt_bias",         ("model",)),
    ("*mamba/norm_y/scale",    ("model",)),
    # rwkv6
    ("*rwkv/w?/w",             ("fsdp", "model")),   # wr wk wv wg
    ("*rwkv/out/w",            ("model", "fsdp")),
    ("*rwkv/decay_w1",         ("fsdp", None)),
    ("*rwkv/decay_w2",         (None, "model")),
    ("*rwkv/decay_bias",       ("model",)),
    ("*rwkv/u",                ("model", None)),
    ("*rwkv/ln_y/scale",       ("model",)),
    ("*cmix/wk/w",             ("fsdp", "model")),
    ("*cmix/wv/w",             ("model", "fsdp")),
    ("*cmix/wr/w",             ("fsdp", "model")),
    # norms and everything else: replicated
    ("*",                      None),
]


def _match_spec(path: str, shape: tuple, stacked: bool) -> P:
    rules = current_rules() or AxisRules()
    n_dims = len(shape)
    for pat, axes in PARAM_RULES:
        if fnmatch.fnmatch(path, pat):
            if axes is None:
                return P()
            logical = list(axes)
            if stacked:
                logical = [None] + logical  # the stacked-blocks dim
            # trailing unspecified dims -> replicated
            while len(logical) < n_dims:
                logical.append(None)
            return P(*[rules.physical_for_dim(a, shape[i])
                       for i, a in enumerate(logical[:n_dims])])
    return P()


def param_specs(params, stacked_prefixes=("blocks", "enc_blocks")):
    """The spec tree matching ``params`` (a nested dict / list of tensors,
    ``meta`` ones included) by path patterns."""
    from ..models.convert import flatten, unflatten  # models import this module
    specs = {path: _match_spec(path, tuple(leaf.shape),
                               any(path.startswith(p) for p in stacked_prefixes))
             for path, leaf in flatten(params).items()}
    return unflatten(params, specs)


def batch_spec(global_batch: int, mesh) -> P:
    """Pick the largest batch-sharding axis combo that divides B."""
    shape = mesh_shape(mesh)
    names = [n for n in ("pod", "data") if n in shape]
    size = 1
    for n in names:
        size *= shape[n]
    if names and global_batch % size == 0:
        return P(tuple(names) if len(names) > 1 else names[0])
    if "data" in shape and global_batch % shape["data"] == 0:
        return P("data")
    return P(None)
