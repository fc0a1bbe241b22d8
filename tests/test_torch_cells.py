"""The port's cells (``repro_torch.launch.cells``) against the reference's
and against the unsharded port.

* The shardings ``build_cell`` gives the four cells of
  tests/test_cells_small_mesh.py (params, batch, caches, logits, tokens)
  equal the reference's ``.spec``s entry by entry.  The reference side runs
  in a subprocess on 8 forced host devices, as that file does; the port's
  needs only the mesh's shape.
* On a 4-rank gloo group (a 2x2 ("data", "model") CPU mesh, one spawn per
  family, its cases inside, rank 0 reporting what it measured), the cells' sharded
  steps equal the unsharded port in fp32 within SHARD_RTOL of each
  tensor's largest magnitude: a dense train step (loss, every gradient
  leaf gathered, the grad norm, the AdamW update), granite-moe prefill and
  4 decode steps under each ``moe_shard_constraints`` pin, rwkv6 and jamba
  under ``ssm_shard_constraints``, whisper decoding over its cross caches,
  the kernel boundary's GQA cases, the constraint itself, and the elastic
  restore (mirroring tests/test_ckpt_data.py::test_elastic_restore_resharded)
  and the sharded save.
* On a 1x4 mesh, 2 kv heads that the model axis does not divide; on a 1x2
  mesh, one request decoding greedily over a sharded vocab.
* The decode cell with ``pos`` a replicated 0-d tensor, as the dry run
  places it, on KV caches cut over S_max (2x2 and 1x4), against the int
  ``pos`` run.
* granite-moe train steps under each pin, against the unsharded step.
* Each family's sharded prefill on a 2x2 mesh under ``RefusedOps``, a
  dispatch mode that records the ``DTensor`` ops torch 2.11's sharding
  rules refuse (ROADMAP C15): none may reach them.  Newer torch versions
  accept those ops, so under them only the recording shows the fault.

Each case records its own result, or the error it raised, so one case's
error fails its own tests and leaves the family's other cases running.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import textwrap
import traceback
import weakref

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate, Shard,  # noqa: E402
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication  # noqa: E402
from torch.distributed.tensor._ops._view_ops import Flatten, InputDim, view_groups  # noqa: E402
from torch.multiprocessing.reductions import StorageWeakRef  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.ckpt import checkpoint as ckpt_module  # noqa: E402
from repro_torch.ckpt import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.connectors.posix import PosixConnector  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import chunked_attention  # noqa: E402
from repro_torch.launch.cells import build_cell, distribute_like  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.common import ShapeConfig  # noqa: E402
from repro_torch.models.convert import flatten, tree_map  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw_update  # noqa: E402
from repro_torch.runtime.steps import (abstract_train_state, make_serve_step,  # noqa: E402
                                       make_train_state, make_train_step, value_and_grad)
from repro_torch.sharding.rules import (axis_rules, logical_constraint,  # noqa: E402
                                        production_rules)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: fp32, sharded against unsharded, relative to the unsharded tensor's largest
#: magnitude: the sums a 2-way model axis splits are added in another order
SHARD_RTOL = 1e-5

CELLS = [("qwen1.5-0.5b", "train_4k"), ("granite-moe-1b-a400m", "prefill_32k"),
         ("rwkv6-7b", "decode_32k"), ("whisper-medium", "decode_32k")]

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    from repro.launch.mesh import make_test_mesh
    from repro.launch.cells import build_cell
    from repro.configs import get_config

    def specs(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in kp):
                [list(e) if isinstance(e, tuple) else e for e in sh.spec]
                for kp, sh in leaves}

    mesh = make_test_mesh(2, 2, pods=2)
    out = {}
    for arch, shape in json.loads(os.environ["CELLS"]):
        cell = build_cell(arch, shape, mesh, cfg=get_config(arch).scaled_down(n_layers=2))
        out[arch + "/" + shape] = {"in": specs(cell.in_shardings),
                                   "out": specs(cell.out_shardings)}
    print(json.dumps(out))
""")


class FakeMesh:
    """The reference's (2, 2, 2) test mesh, by its shape alone."""
    shape = {"pod": 2, "data": 2, "model": 2}


def _port_specs(tree):
    return {"/".join(str(k) for k in path):
            [list(e) if isinstance(e, tuple) else e for e in sh.spec]
            for path, sh in _walk(tree, ())}


def _walk(tree, path):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "spec"):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CELLS=json.dumps(CELLS))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REFERENCE], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_shardings_match_reference(reference_specs, arch, shape):
    """Every input and output sharding's spec of the cell, params and
    moments, batch, caches, logits and tokens, equals the reference's."""
    cell = build_cell(arch, shape, FakeMesh(), cfg=get_config(arch).scaled_down(n_layers=2))
    want = reference_specs[f"{arch}/{shape}"]
    got = {"in": _port_specs(cell.in_shardings), "out": _port_specs(cell.out_shardings)}
    for side in ("in", "out"):
        # the reference's train metrics and decode position are pytree leaves
        # the port keeps as plain values; every tensor's sharding is compared
        assert got[side] == {k: v for k, v in want[side].items() if k in got[side]}, side
        assert len(got[side]) >= len(want[side]) - 6
    kinds = {"train_4k": "train", "prefill_32k": "prefill", "decode_32k": "decode"}
    assert cell.kind == kinds[shape]


def test_cell_abstract_inputs_are_meta():
    """The cell's abstract inputs hold shapes and dtypes, no storage."""
    cfg = get_config("whisper-medium").scaled_down(n_layers=2)
    cell = build_cell("whisper-medium", "decode_32k", FakeMesh(), cfg=cfg)
    params, cache, token, pos = cell.abstract_inputs
    leaves = list(flatten(params).values()) + list(cache.values()) + [token, pos]
    assert all(t.device.type == "meta" for t in leaves)
    assert tuple(token.shape) == (128, 1) and pos.dim() == 0
    assert tuple(cache["attn_k"].shape)[2:4] == (128, 32768)
    assert tuple(cache["cross_k"].shape)[2:4] == (128, cfg.encdec.n_audio_ctx)


# ---------------------------------------------------------------------------
# sharded runs: each family's cases, run on every rank of a spawned group
# ---------------------------------------------------------------------------
CPU = torch.device("cpu")


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rel(got, want) -> float:
    """Largest difference relative to ``want``'s largest magnitude."""
    return ((_full(got).float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def _each(cases: dict) -> dict:
    """{name: the thunk's result, or ``{"error", "traceback"}`` of what it
    raised}: one case's error leaves the others running."""
    out = {}
    for name, run in cases.items():
        try:
            out[name] = run()
        except Exception as exc:  # recorded: the case's own tests fail on it
            out[name] = {"error": f"{type(exc).__name__}: {exc}",
                         "traceback": traceback.format_exc()[-4000:]}
    return out


def _case(result, *path):
    """The case at ``path`` of a family's result; fails with the error the
    family or the case recorded."""
    for depth in range(len(path) + 1):
        if isinstance(result, dict) and "error" in result and "traceback" in result:
            pytest.fail(f"{'/'.join(map(str, path[:depth])) or 'family'}: {result['error']}\n"
                        f"{result['traceback']}")
        if depth < len(path):
            result = result[path[depth]]
    return result


def _cfg(arch, **kw):
    return get_config(arch).scaled_down(**{"compute_dtype": "float32",
                                           "param_dtype": "float32", **kw})


def _tokens(cfg, B, S, seed):
    return torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(seed))


def _serve_case(mesh, arch, cfg, B=4, S=32, n_dec=4, seed=1, tensor_pos=False):
    """Prefill and ``n_dec`` greedy decode steps through the prefill and
    decode cells, against the unsharded prefill and serve steps.  With
    ``tensor_pos`` the decode cell also runs from a copy of the prefill's
    caches with ``pos`` a replicated 0-d tensor (the decode cell's abstract
    input), against the int ``pos`` run."""
    api = build(cfg, CPU)
    params = api.init(torch.Generator().manual_seed(0))
    batch = {"tokens": _tokens(cfg, B, S, seed)}
    if cfg.is_encdec:
        batch["audio_embeds"] = torch.randn((B, cfg.encdec.n_audio_ctx, cfg.d_model),
                                            generator=torch.Generator().manual_seed(seed + 1))
    pre = build_cell(arch, ShapeConfig("p", S, B, "prefill"), mesh, cfg=cfg, pad_to=S + n_dec)
    dec = build_cell(arch, ShapeConfig("d", S + n_dec, B, "decode"), mesh, cfg=cfg)
    with torch.no_grad():
        logits, cache, _ = api.prefill(params, batch, pad_to=S + n_dec)
    d_logits, d_cache = pre.step_fn(distribute_like(params, pre.in_shardings[0], mesh),
                                    distribute_like(batch, pre.in_shardings[1], mesh))
    dparams = distribute_like(params, dec.in_shardings[0], mesh)
    out = {"prefill_logits": _rel(d_logits, logits),
           "cache_placements": {k: [str(p) for p in v.placements] for k, v in d_cache.items()}}
    step = make_serve_step(api)
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    d_tok = distribute_like(tok, dec.in_shardings[2], mesh)
    t_tok, t_cache = d_tok, tree_map(torch.clone, d_cache) if tensor_pos else None
    same, t_same = True, True
    for i in range(n_dec):
        with torch.no_grad():
            tok, cache = step(params, cache, tok, S + i)
        d_tok, d_cache = dec.step_fn(dparams, d_cache, d_tok, S + i)
        same &= bool(torch.equal(_full(d_tok), tok))
        if tensor_pos:
            pos = distribute_like(torch.tensor(S + i, dtype=torch.int32),
                                  dec.in_shardings[3], mesh)
            t_tok, t_cache = dec.step_fn(dparams, t_cache, t_tok, pos)
            t_same &= bool(torch.equal(_full(t_tok), _full(d_tok)))
    out["decode_tokens_equal"] = same
    out["decode_caches"] = max(_rel(d_cache[k], v) for k, v in cache.items())
    if tensor_pos:
        out["tensor_pos_tokens_equal"] = t_same
        out["tensor_pos_caches"] = max(_rel(t_cache[k], _full(v)) for k, v in d_cache.items())
    return out


def _train_case(mesh, tmp, arch="h2o-danube-3-4b", **cfg_kw):
    """``arch`` scaled down (h2o-danube-3-4b: 1 kv head under a 2-way model
    axis, the kernel boundary's sliced GQA path; ``cfg_kw`` overrides the
    config) through the train cell: loss, every gradient leaf and the grad
    norm against the unsharded step, and the AdamW update against the
    unsharded AdamW applied to the gathered sharded gradients."""
    B, S = 4, 32
    cfg = _cfg(arch, **cfg_kw)
    api = build(cfg, CPU)
    opt = OptimizerConfig(state_dtype="float32", warmup_steps=0, peak_lr=1e-3)
    batch = {"tokens": _tokens(cfg, B, S, 1), "labels": _tokens(cfg, B, S, 2)}
    cell = build_cell(arch, ShapeConfig("t", S, B, "train"), mesh, cfg=cfg, opt_cfg=opt)
    state = make_train_state(api, opt, torch.Generator().manual_seed(0))
    d_state = distribute_like(tree_map(torch.clone, state), cell.in_shardings[0], mesh)
    d_batch = distribute_like(batch, cell.in_shardings[1], mesh)
    with axis_rules(cell.rules), implicit_replication():
        _, _, d_grads = value_and_grad(api, d_state["params"], d_batch)
    d_grads = tree_map(_full, d_grads)
    placed = {k: [str(p) for p in v.placements] for k, v in flatten(d_state["params"]).items()}
    loss, _, grads = value_and_grad(api, state["params"], batch)
    ref_state = tree_map(torch.clone, state)
    adamw_update(ref_state["params"], d_grads, ref_state["opt"], opt)
    d_state, metrics = cell.step_fn(d_state, d_batch)
    new_state, ref_metrics = make_train_step(api, opt)(state, batch)
    return {
        "loss": abs(metrics["loss"].item() - loss.item()) / abs(loss.item()),
        "grad_norm": abs(metrics["grad_norm"].item() - ref_metrics["grad_norm"].item())
        / ref_metrics["grad_norm"].item(),
        "grads": {k: _rel(d_grads_k, flatten(grads)[k])
                  for k, d_grads_k in flatten(d_grads).items()},
        "adamw_same_grads": max(_rel(flatten(d_state)[k], v)
                                for k, v in flatten(ref_state).items() if v.dim()),
        "moments_placed_as_params": all(
            flatten(d_state["opt"]["m"])[k].placements == p.placements
            for k, p in flatten(d_state["params"]).items()),
        "param_placements": placed,
    }


def _gqa_cases(mesh):
    """``flash_attention`` on q sharded over "model" by its heads, k and v
    replicated, forward and gradients, against the unsharded call: one kv
    head per rank's heads (sliced), query heads straddling two kv heads
    (q replicated) and kv heads the axis divides (sharded)."""
    return _each({name: (lambda H=H, KV=KV: _gqa_case(mesh, H, KV))
                  for name, H, KV in (("sliced", 4, 1), ("replicated_q", 6, 3),
                                      ("sharded", 4, 2))})


def _gqa_case(mesh, H, KV):
    gen = torch.Generator().manual_seed(H * 10 + KV)
    q = torch.randn((4, 24, H, 16), generator=gen)
    k, v = (torch.randn((4, 24, KV, 16), generator=gen) for _ in range(2))
    w = torch.randn((4, 24, H, 16), generator=gen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = flash_attention(*leaves, causal=True, window=None)
    want_grads = torch.autograd.grad((want * w).sum(), leaves)
    dq = distribute_tensor(q, mesh, [Shard(0), Shard(2)]).requires_grad_()
    dk, dv = (distribute_tensor(t, mesh, [Shard(0), Replicate()]).requires_grad_()
              for t in (k, v))
    got = flash_attention(dq, dk, dv, causal=True, window=None)
    dw = distribute_tensor(w, mesh, [Shard(0), Replicate()])
    got_grads = torch.autograd.grad((got * dw).sum(), [dq, dk, dv])
    return {"out": _rel(got, want), "out_placements": [str(p) for p in got.placements],
            "grads": max(_rel(g, wg) for g, wg in zip(got_grads, want_grads))}


def _constraint_cases(mesh):
    """``logical_constraint`` under production rules: a DTensor is
    redistributed to the rules' spec; a spec whose axis does not divide its
    dim leaves it as it is; a plain tensor passes through.  The plain
    chunked attention run on DTensors with ``shard_constrain`` (k and v
    pinned to (batch, kv_heads)) equals the unsharded call."""
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((4, 20, 4, 8), generator=gen) for _ in range(3))
    want = chunked_attention(q, k, v, causal=True, chunk=8)
    with axis_rules(production_rules(False, mesh=mesh)), implicit_replication():
        pinned = logical_constraint(d, "batch", None, "model")
        odd = logical_constraint(distribute_tensor(x[:, :, :7], mesh, [Replicate()] * 2),
                                 "batch", None, "model")
        plain = logical_constraint(x, "batch", None, "model")
        got = chunked_attention(*(distribute_tensor(t, mesh, [Replicate()] * 2)
                                  for t in (q, k, v)), causal=True, chunk=8,
                                shard_constrain=True)
    return {"pinned": [str(p) for p in pinned.placements],
            "pinned_equal": bool(torch.equal(pinned.full_tensor(), x)),
            "non_dividing": [str(p) for p in odd.placements],
            "plain_is_input": plain is x,
            "chunked_pinned": _rel(got, want)}


def _ckpt_cases(mesh, tmp):
    """The elastic restore: a train state saved unsharded restores onto the
    train cell's 2x2 placements, each rank's shard the matching slice; the
    same state saved from DTensors is byte for byte the unsharded save,
    manifest and lanesum32 digests included."""
    arch = "granite-moe-1b-a400m"
    cfg = _cfg(arch, param_dtype="bfloat16")
    api, opt = build(cfg, CPU), OptimizerConfig(state_dtype="float32")
    cell = build_cell(arch, ShapeConfig("t", 32, 4, "train"), mesh, cfg=cfg, opt_cfg=opt)
    state = make_train_state(api, opt, torch.Generator().manual_seed(3))
    plain_dir, sharded_dir = os.path.join(tmp, "plain"), os.path.join(tmp, "sharded")
    if dist.get_rank() == 0:
        save_checkpoint(state, PosixConnector(plain_dir), "c", step=7, bundle_threshold=1024)
    dist.barrier()
    # the full leaves a rank holds at once while it restores: each read leaf
    # lands in a tensor ``_to_device`` makes
    alive, held = [], [0]
    to_device = ckpt_module._to_device

    def tracked(data, dev):
        t = to_device(data, dev)
        alive.append(weakref.ref(t))
        held[0] = max(held[0], sum(r() is not None for r in alive))
        return t

    ckpt_module._to_device = tracked
    try:
        restored, step = restore_checkpoint(abstract_train_state(api, opt),
                                            PosixConnector(plain_dir), "c",
                                            shardings=cell.in_shardings[0])
    finally:
        ckpt_module._to_device = to_device
    shards_ok = all(
        torch.equal(r.to_local(), distribute_tensor(flatten(state)[k], mesh, r.placements,
                                                    src_data_rank=None).to_local())
        for k, r in flatten(restored).items())
    n_sharded = sum(any(p.is_shard() for p in r.placements) for r in flatten(restored).values())
    # each rank keeps its shard's bytes only, not a view into the full leaf
    own = all(r.to_local().untyped_storage().nbytes()
              == r.to_local().numel() * r.to_local().element_size()
              for r in flatten(restored).values())
    d_state = distribute_like(state, cell.in_shardings[0], mesh)
    # the full leaves a rank holds at once while it saves (each gathered leaf's
    # storage, alive or not when the next is gathered; a replicated leaf's full
    # tensor is its own local tensor), and the host bytes it keeps
    gathered, held_save, host_bytes = [], [0], [0]
    full_tensor, snapshot = DTensor.full_tensor, ckpt_module.snapshot

    def tracked_full(self, *args, **kw):
        t = full_tensor(self, *args, **kw)
        if any(p.is_shard() for p in self.placements):
            held_save[0] = max(held_save[0], sum(not r.expired() for r in gathered) + 1)
            gathered.append(StorageWeakRef(t.untyped_storage()))
        return t

    def tracked_snapshot(*args, **kw):
        leaves = snapshot(*args, **kw)
        host_bytes[0] += sum(len(leaf.data) for leaf in leaves if leaf.data is not None)
        return leaves

    DTensor.full_tensor, ckpt_module.snapshot = tracked_full, tracked_snapshot
    try:
        save_checkpoint(d_state, PosixConnector(sharded_dir), "c", step=7, bundle_threshold=1024)
    finally:
        DTensor.full_tensor, ckpt_module.snapshot = full_tensor, snapshot
    dist.barrier()
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, {"held": held_save[0], "host_bytes": host_bytes[0]})
    files = {}
    for root in (plain_dir, sharded_dir):
        base = os.path.join(root, "c")
        files[root] = {os.path.relpath(os.path.join(d, f), base):
                       open(os.path.join(d, f), "rb").read()
                       for d, _, fs in os.walk(base) for f in fs}
    a, b = files[plain_dir], files[sharded_dir]
    return {"step": step, "restored_shards_match": shards_ok, "sharded_leaves": n_sharded,
            "shard_storage_own": own, "full_leaves_held_at_once": held[0],
            "leaves": len(flatten(restored)), "files": len(a),
            "save_full_leaves_held_at_once": [r["held"] for r in per_rank],
            "save_host_bytes": [r["host_bytes"] for r in per_rank],
            "state_bytes": sum(t.numel() * t.element_size() for t in flatten(state).values()),
            "manifest_equal": a.get("step_7/manifest.json") == b.get("step_7/manifest.json"),
            "bytes_equal": a == b}


def _dense_cases(mesh, tmp):
    arch = "h2o-danube-3-4b"
    return _each({"serve": lambda: _serve_case(mesh, arch, _cfg(arch), n_dec=2, tensor_pos=True),
                  "train": lambda: _train_case(mesh, tmp), "gqa": lambda: _gqa_cases(mesh),
                  "constraint": lambda: _constraint_cases(mesh),
                  "ckpt": lambda: _ckpt_cases(mesh, tmp)})


#: granite-moe's ``moe_shard_constraints`` values: none, and the two pins
MOE_PINS = ["", "expert", "capacity"]


def _moe_cases(mesh, tmp):
    """Prefill and decode under each pin, and a train step under each pin
    and none (the dry run's cells set no pin)."""
    arch = "granite-moe-1b-a400m"
    serve = {pin: (lambda pin=pin: _serve_case(mesh, arch, _cfg(arch, moe_shard_constraints=pin)))
             for pin in MOE_PINS[1:]}
    train = {f"train_{pin}": (lambda pin=pin: _train_case(mesh, tmp, arch,
                                                          moe_shard_constraints=pin))
             for pin in MOE_PINS}
    return _each({**serve, **train})


def _ssm_cases(mesh, tmp):
    return _each({arch: (lambda arch=arch: _serve_case(mesh, arch, _cfg(arch, ssm_shard_constraints=True),
                                                       n_dec=2))
                  for arch in ("rwkv6-7b", "jamba-1.5-large-398b")})


def _whisper_cases(mesh, tmp):
    arch = "whisper-medium"
    return _each({arch: lambda: _serve_case(mesh, arch, _cfg(arch), S=16, n_dec=2)})


def _heads_cases(mesh, tmp):
    """2 kv heads under a 4-wide model axis: the kv projections' output dim
    is cut in 4 pieces that straddle heads, so it is resharded before the
    split into heads (``layers.split_dim``); the KV caches (S_max 36) are
    cut over S_max."""
    arch = "h2o-danube-3-4b"
    return _each({"serve": lambda: _serve_case(mesh, arch, _cfg(arch, n_kv_heads=2),
                                               tensor_pos=True),
                  "train": lambda: _train_case(mesh, tmp, n_kv_heads=2)})


def _vocab_cases(mesh, tmp):
    """One request of rwkv6 decoding greedily with its vocab cut over a
    2-wide model axis."""
    arch = "rwkv6-7b"
    return _each({arch: lambda: _serve_case(mesh, arch, _cfg(arch), B=1, n_dec=2)})


aten = torch.ops.aten


def _sharded_dims(t) -> set:
    return {p.dim for p in t.placements if isinstance(p, Shard)} if isinstance(t, DTensor) else set()


def _refused(func, args) -> str | None:
    """Why torch 2.11's sharding rules refuse ``func`` on these ``DTensor``
    arguments (ROADMAP C15), or None: a view (no copy allowed) that
    flattens a sharded dim into the dim before it ("Attempted to flatten
    multiple dimensions, with dimension 1 being sharded"), a constant pad
    of a sharded tensor (its redistribute planner's ``IndexError``), and
    ``index`` / ``index_put`` on a sharded indexed dim (results sized or
    broadcast wrongly)."""
    x = args[0]
    cut = _sharded_dims(x)
    if not cut:
        return None
    if func in (aten.view.default, aten._unsafe_view.default) and x.dim() >= 4:
        size = torch._prims_common.infer_size(args[1], x.numel())
        for cmd in view_groups(list(x.shape), list(size)):
            inner = {d.input_dim for d in getattr(cmd, "input_dims", ())[1:]
                     if isinstance(d, InputDim)} if isinstance(cmd, Flatten) else set()
            if inner & cut:
                return f"{func} flattens sharded dims {sorted(inner & cut)} of {tuple(x.shape)}"
    if func is aten.constant_pad_nd.default:
        return f"{func} of a tensor sharded on dims {sorted(cut)}"
    if func in (aten.index.Tensor, aten.index_put.default, aten.index_put_.default,
                aten._index_put_impl_.default):
        indexed = {i for i, ix in enumerate(args[1]) if ix is not None}
        if indexed & cut:
            return f"{func} indexes sharded dims {sorted(indexed & cut)} of {tuple(x.shape)}"
    return None


class RefusedOps(TorchDispatchMode):
    """Records each op on ``DTensor``s that torch 2.11's sharding rules
    refuse (``_refused``), then hands it to DTensor, which runs it."""

    def __init__(self):
        super().__init__()
        self.seen: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            why = _refused(func, args)
            if why:
                self.seen.append(why)
            return NotImplemented
        return func(*args, **(kwargs or {}))


#: the prefills ``_refused_cases`` records: (name, arch, config overrides)
REFUSED_PREFILLS = [
    ("dense_full_attention", "h2o-danube-3-4b", {"attn_impl": "full"}),
    ("rwkv6", "rwkv6-7b", {"ssm_shard_constraints": True}),
    ("jamba", "jamba-1.5-large-398b", {"ssm_shard_constraints": True}),
    *[(f"moe_{pin or 'unpinned'}", "granite-moe-1b-a400m", {"moe_shard_constraints": pin})
      for pin in MOE_PINS],
    ("whisper", "whisper-medium", {}),
]


def _refused_prefill(mesh, arch, cfg_kw, B=4, S=16):
    cfg = _cfg(arch, **cfg_kw)
    params = build(cfg, CPU).init(torch.Generator().manual_seed(0))
    batch = {"tokens": _tokens(cfg, B, S, 1)}
    if cfg.is_encdec:
        batch["audio_embeds"] = torch.randn((B, cfg.encdec.n_audio_ctx, cfg.d_model),
                                            generator=torch.Generator().manual_seed(2))
    cell = build_cell(arch, ShapeConfig("p", S, B, "prefill"), mesh, cfg=cfg, pad_to=S + 2)
    args = (distribute_like(params, cell.in_shardings[0], mesh),
            distribute_like(batch, cell.in_shardings[1], mesh))
    with RefusedOps() as rec:
        cell.step_fn(*args)
    return rec.seen


def _refused_chunked(mesh):
    """The plain chunked attention on DTensors with ``shard_constrain``
    (k and v pinned to (batch, kv_heads), q cut by heads)."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((4, 20, 4, 8), generator=gen) for _ in range(3))
    dq = distribute_tensor(q, mesh, [Shard(0), Shard(2)])
    dk, dv = (distribute_tensor(t, mesh, [Replicate()] * 2) for t in (k, v))
    with axis_rules(production_rules(False, mesh=mesh)), implicit_replication(), \
            RefusedOps() as rec:
        chunked_attention(dq, dk, dv, causal=True, chunk=8, shard_constrain=True)
    return rec.seen


def _refused_cases(mesh, tmp):
    """Each family's sharded prefill, and the chunked attention, under
    ``RefusedOps``: the refused ops each reached."""
    cases = {name: (lambda arch=arch, kw=kw: _refused_prefill(mesh, arch, kw))
             for name, arch, kw in REFUSED_PREFILLS}
    return _each({**cases, "chunked_attention": lambda: _refused_chunked(mesh)})


#: family -> (cases, the mesh's (n_data, n_model))
FAMILIES = {"dense": (_dense_cases, (2, 2)), "moe": (_moe_cases, (2, 2)),
            "ssm": (_ssm_cases, (2, 2)), "whisper": (_whisper_cases, (2, 2)),
            "heads": (_heads_cases, (1, 4)), "vocab": (_vocab_cases, (1, 2)),
            "refused": (_refused_cases, (2, 2))}


def _rank_main(rank, world, port, family, tmp):
    """One rank of a gloo group: the family's mesh and cases; rank 0
    writes what it measured to ``tmp``/result.json, each case's result or
    error (``_each``), or the family's error if its mesh failed."""
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    # a case that fails on some ranks only leaves the others in a collective:
    # the timeout ends the spawn rather than the test run's time limit
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        cases, shape = FAMILIES[family]
        try:
            res = cases(make_test_mesh(*shape, device_type="cpu"), tmp)
        except Exception as exc:  # recorded: every test of the family fails on it
            res = {"error": f"{type(exc).__name__}: {exc}",
                   "traceback": traceback.format_exc()[-4000:]}
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawn(family, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp(family))
    world = FAMILIES[family][1][0] * FAMILIES[family][1][1]
    mp.spawn(_rank_main, args=(world, _free_port(), family, tmp), nprocs=world, join=True)
    with open(os.path.join(tmp, "result.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return _spawn("dense", tmp_path_factory)


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    return _spawn("moe", tmp_path_factory)


@pytest.fixture(scope="module")
def ssm(tmp_path_factory):
    return _spawn("ssm", tmp_path_factory)


@pytest.fixture(scope="module")
def whisper(tmp_path_factory):
    return _spawn("whisper", tmp_path_factory)


@pytest.fixture(scope="module")
def heads(tmp_path_factory):
    return _spawn("heads", tmp_path_factory)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return _spawn("vocab", tmp_path_factory)


@pytest.fixture(scope="module")
def refused(tmp_path_factory):
    return _spawn("refused", tmp_path_factory)


def test_train_step_loss_and_grad_norm(dense):
    train = _case(dense, "train")
    assert train["loss"] <= SHARD_RTOL
    assert train["grad_norm"] <= SHARD_RTOL


def test_train_step_every_grad_leaf(dense):
    grads = _case(dense, "train", "grads")
    assert len(grads) > 10
    bad = {k: v for k, v in grads.items() if v > SHARD_RTOL}
    assert not bad


def test_train_step_adamw_update(dense):
    """The sharded AdamW step equals the unsharded AdamW on the same
    (gathered) gradients: Adam's first step is g / |g| elementwise, so 1e-6
    of gradient noise on near-zero entries would move it by a visible share
    of the learning rate, and it is held on the gradients the sharded step
    took.  Moments are placed as their parameters."""
    train = _case(dense, "train")
    assert train["adamw_same_grads"] <= 1e-6
    assert train["moments_placed_as_params"]


def test_train_cell_shards_params_2d(dense):
    """ZeRO-3 + TP on the 2x2 mesh: wq over (fsdp, model), the vocab of the
    embedding over model and its width over data, norms replicated."""
    placed = _case(dense, "train", "param_placements")
    assert placed["embed/table"] == ["S(1)", "S(0)"]
    assert placed["blocks/layers/0/attn/wq/w"] == ["S(1)", "S(2)"]
    assert placed["blocks/layers/0/norm1/scale"] == ["R", "R"]


@pytest.mark.parametrize("case", ["sliced", "replicated_q", "sharded"])
def test_flash_boundary_gqa_kv_heads(dense, case):
    """q cut over "model" by heads, k / v replicated: with 1 kv head (4 q
    heads) each rank gets its kv slice; with 3 kv heads under 6 q heads a
    rank's heads straddle two kv heads and q is replicated; with 2 kv heads
    k / v are cut too.  Output and the gradients through ``local_map`` (the
    plain backward per shard) equal the unsharded call's."""
    got = _case(dense, "gqa", case)
    assert got["out"] <= SHARD_RTOL and got["grads"] <= SHARD_RTOL
    heads = {"sliced": "S(2)", "replicated_q": "R", "sharded": "S(2)"}[case]
    assert got["out_placements"] == ["S(0)", heads]


def test_logical_constraint_redistributes(dense):
    c = _case(dense, "constraint")
    assert c["pinned"] == ["S(0)", "S(2)"] and c["pinned_equal"]
    assert c["non_dividing"] == ["R", "R"]
    assert c["plain_is_input"]
    assert c["chunked_pinned"] <= SHARD_RTOL


def test_elastic_restore_onto_2x2_placements(dense):
    c = _case(dense, "ckpt")
    assert c["step"] == 7 and c["restored_shards_match"]
    assert 0 < c["sharded_leaves"] < c["leaves"]


def test_elastic_restore_keeps_only_shards(dense):
    """A rank reads one full leaf at a time and keeps only its shard's
    bytes: one full leaf alive at once, and no restored shard's storage
    larger than the shard (a view into the full leaf would keep it alive).
    Either fault would have each rank hold the unsharded state."""
    c = _case(dense, "ckpt")
    assert c["full_leaves_held_at_once"] == 1
    assert c["shard_storage_own"]


def test_sharded_save_byte_identical(dense):
    c = _case(dense, "ckpt")
    assert c["files"] > 3 and c["manifest_equal"] and c["bytes_equal"]


def test_sharded_save_gathers_one_leaf_at_a_time(dense):
    """A sharded save gathers, digests and copies one leaf at a time, as the
    reference saves: no rank holds more than one full leaf at once, and
    only rank 0, which writes, keeps host bytes (the state's, once).  Before,
    every rank gathered every leaf, then copied all of them to its host."""
    c = _case(dense, "ckpt")
    assert c["save_full_leaves_held_at_once"] == [1, 1, 1, 1]
    assert c["save_host_bytes"] == [c["state_bytes"], 0, 0, 0]


@pytest.mark.parametrize("pin", ["expert", "capacity"])
def test_moe_prefill_decode_pinned(moe, pin):
    got = _case(moe, pin)
    assert got["prefill_logits"] <= SHARD_RTOL and got["decode_caches"] <= SHARD_RTOL
    assert got["decode_tokens_equal"]
    assert got["cache_placements"]["attn_k"] == ["S(2)", "S(4)"]  # batch, kv heads


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_ssm_prefill_decode_constrained(ssm, arch):
    got = _case(ssm, arch)
    assert got["prefill_logits"] <= SHARD_RTOL and got["decode_caches"] <= SHARD_RTOL
    assert got["decode_tokens_equal"]
    assert got["cache_placements"]["ssm"] == ["S(2)", "S(3)"]  # batch, heads


@pytest.mark.parametrize("step", ["prefill", "decode", "train"])
def test_kv_heads_not_dividing_model_axis(heads, step):
    """2 kv heads on a 1x4 mesh (model = 4): prefill, a decode step and a
    train step equal the unsharded port."""
    if step == "prefill":
        assert _case(heads, "serve")["prefill_logits"] <= SHARD_RTOL
    elif step == "decode":
        serve = _case(heads, "serve")
        assert serve["decode_tokens_equal"] and serve["decode_caches"] <= SHARD_RTOL
    else:
        train = _case(heads, "train")
        assert train["loss"] <= SHARD_RTOL and train["grad_norm"] <= SHARD_RTOL
        assert max(train["grads"].values()) <= SHARD_RTOL


@pytest.mark.parametrize("family", ["dense", "heads"])
def test_decode_tensor_pos_on_sequence_sharded_cache(family, request):
    """The decode cell with ``pos`` a replicated 0-d tensor, as the dry run
    places it, on KV caches cut over S_max (1 kv head under a 2-wide model
    axis, 2 under a 4-wide one): every rank writes only the row it holds,
    so tokens and caches equal the int ``pos`` run."""
    got = _case(request.getfixturevalue(family), "serve")
    assert "S(3)" in got["cache_placements"]["attn_k"]  # S_max cut over "model"
    assert got["tensor_pos_tokens_equal"] and got["tensor_pos_caches"] <= SHARD_RTOL


def test_greedy_decode_over_sharded_vocab(vocab):
    """rwkv6, one request, its vocab cut over a 2-wide model axis: the
    greedy tokens are the unsharded ones."""
    got = _case(vocab, "rwkv6-7b")
    assert got["prefill_logits"] <= SHARD_RTOL and got["decode_tokens_equal"]


def test_whisper_decode_over_cross_caches(whisper):
    got = _case(whisper, "whisper-medium")
    assert got["prefill_logits"] <= SHARD_RTOL and got["decode_caches"] <= SHARD_RTOL
    assert got["decode_tokens_equal"]
    assert got["cache_placements"]["cross_k"] == ["S(2)", "S(4)"]


@pytest.mark.parametrize("pin", MOE_PINS)
def test_moe_train_step_pinned(moe, pin):
    """granite-moe's train step under each pin and none: the dispatch and
    the combine run through ``local_map`` on each rank's experts and token
    rows, and their gradients sum over the other ranks; loss, grad norm and
    every gradient leaf equal the unsharded step's."""
    train = _case(moe, f"train_{pin}")
    assert train["loss"] <= SHARD_RTOL and train["grad_norm"] <= SHARD_RTOL
    assert max(train["grads"].values()) <= SHARD_RTOL
    assert train["param_placements"]["blocks/layers/0/moe/wi"][1] == "S(1)"  # experts on model


@pytest.mark.parametrize("case", [name for name, _, _ in REFUSED_PREFILLS]
                         + ["chunked_attention"])
def test_no_op_torch_2_11_refuses(refused, case):
    """No ``DTensor`` op that torch 2.11's sharding rules refuse (ROADMAP
    C15) runs in the family's sharded prefill on a 2x2 mesh: attention's
    einsums (a view flattening the kv-head dim into the batch dim) run on
    local tensors, rwkv6's token shift, mamba's conv and the prefill's cache
    padding concatenate zeros rather than pad, and MoE's scatter and gather
    index local buffers."""
    assert _case(refused, case) == []
