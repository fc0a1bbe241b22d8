"""The port's dry run (``repro_torch.launch.dryrun``, ``cells.lower_cell``)
on fake process groups, each case in a subprocess, as
tests/test_cells_small_mesh.py runs the reference's: the process group
is global state, and the test process keeps none.

* The four cells of tests/test_cells_small_mesh.py, cut to 2 layers, on a
  2x2x2 fake mesh: FLOPs > 0 and collectives > 0.
* Per-device FLOPs are counted at each rank's local shapes: a sharded
  matmul counts the global FLOPs over the shards, a replicated one the
  global FLOPs, and the count does not change when DTensor's caches are
  warm.
* A dense train cell on a data-only 4x1 fake mesh does a quarter of the
  unsharded step's FLOPs on each rank, and so does one on a model-only 1x4
  and a 2x2 fake mesh (tensor parallel: no product runs whole on every
  model rank).
* The input specs of every arch id (tests/test_arch_smoke.py::test_input_specs_shapes).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models.registry import input_specs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELL = textwrap.dedent("""
    import json, os
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import build_cell, lower_cell, memory_analysis
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_test_mesh

    arch, shape = os.environ["ARCH"], os.environ["SHAPE"]
    with fake_group(8):
        mesh = make_test_mesh(2, 2, pods=2, device_type="cpu")
        cell = build_cell(arch, shape, mesh, cfg=get_config(arch).scaled_down(n_layers=2))
        cost = lower_cell(cell, mesh)
    ma = memory_analysis(cell, cost["temp"])
    print(json.dumps({"ok": True, "args": ma.argument_size_in_bytes,
                      "out": ma.output_size_in_bytes, "flops": cost["flops"],
                      "bytes": cost["bytes"], "coll": cost["coll"]["total"],
                      "temps": ma.temp_size_in_bytes, "kind": cell.kind}))
""")

FLOPS = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import build_cell, lower_cell, place_abstract
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.models.common import ShapeConfig
    from repro_torch.models.registry import build, train_batch_specs
    from repro_torch.optim import OptimizerConfig
    from repro_torch.roofline import CostCounter
    from repro_torch.runtime.steps import abstract_train_state, make_train_step

    def matmul(mesh, pa, pb):
        a = torch.empty(4096, 1024, device="meta")
        b = torch.empty(1024, 2048, device="meta")
        sh = lambda p: type("S", (), {"placements": p})()
        a, b = place_abstract([a, b], [sh(pa), sh(pb)], mesh)
        with CostCounter() as c:
            a @ b
        return c.flops

    out = {}
    with fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        out["sharded"] = [matmul(mesh, [Shard(0), Replicate()], [Replicate(), Shard(1)])
                          for _ in range(2)]
        out["replicated"] = [matmul(mesh, [Replicate()] * 2, [Replicate()] * 2)
                             for _ in range(2)]

    arch = "h2o-danube-3-4b"
    cfg = get_config(arch).scaled_down(n_layers=2)
    shape = ShapeConfig("t", 256, 8, "train")
    opt = OptimizerConfig()
    with fake_group(4):
        mesh = make_test_mesh(4, 1, device_type="cpu")
        out["per_device"] = lower_cell(build_cell(arch, shape, mesh, cfg=cfg, opt_cfg=opt),
                                       mesh)["flops"]
    api = build(cfg, "meta")
    state = abstract_train_state(api, opt)
    batch = train_batch_specs(cfg, shape)
    with CostCounter() as c:
        make_train_step(api, opt)(state, batch)
    out["unsharded"] = c.flops

    # tensor parallel: 4 kv heads, which a 4-wide model axis divides
    cfg = get_config(arch).scaled_down(n_layers=2, n_kv_heads=4)
    api = build(cfg, "meta")
    with CostCounter() as c:
        make_train_step(api, opt)(abstract_train_state(api, opt), train_batch_specs(cfg, shape))
    out["tp_unsharded"] = c.flops
    for d, m in [(1, 4), (2, 2)]:
        with fake_group(d * m):
            mesh = make_test_mesh(d, m, device_type="cpu")
            out[f"tp_{d}x{m}"] = lower_cell(build_cell(arch, shape, mesh, cfg=cfg, opt_cfg=opt),
                                            mesh)["flops"]
    print(json.dumps(out))
""")


def _run(script, **env):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1", **env)
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", [
    ("qwen1.5-0.5b", "train_4k"),
    ("granite-moe-1b-a400m", "prefill_32k"),
    ("rwkv6-7b", "decode_32k"),
    ("whisper-medium", "decode_32k"),
])
def test_cell_lowers_on_multipod_test_mesh(arch, shape):
    rec = _run(CELL, ARCH=arch, SHAPE=shape)
    assert rec["ok"] and rec["kind"] == shape.split("_")[0]
    assert rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["args"] > 0 and rec["out"] > 0 and rec["temps"] > 0
    # distributed program must actually communicate
    assert rec["coll"] > 0


@pytest.fixture(scope="module")
def flops():
    return _run(FLOPS)


def test_sharded_matmul_counts_per_device(flops):
    """(4096 x 1024) . (1024 x 2048), rows by columns over a 16x16 fake
    mesh: each rank multiplies (256 x 1024) . (1024 x 128)."""
    glob = 2 * 4096 * 1024 * 2048
    assert flops["sharded"] == [glob // 256] * 2
    assert flops["replicated"] == [glob] * 2


def test_data_parallel_flops_split_four_ways(flops):
    """A 2-layer dense train step on a data-only 4x1 fake mesh: 4 x each
    rank's FLOPs equal the unsharded step's within 1%."""
    assert abs(4 * flops["per_device"] - flops["unsharded"]) <= 0.01 * flops["unsharded"]


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_tensor_parallel_flops_split(flops, mesh):
    """The same train step, 4 kv heads, on a model-only 1x4 and a 2x2 fake
    mesh: each rank does a quarter of the unsharded step's products, within
    1%.  A product whose contracted dim is cut leaves partial sums; unless
    they are reduced (``layers.reduce_partial``), DTensor gathers the next
    product's weight and runs it whole on every model rank (2.0x the
    unsharded count on 1x4, 1.1x on 2x2)."""
    assert abs(4 * flops[f"tp_{mesh}"] - flops["tp_unsharded"]) <= 0.01 * flops["tp_unsharded"]


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_input_specs_shapes(arch_id):
    cfg = get_config(arch_id)
    specs = input_specs(cfg, "train_4k")
    assert tuple(specs["batch"]["tokens"].shape) == (256, 4096)
    d = input_specs(cfg, "decode_32k")
    assert tuple(d["token"].shape) == (128, 1)
    # cache leaves must be well-formed meta tensors
    for leaf in d["cache"].values():
        assert leaf.device.type == "meta" and all(dim > 0 for dim in leaf.shape)
