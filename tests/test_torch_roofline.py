"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``): the blockwise extrapolation and ``model_flops``
mirror tests/test_roofline.py; ``model_flops`` equals the reference's for
every cell of the ten arch ids; ``roofline_from_numbers`` gives the
reference's fields for the same numbers and hardware.  The collective
counter and DTensor's ``topk`` run on a fake process group of 4 ranks (a
2x2 mesh) in a subprocess, which keeps the test process free of a
default group."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.common import SHAPES as JAX_SHAPES, cells_for  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import hw as jhw  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models.common import SHAPES  # noqa: E402
from repro_torch.roofline import (HW_H100, HW_V5E, extrapolate, model_flops,  # noqa: E402
                                  roofline_from_numbers)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

C1 = {"flops": 10.0, "bytes": 100.0,
      "coll": {"total": 7, "by_op": {"all-reduce": 7}, "count": {"all-reduce": 2}}}
C2 = {"flops": 16.0, "bytes": 130.0,
      "coll": {"total": 10, "by_op": {"all-reduce": 10}, "count": {"all-reduce": 3}}}


def test_extrapolate_linear():
    out = extrapolate(C1, C2, n_blocks=5)
    assert out["flops"] == 10 + 4 * 6
    assert out["bytes"] == 100 + 4 * 30
    assert out["coll"]["by_op"]["all-reduce"] == 7 + 4 * 3
    assert out["coll"]["count"]["all-reduce"] == 2 + 4 * 1
    assert out == janalysis.extrapolate(C1, C2, n_blocks=5)


def test_extrapolate_clamps_negative_marginals():
    c1 = {"flops": 10.0, "bytes": 100.0, "coll": {"total": 5, "by_op": {}, "count": {}}}
    c2 = {"flops": 8.0, "bytes": 90.0, "coll": {"total": 5, "by_op": {}, "count": {}}}
    out = extrapolate(c1, c2, n_blocks=10)
    assert out["flops"] == 10.0   # never extrapolates downward
    assert out["bytes"] == 100.0
    assert out == janalysis.extrapolate(c1, c2, n_blocks=10)


def test_model_flops_moe_uses_active_params():
    mf = model_flops(get_config("dbrx-132b"), SHAPES["train_4k"])
    # 132B total but ~36B active -> 6*N_active*D
    tokens = 256 * 4096
    assert 6 * 25e9 * tokens < mf < 6 * 60e9 * tokens


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    """Both sides count every parameter of the abstract tree exactly."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape in cells_for(arch):
        got, want = model_flops(cfg, SHAPES[shape]), janalysis.model_flops(jcfg, JAX_SHAPES[shape])
        assert abs(got - want) <= 1e-12 * want, (shape, got, want)


def _hw_pair(name):
    """The port's hardware entry and the same numbers as the reference's
    ``Hardware`` (which has no H100)."""
    hw = {"v5e": HW_V5E, "h100": HW_H100}[name]
    return hw, jhw.Hardware(**dataclasses.asdict(hw))


@pytest.mark.parametrize("hw", ["v5e", "h100"])
@pytest.mark.parametrize("arch,shape", [("qwen1.5-0.5b", "train_4k"),
                                        ("dbrx-132b", "prefill_32k"),
                                        ("rwkv6-7b", "decode_32k")])
def test_roofline_from_numbers_matches_reference(arch, shape, hw):
    numbers = {"flops": 3.1e13, "bytes": 2.2e12,
               "coll": {"total": 5_000_000_000, "by_op": {"all-gather": 4_000_000_000,
                                                          "reduce-scatter": 1_000_000_000},
                        "count": {"all-gather": 12, "reduce-scatter": 3}}}
    ma = SimpleNamespace(argument_size_in_bytes=1.5e9, temp_size_in_bytes=2.5e9)
    port_hw, ref_hw = _hw_pair(hw)
    kw = dict(arch=arch, shape_name=shape, mesh_name="16x16", n_devices=256,
              memory_analysis=ma, note="n")
    got = roofline_from_numbers(numbers, cfg=get_config(arch), shape=SHAPES[shape], hw=port_hw,
                                **kw).to_dict()
    want = janalysis.roofline_from_numbers(numbers, cfg=jax_get_config(arch),
                                           shape=JAX_SHAPES[shape], hw=ref_hw, **kw).to_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12), k
        else:
            assert got[k] == v, k


def test_h100_is_a_datasheet_entry():
    assert HW_H100.peak_flops_bf16 == 989e12 and HW_H100.hbm_bw == 3.35e12
    assert HW_H100.hbm_bytes == 80 * 1024**3
    assert HW_H100.ici_bw_per_link == 450e9 and HW_H100.ici_links == 1
    assert HW_H100.dcn_bw == 50e9


FAKE = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.moe import _top_k
    from repro_torch.roofline import CollectiveCounter

    def dt(local, placements, shape):
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape), stride=torch.empty(shape).stride())

    out = {}
    with fake_group(4):
        mesh = make_test_mesh(2, 2, device_type="cpu")
        f32 = lambda *s: torch.zeros(s, device="meta")
        cases = {  # (8, 16) fp32, one redistribute over the "model" dim (G = 2)
            "all-gather": (f32(4, 16), Shard(0), Replicate()),
            "all-reduce": (f32(8, 16), Partial(), Replicate()),
            "reduce-scatter": (f32(8, 16), Partial(), Shard(0)),
            "all-to-all": (f32(4, 16), Shard(0), Shard(1)),
        }
        for name, (local, src, dst) in cases.items():
            x = dt(local, [Replicate(), src], (8, 16))
            with CollectiveCounter() as c:
                x.redistribute(mesh, [Replicate(), dst])
            out[name] = c.record()
        probs = dt(f32(4, 6), [Shard(0), Replicate()], (8, 6))
        out["topk"] = [list(_top_k(probs, k)[0].shape) for k in (2, 4)]
        out["topk_local"] = [list(_top_k(probs, k)[1].to_local().shape) for k in (2, 4)]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", FAKE], env=env, capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("op,nbytes", [
    ("all-gather", 8 * 16 * 4),          # out: the gathered (8, 16)
    ("all-reduce", 8 * 16 * 4),          # out
    ("reduce-scatter", 4 * 16 * 4 * 2),  # out (4, 16) x G
    ("all-to-all", 8 * 8 * 4),           # out: (8, 8), not the fallback's gather
])
def test_collective_counter_bytes(fake, op, nbytes):
    """One redistribute of each kind on a 2x2 fake mesh, counted under the
    reference's byte conventions (``repro/roofline/hlo.py``)."""
    assert fake[op] == {"total": nbytes, "by_op": {op: nbytes}, "count": {op: 1}}


def test_moe_top_k_of_a_dtensor_keeps_k(fake):
    """DTensor caches ``topk``'s sharding by its input alone: a second
    ``topk`` with another ``k`` took the first one's global shape (dbrx after
    jamba in one dry run).  ``moe._top_k`` runs it on the local rows."""
    assert fake["topk"] == [[8, 2], [8, 4]]
    assert fake["topk_local"] == [[4, 2], [4, 4]]
