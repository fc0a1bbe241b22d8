"""The dry run's temp bytes: ``repro_torch.roofline.memory.LiveBytes``, the
peak bytes a run holds above its arguments, the counterpart of the temp
bytes of the reference's ``compiled.memory_analysis()``.

* On a toy chain of ops the peak is the bytes reckoned by hand, on ``meta``
  and on the CPU.
* One small train step gives the same peak on ``meta`` as on the CPU.
* The dry run's 1-/2-block extrapolation of the peak is within
  EXTRAPOLATION_TOL of a full-depth count on small cells (fake 2x2 mesh).
* ``fits_hbm`` is false for a cell whose arguments fit and whose temps do
  not (a shrunk ``hbm_bytes``), true on the H100's 80 GB.

The fake-group cases run in a subprocess, as tests/test_torch_dryrun.py's:
the process group is global state.  tests/test_torch_gpu.py holds the
peak against ``torch.cuda.max_memory_allocated`` on the card.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.common import ShapeConfig  # noqa: E402
from repro_torch.models.registry import build, train_batch_specs  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.roofline import LiveBytes  # noqa: E402
from repro_torch.runtime.steps import (abstract_train_state, make_train_state,  # noqa: E402
                                       make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the extrapolated peak against the full-depth count, relative: a peak is
#: not a sum, and a block's saved bytes are not all it adds (4 blocks: the
#: dense train cell reads 0.977, the MoE one 0.997)
EXTRAPOLATION_TOL = 0.05


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_toy_chain_peak_by_hand(device):
    """a (an argument) is not counted; a view and an in-place op allocate
    nothing; a storage is freed when its last view dies."""
    a = torch.ones(1024, device=device)
    with LiveBytes() as live:
        b = a * 2                      # 4 KiB
        c = b + 1                      # 8 KiB
        del b                          # 4 KiB
        d = c.view(32, 32)             # a view of c: 4 KiB
        d.mul_(3)                      # in place: 4 KiB
        e = torch.cat([c, c])          # 12 KiB, the peak
        del c                          # d keeps c's storage: 12 KiB
        del d                          # 8 KiB
        f = e.sum()                    # 8 KiB + 4 bytes
    assert live.peak == 3 * 4096
    assert live.live == 2 * 4096 + 4
    assert f.numel() == 1


def test_meta_and_cpu_peaks_equal_for_a_train_step():
    """One train step of a 2-layer dense model (loss, gradients through the
    block remat, AdamW): the same ops allocate the same storages on
    ``meta`` as on the CPU, so the dry run's count on ``meta`` is the
    peak a real run's ops hold."""
    cfg = get_config("h2o-danube-3-4b").scaled_down(n_layers=2)
    shape = ShapeConfig("t", 64, 2, "train")
    opt = OptimizerConfig(state_dtype="float32")
    peaks = {}
    for device in ("meta", "cpu"):
        api = build(cfg, device)
        if device == "meta":
            state, batch = abstract_train_state(api, opt), train_batch_specs(cfg, shape)
        else:
            state = make_train_state(api, opt, torch.Generator().manual_seed(0))
            gen = torch.Generator().manual_seed(1)
            batch = {k: torch.randint(0, cfg.vocab_size, tuple(v.shape), dtype=v.dtype,
                                      generator=gen)
                     for k, v in train_batch_specs(cfg, shape).items()}
        step = make_train_step(api, opt)
        with LiveBytes() as live:
            step(state, batch)
        peaks[device] = live.peak
    assert peaks["meta"] > 0
    assert peaks["meta"] == peaks["cpu"]


EXTRAPOLATE = textwrap.dedent("""
    import json
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import build_cell, lower_cell
    from repro_torch.launch.dryrun import _depth_config, fake_group
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.common import ShapeConfig
    from repro_torch.roofline import cost_numbers, extrapolate

    out = {}
    for arch in ("qwen1.5-0.5b", "granite-moe-1b-a400m"):
        cfg = get_config(arch).scaled_down(n_layers=4)
        shape = ShapeConfig("t", 256, 8, "train")
        with fake_group(4):
            mesh = make_test_mesh(2, 2, device_type="cpu")
            c = {u: cost_numbers(lower_cell(build_cell(arch, shape, mesh,
                                                       cfg=_depth_config(cfg, u)), mesh))
                 for u in (1, 2, cfg.n_blocks)}
        out[arch] = {"blocks": cfg.n_blocks, "one": c[1]["temp"], "two": c[2]["temp"],
                     "full": c[cfg.n_blocks]["temp"],
                     "extrapolated": extrapolate(c[1], c[2], cfg.n_blocks)["temp"]}
    print(json.dumps(out))
""")

FITS = textwrap.dedent("""
    import dataclasses, json
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import build_cell, lower_cell, memory_analysis
    from repro_torch.launch.dryrun import fake_group, fits_hbm
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.common import ShapeConfig
    from repro_torch.roofline import HW_H100

    arch = "qwen1.5-0.5b"
    with fake_group(4):
        mesh = make_test_mesh(2, 2, device_type="cpu")
        cell = build_cell(arch, ShapeConfig("t", 256, 8, "train"), mesh,
                          cfg=get_config(arch).scaled_down(n_layers=2))
        ma = memory_analysis(cell, lower_cell(cell, mesh)["temp"])
    # arguments fit, arguments and temps do not
    small = dataclasses.replace(HW_H100, hbm_bytes=ma.argument_size_in_bytes
                                + ma.temp_size_in_bytes // 2)
    print(json.dumps({"args": ma.argument_size_in_bytes, "temps": ma.temp_size_in_bytes,
                      "small_hbm": small.hbm_bytes, "fits_small": fits_hbm(ma, small),
                      "fits_h100": fits_hbm(ma, HW_H100),
                      "untold": fits_hbm(dataclasses.replace(ma, temp_size_in_bytes=None),
                                         HW_H100)}))
""")


def _run(script):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def extrapolated():
    return _run(EXTRAPOLATE)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-1b-a400m"])
def test_extrapolated_peak_matches_full_depth(extrapolated, arch):
    """A 4-block train cell on a fake 2x2 mesh: the peak extrapolated from
    its 1- and 2-block runs, as the dry run does, against a count of all 4
    blocks.  Each block adds to the peak (its saved input and gradients)."""
    got = extrapolated[arch]
    assert got["blocks"] == 4 and got["one"] < got["two"] < got["full"]
    assert abs(got["extrapolated"] / got["full"] - 1) <= EXTRAPOLATION_TOL


def test_fits_hbm_counts_temps():
    """``fits_hbm`` is arguments plus temps against the card's memory, as
    the reference's ``dryrun.py:136``: false where the arguments fit and the
    temps do not, true on 80 GB, and untold (``None``) without temps."""
    got = _run(FITS)
    assert got["temps"] > 0 and got["args"] < got["small_hbm"]
    assert got["fits_small"] is False
    assert got["fits_h100"] is True
    assert got["untold"] is None
