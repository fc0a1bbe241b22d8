"""Pod-scale dry run, ported from ``repro/launch/dryrun.py``.

For every (architecture x input shape) cell, on the 16x16 single-pod
mesh and the 2x16x16 multi-pod mesh: build the cell, place its abstract
inputs by its shardings and count one run of its step
(``cells.lower_cell``), then the three-term roofline
(``roofline.analysis``) against the H100 (``roofline.hw.HW_H100``).
Results are one JSON per cell, ``dryrun_<arch>_<shape>_<mesh>.json`` under
``--results-dir``, with the reference's fields.  Any failure is a fault of
the sharding layer.

The reference lowers and compiles on 512 fake host devices.  PyTorch runs
eagerly, so here the step runs in one process on a fake process group
(``torch.testing``'s ``FakeStore``) of 256 or 512 ranks as rank 0, every
tensor on ``meta``: DTensor computes rank 0's local shapes and issues its
collectives, which the fake group answers without moving data.  Nothing
touches a device, so it runs anywhere, as the reference's does.

The reference compiles the full-depth cell for ``memory_analysis`` and
1- and 2-block unrolled variants for the cost.  Here the full-depth cell
is built but not run: its per-rank argument and output bytes come from its
placements.  The cost is the 1- and 2-block runs, extrapolated to full
depth; with ``--skip-cost`` (the reference's multi-pod mode) only the
1-block run, the counterpart of the reference's raw count, which counts a
scan body once.  The temps are the peak bytes a rank holds above its
arguments in the same counted runs (``roofline.memory.LiveBytes``),
extrapolated as the cost is; as the reference's, ``fits_hbm`` compares
arguments plus temps with the H100's 80 GB.  On ``meta`` attention and the
scan run their plain chunked forms, so the temps are those of the plain
forms, as the reference's default ``attn_impl="chunked"`` compiles them.
With ``--skip-cost`` one block's peak says little of the full depth's:
temps and ``fits_hbm`` are ``null`` there.  Times are host seconds of the
CPU that runs the count.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod-only | --single-pod-only]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from contextlib import contextmanager


def _depth_config(cfg, n_units: int):
    """Config truncated to ``n_units`` scan blocks with every scan
    unrolled, as the reference's (its ``unroll_*`` flags are inert in the
    eager port).  SSM chunking switches to the (L=512, R=128) blocking of
    the reference's dry run so the counted FLOPs are those of the same
    chunked form."""
    unit = cfg.attn_every if cfg.family != "ssm" else 1
    kw = dict(n_layers=n_units * unit, unroll_scans=True, unroll_blocks=True)
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec, n_encoder_layers=n_units)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, chunk=512, subchunk=128)
    return dataclasses.replace(cfg, **kw)


@contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks in this process, as
    rank 0: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def estimate_cost(arch_id: str, shape_name: str, mesh, cfg,
                  skip_cost: bool = False) -> tuple[dict, dict]:
    """Blockwise extrapolation (see ``roofline.analysis``): count the 1- and
    2-block variants and extrapolate the marginal block to full depth;
    with ``skip_cost`` the 1-block count alone.  Returns (the numbers, the
    1-block numbers)."""
    from ..roofline import cost_numbers, extrapolate
    from .cells import build_cell, lower_cell
    nums = [cost_numbers(lower_cell(build_cell(arch_id, shape_name, mesh,
                                               cfg=_depth_config(cfg, u)), mesh))
            for u in ((1,) if skip_cost else (1, 2))]
    if skip_cost:
        return nums[0], nums[0]
    return extrapolate(nums[0], nums[1], cfg.n_blocks), nums[0]


def fits_hbm(ma, hw) -> bool | None:
    """Whether a rank's arguments and temps fit ``hw``'s memory, as the
    reference's ``dryrun.py`` asks; ``None`` where no temps were counted."""
    if ma.temp_size_in_bytes is None:
        return None
    return ma.argument_size_in_bytes + ma.temp_size_in_bytes < hw.hbm_bytes


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             results_dir: str = "results/torch", skip_cost: bool = False) -> dict:
    from ..configs import get_config
    from ..models.common import SHAPES
    from ..roofline import HW_H100, roofline_from_numbers, roofline_terms
    from .cells import build_cell, memory_analysis
    from .mesh import make_production_mesh, mesh_info

    mesh_name = "2x16x16" if multi_pod else "16x16"
    cfg = get_config(arch_id)
    t_start = time.perf_counter()
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        cell = build_cell(arch_id, shape_name, mesh, cfg=cfg)
        t_lower = time.perf_counter() - t_start
        t0 = time.perf_counter()
        numbers, raw = estimate_cost(arch_id, shape_name, mesh, cfg, skip_cost)
        note = ("raw count: one block (the reference's scan body counted once)" if skip_cost
                else "blockwise extrapolation (1/2-block counted runs)")
        t_count = time.perf_counter() - t0
        ma = memory_analysis(cell, None if skip_cost else numbers["temp"])
        info = mesh_info(mesh)
    temps = ("not counted" if ma.temp_size_in_bytes is None
             else f"{ma.temp_size_in_bytes / 1e9:.2f}GB")
    print(f"[{arch_id} x {shape_name} @ {mesh_name}] memory: "
          f"args={ma.argument_size_in_bytes/1e9:.2f}GB temps={temps} "
          f"out={ma.output_size_in_bytes/1e9:.2f}GB per device")
    print(f"  counted (one block): flops/dev={raw['flops']:.3e} "
          f"bytes/dev={raw['bytes']:.3e} coll/dev={raw['coll']['total']:.3e} "
          f"temp/dev={raw['temp']:.3e}")
    note += ("; bytes = input + output bytes of every non-view local aten op, "
             "unfused: an upper estimate of HBM traffic; temps = peak live bytes above "
             "the arguments of the counted runs, with the plain chunked attention and "
             "scan that run on meta in place of the kernels"
             + ("; one block's peak is not the cell's: temps not given" if skip_cost else ""))
    roof = roofline_from_numbers(numbers, arch=arch_id, shape_name=shape_name,
                                 mesh_name=mesh_name, n_devices=mesh.size(), cfg=cfg,
                                 shape=SHAPES[shape_name], memory_analysis=ma,
                                 hw=HW_H100, note=note)
    print("  " + roofline_terms(roof))

    rec = roof.to_dict()
    rec.update({
        "ok": True,
        "hw": HW_H100.name,
        "lower_seconds": t_lower,
        "compile_seconds": None,   # eager: nothing is compiled
        "count_seconds": t_count,
        "seconds": time.perf_counter() - t_start,
        "bytes_per_dev_output": float(ma.output_size_in_bytes),
        "raw_cost": {"flops": raw["flops"], "bytes": raw["bytes"],
                     "coll_total": raw["coll"]["total"]},
        "mesh_info": info,
        "fits_hbm": fits_hbm(ma, HW_H100),
        "kind": cell.kind,
    })
    os.makedirs(results_dir, exist_ok=True)
    out = os.path.join(results_dir, f"dryrun_{arch_id}_{shape_name}_{mesh_name}.json")
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--results-dir", default="results/torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--skip-cost", action="store_true",
                    help="skip the 1/2-block cost extrapolation (multi-pod"
                         " runs prove sharding; the roofline table is"
                         " single-pod)")
    args = ap.parse_args()

    from ..configs import ARCH_IDS
    from ..models.common import cells_for

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in cells_for(a)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all) required")
        cells = [(args.arch, args.shape)]

    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)

    failures = []
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            path = os.path.join(args.results_dir, f"dryrun_{arch}_{shape}_{mesh_name}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("ok"):
                        print(f"[skip cached] {arch} x {shape} @ {mesh_name}")
                        continue
            t0 = time.perf_counter()
            try:
                run_cell(arch, shape, mp, args.results_dir, skip_cost=args.skip_cost or mp)
            except Exception as e:  # every cell is tried; each failure is recorded
                traceback.print_exc()
                failures.append((arch, shape, mesh_name, repr(e)))
                os.makedirs(args.results_dir, exist_ok=True)
                with open(path, "w") as f:
                    json.dump({"ok": False, "arch": arch, "shape": shape, "mesh": mesh_name,
                               "error": repr(e), "seconds": time.perf_counter() - t0}, f)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f4 in failures:
            print("  ", *f4)
        return 1
    print("\nALL DRY-RUN CELLS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
