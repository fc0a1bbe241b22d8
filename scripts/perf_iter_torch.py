"""Perf-iteration harness of the PyTorch port, the counterpart of
``scripts/perf_iter.py``: count one dry-run cell of the port under config
overrides and report the three roofline terms against the H100, so each
hypothesis -> change -> measure iteration is one command.

    PYTHONPATH=src python scripts/perf_iter_torch.py --arch granite-moe-1b-a400m \\
        --shape train_4k --set remat=dots --tag dots

The cell is counted as ``python -m repro_torch.launch.dryrun`` counts it:
one process, a fake process group of 256 ranks as rank 0 (the 16x16 mesh),
tensors on ``meta``, the 1- and 2-block runs extrapolated to full depth
(``launch.dryrun.estimate_cost``), then ``roofline_from_numbers`` against
``HW_H100``.  ``--full-memory`` also counts the full-depth cell once and
records its peak live bytes above the arguments (``LiveBytes``) as the
temps, where the reference compiles it for XLA's ``memory_analysis``.
The counts are of shapes, not device times.  Results append to
``results/torch/perf_iters.jsonl`` under the working directory, one record
a run, with the reference's fields (without ``--full-memory`` the argument
and temp bytes are 0, as there) and ``hw``.  It imports no JAX.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_override(s: str):
    """``key=value`` with the value an int, a float, a bool or a string, as
    the reference's ``parse_override``."""
    k, v = s.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("true", "false"):
        return k, v == "true"
    return k, v


def apply_overrides(cfg, overrides):
    """``cfg`` with each ``--set`` override; ``ssm.*`` keys set fields of
    ``cfg.ssm``."""
    ssm_over = {}
    for s in overrides:
        k, v = parse_override(s)
        if k.startswith("ssm."):
            ssm_over[k[4:]] = v
        else:
            cfg = dataclasses.replace(cfg, **{k: v})
    if ssm_over:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **ssm_over))
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="ArchConfig field override, e.g. attn_chunk=2048; "
                         "ssm.* fields via ssm.chunk=256")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--full-memory", action="store_true",
                    help="also count the full-depth cell for its temps (slower)")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.cells import build_cell, lower_cell, memory_analysis
    from repro_torch.launch.dryrun import estimate_cost, fake_group
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.common import SHAPES
    from repro_torch.roofline import HW_H100, roofline_from_numbers, roofline_terms

    cfg = apply_overrides(get_config(args.arch), args.set)
    t0 = time.perf_counter()
    with fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        numbers, _ = estimate_cost(args.arch, args.shape, mesh, cfg)
        ma = None
        if args.full_memory:
            cell = build_cell(args.arch, args.shape, mesh, cfg=cfg)
            ma = memory_analysis(cell, lower_cell(cell, mesh)["temp"])
        n_devices = mesh.size()
    roof = roofline_from_numbers(numbers, arch=args.arch, shape_name=args.shape,
                                 mesh_name="16x16", n_devices=n_devices, cfg=cfg,
                                 shape=SHAPES[args.shape], memory_analysis=ma, hw=HW_H100,
                                 note=f"perf_iter tag={args.tag}")
    rec = roof.to_dict()
    rec["tag"] = args.tag
    rec["overrides"] = args.set
    rec["hw"] = HW_H100.name
    rec["wall_seconds"] = time.perf_counter() - t0
    print(roofline_terms(roof))
    print(f"  coll detail: {numbers['coll']['by_op']}")
    os.makedirs(os.path.join("results", "torch"), exist_ok=True)
    with open(os.path.join("results", "torch", "perf_iters.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
