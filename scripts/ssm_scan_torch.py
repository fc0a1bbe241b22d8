#!/usr/bin/env python3
"""Builds, checks and times the Hopper ssm_scan kernel alone, on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/ssm_scan_torch.py [--rounds 2] [--source NAME=PATH ...]
        [--timed-only NAME=PATH ...]

Builds only ``src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu`` (``full``)
and any whole source given with ``--source NAME=PATH`` (another version of
the kernel, a copy under the git-ignored ``build/``, say), one ``nvcc``
each, all at once.  Each build runs through the wrapper
(``kernel.load_variant``) and is held against the plain versions by
``chip_smoke.py``'s own ``ssm_check`` (its small, edge, wide and main
cases, the decay of about -20 a step among them, in fp32 and bf16, at its
limits), then timed by ``chip_smoke.py``'s ``ssm_times`` at the two served
rwkv6 shapes (B4 T512 and B1 T5120, H 64, K = V = 64, bf16) and at jamba's
mamba layer's (the same B and T, H 256, one decay per head, q and k read
in place as one row per (b, t)): the device time per launch from
torch.profiler and CUDA-event time, beside the bound.
A source given with ``--timed-only`` is built and timed but not checked:
a copy with a part taken out, to see what that part costs.
``--rounds`` rounds of timing alternate the builds' order (forwards,
backwards, ...) so that drift of the clock falls on all alike.  Prints the
card's name and power limit, then one JSON line per build and shape.
Exits non-zero without CUDA, when a build fails, or when any build
disagrees with the plain versions.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build(name: str, text: str, build_dir: Path) -> Path:
    """Compiles one version of the kernel source into ``build_dir``; returns
    the shared library's path and prints ptxas's register and spill lines."""
    from repro_torch.kernels import _build
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    src, lib = build_dir / f"{name}-{digest}.cu", build_dir / f"{name}-{digest}.so"
    if not lib.exists():
        src.write_text(text)
        proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}")
        print(json.dumps({"build": name, "ptxas": [
            ln.strip() for ln in proc.stdout.splitlines()
            if any(w in ln for w in ("registers", "spill", "arning"))]}), flush=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                    help="also build, check and time this whole kernel source")
    ap.add_argument("--timed-only", action="append", default=[], metavar="NAME=PATH",
                    help="also build and time this source, without checking it")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssm_scan_torch: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import kernel, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    texts = {"full": (_build.PKG_DIR / kernel.SOURCE).read_text()}
    for spec in args.source + args.timed_only:
        name, _, path = spec.partition("=")
        texts[name] = Path(path).read_text()
    unchecked = {spec.partition("=")[0] for spec in args.timed_only}
    build_dir = _build.BUILD_DIR / "ssm_variants"
    build_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(texts)) as pool:  # one nvcc per source
        libs = dict(zip(texts, pool.map(lambda kv: build(*kv, build_dir), texts.items())))
    dev = torch.device("cuda", 0)
    failed = []
    for name, lib in libs.items():
        if name in unchecked:
            continue
        kernel.load_variant(lib)
        try:
            worst = chip_smoke.ssm_check(torch, ops, kernel, ref, dev)
            print(json.dumps({"build": name, "max_abs_err": worst}), flush=True)
        except chip_smoke.SmokeFailure as exc:
            failed.append(name)
            print(json.dumps({"build": name, "ok": False, "error": str(exc)[:2000]}), flush=True)
    rows = {name: [] for name in libs}
    order = [n for n in libs if n not in failed]
    for r in range(args.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            kernel.load_variant(libs[name])
            rows[name].append(chip_smoke.ssm_times(
                torch, kernel, ref, dev, plain=False,
                cases=chip_smoke.SSM_MAIN_CASES + chip_smoke.MAMBA_MAIN_CASES))
    for name in order:
        for i, first in enumerate(rows[name][0]):
            dms = [run[i]["device_ms"] for run in rows[name]]
            ms = [run[i]["ms"] for run in rows[name]]
            print(json.dumps({"build": name, "layout": first["layout"], "B": first["B"],
                              "T": first["T"], "H": first["H"],
                              "device_ms": statistics.median(dms), "round_device_ms": dms,
                              "ms": statistics.median(ms), "round_ms": ms,
                              "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                              "device_share_of_bound":
                                  first["bound_ms"] / statistics.median(dms),
                              "card": card}), flush=True)
    kernel.load_variant(None)
    if failed:
        print(f"ssm_scan_torch: builds that disagree with the plain versions: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
