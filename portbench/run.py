"""Runs one cell of the port's benchmark once, on the card it is started on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as its last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; then ``check``, each
number compared beside its limit, also printed as the last lines of
standard error.  Exits nonzero, printing no result, without a CUDA card,
or if the run loaded JAX or the JAX package.  The full profiler table of a
traced run goes to ``portbench_out/<workload>.<seed>/profile.txt``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or torch writes stays at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    c = harness.Cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.entry["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {c.entry['chips']} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    result = harness.run(c, args.seed % (1 << 63), args.seconds, bool(args.trace),
                         t_start=T_START,
                         out_dir=ROOT / "portbench_out" / f"{args.workload}.{args.seed}")
    found = harness.forbidden_loaded()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, v in result["check"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
