"""Reads the two ends that a cell's limits are set between, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 12 --control-seeds 3 --seconds 4

In one process: for each of ``--seeds`` seeds, a run of the program as
``run.py`` makes it (set-up, a short window at the cell's own load, the
check), printing the check's numbers; then, for each of ``--control-seeds``
seeds, the same run with the reference computed in fp8 put in the
program's place (the kind's ``stand_in``), judged by the same check, and,
for training, with the reference broken by each fault a step can have.  One JSON line a seed; the last line holds each
number's lower reading (the largest program reading) and upper reading:
the least of the control's readings at 3x the lower or more, a fault's at
10x or more and, for the gradient and the change, the 1 a step that
leaves its state unchanged reads.  With ``--write-limits`` each limit goes
to ``limits/<cell>.json`` at lower^(1/3) * upper^(2/3), two digits,
rounded down: room on both sides, the more of it above the lower.
"""

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--write-limits", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    c = harness.Cell(ROOT, args.workload)
    kind = harness.kind_module(c.traffic["kind"])
    dev = torch.device("cuda")
    program, control = [], []
    for j in range(args.seeds + args.control_seeds):
        is_control = j >= args.seeds
        seed = args.first_seed + j + (1000 - args.seeds if is_control else 0)
        t0 = time.perf_counter()
        bench = kind.Bench(c, seed, dev)
        bench.stand_in = "fp8" if is_control else None
        bench.setup()
        bench.window(args.seconds)
        bench.release()
        t1 = time.perf_counter()
        got = bench.check()
        check_s = time.perf_counter() - t1
        if is_control:
            got = {"control": got, **(bench.faults() if hasattr(bench, "faults") else {})}
        (control if is_control else program).append(got)
        checked = getattr(bench, "checked", None)
        del bench
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "side": "control" if is_control else "program", **got,
                          "checked": checked, "check_s": check_s,
                          "s": time.perf_counter() - t0}), flush=True)
    ends = readings(program, control)
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(),
                      "ends": ends}), flush=True)
    if args.write_limits:
        limits = {k: limit(e["lower"], e["upper"]) for k, e in ends.items()}
        if all(v is not None for v in limits.values()):
            (ROOT / "portbench" / "limits" / f"{args.workload}.json").write_text(
                json.dumps(limits) + "\n")
        print(json.dumps({"limits": limits}), flush=True)
    return 0


#: the reading of a step that leaves its state unchanged
UNCHANGED = {"grad_gap": 1.0, "change_gap": 1.0, "grad_err": 1.0}


def readings(program: list, control: list) -> dict:
    """{number: {"lower", "upper", "by"}} (see the module docstring)."""
    out = {}
    for k in program[0]:
        lower = max(r[k] for r in program)
        cands = [(min(r["control"][k] for r in control), "control", 3)]
        cands += [(min(r[f][k] for r in control), f, 10) for f in control[0] if f != "control"]
        if k in UNCHANGED:
            cands.append((UNCHANGED[k], "unchanged_state", 3))
        held = [(v, by) for v, by, times in cands if v >= times * lower]
        upper, by = min(held) if held else (None, None)
        out[k] = {"lower": lower, "upper": upper, "by": by,
                  "all": {by: v for v, by, _ in cands}}
    return out


def limit(lower: float, upper: float | None) -> float | None:
    if upper is None:
        return None
    x = lower ** (1 / 3) * upper ** (2 / 3)
    digits = 10 ** (math.floor(math.log10(x)) - 1)
    return math.floor(x / digits) * digits


if __name__ == "__main__":
    sys.exit(main())
