"""``python -m repro_torch.lint`` — run the contract linter on the port.

A copy of ``repro/lint/cli.py``: the port imports nothing of ``repro``.
It lints ``src/repro_torch`` against its own budget,
``lint-budget-torch.json``; the reference's linter and
``lint-budget.json`` cover ``src/repro``.

    python -m repro_torch.lint                 # human table, exit 0/1
    python -m repro_torch.lint --check         # CI gate: also enforce the
                                               # suppression budget
    python -m repro_torch.lint --json          # machine-readable report
    python -m repro_torch.lint --write-budget  # bless current suppressions
    python -m repro_torch.lint src/repro_torch/core   # subset of the tree

Exit codes: 0 clean, 1 findings / budget growth, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .engine import (BUDGET_FILE, budget_violations, load_budget, run_lint,
                     write_budget)
from .rules import RULES

#: src/repro_torch/lint/cli.py -> repo root is four parents up
_DEFAULT_ROOT = Path(__file__).resolve().parents[3]


def _table(rows: list[tuple[str, str, str]]) -> str:
    if not rows:
        return ""
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    return "\n".join(f"{r[0]:<{w0}}  {r[1]:<{w1}}  {r[2]}" for r in rows)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="AST-based invariant checker for the clock/charge/"
                    "lock/health contracts (rules R001-R005)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--root", type=Path, default=_DEFAULT_ROOT,
                    help="repo root for path scoping + the budget file")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON report on stdout")
    ap.add_argument("--check", action="store_true",
                    help="CI gate: nonzero exit on any unsuppressed "
                         "finding OR suppression growth past the budget")
    ap.add_argument("--write-budget", action="store_true",
                    help="record current suppression counts as the "
                         "blessed budget")
    ap.add_argument("--budget", type=Path, default=None,
                    help=f"budget file (default: <root>/{BUDGET_FILE})")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rule ids to report")
    args = ap.parse_args(argv)

    root = args.root.resolve()
    budget_path = args.budget or (root / BUDGET_FILE)
    report = run_lint(root, args.paths or None)
    if args.rules:
        keep = set(args.rules.split(","))
        unknown = keep - set(RULES) - {"R000"}
        if unknown:
            print(f"unknown rule(s): {','.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        report.findings = [f for f in report.findings if f.rule in keep]
        report.suppressed = [f for f in report.suppressed
                             if f.rule in keep]

    if args.write_budget:
        write_budget(budget_path, report)
        print(f"budget written: {budget_path}")

    over = budget_violations(report, load_budget(budget_path)) \
        if args.check else []
    ok = not report.failing and not over

    if args.as_json:
        print(json.dumps({
            "ok": ok,
            "files_checked": report.files_checked,
            "findings": [f.to_dict() for f in report.failing],
            "suppressed": [f.to_dict() for f in report.suppressed],
            "unused_suppressions": [
                {"rule": s.rule, "line": s.line, "reason": s.reason}
                for s in report.unused_suppressions],
            "budget_violations": over,
        }, indent=2))
        return 0 if ok else 1

    rows = [(f.rule, f"{f.file}:{f.line}", f.message)
            for f in report.failing]
    if rows:
        print(_table(rows))
    if report.unused_suppressions:
        print(f"note: {len(report.unused_suppressions)} unused "
              "suppression(s) — remove stale disables")
    for msg in over:
        print(f"BUDGET: {msg}")
    n_sup = len(report.suppressed)
    print(f"{report.files_checked} files checked: "
          f"{len(report.failing)} finding(s), "
          f"{n_sup} suppressed (see {BUDGET_FILE})"
          + ("" if ok else " — FAIL"))
    return 0 if ok else 1
