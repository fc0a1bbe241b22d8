"""Contract linter: AST-based invariant checker for the repo's
clock/charge/lock/health contracts.

A copy of ``repro/lint/__init__.py``: the port imports nothing of ``repro``.

The transfer stack's correctness rests on conventions no runtime test
can see from the outside: model-time-only sleeps charged to a bound
owner, third-party coordinators that never touch bytes, ``*_locked``
lock discipline, the breaker error taxonomy, and publish-never-blocks
in the service plane.  This package machine-checks them as named rules
(R001-R005, see :mod:`repro_torch.lint.rules`), with per-line reasoned
suppressions and a committed budget (:mod:`repro_torch.lint.engine`) so new
violations fail CI while grandfathered ones stay visible.

Run ``python -m repro_torch.lint --check`` (the CI lint lane).
"""

from .engine import (LintReport, budget_violations, lint_file, load_budget,
                     run_lint, write_budget)
from .rules import RULES, Finding, ModuleInfo

__all__ = ["Finding", "LintReport", "ModuleInfo", "RULES",
           "budget_violations", "lint_file", "load_budget", "run_lint",
           "write_budget"]
