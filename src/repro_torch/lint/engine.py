"""Walk + scope + suppress + budget: the linter's driver.

A copy of ``repro/lint/engine.py``: the port imports nothing of ``repro``.

Scoping
-------
Rules apply by repo-relative path (so fixtures in a temp tree that
mirrors ``src/repro_torch/...`` exercise the exact production scoping):

* **R001** everywhere under ``src/repro_torch/`` except ``core/clock.py`` —
  the clock implementation is the one sanctioned owner of real time
  (including the ``wall_now``/``wall_sleep`` harness helpers).
* **R002** the transfer stack only (``core/``, ``connectors/``,
  ``fed/``, ``svc/``, ``catalog/``) — the layers whose model time is
  charge-accounted.
* **R003** everywhere (it only fires on the ``*_locked`` /
  ``self._lock`` idiom).
* **R004** ``core/`` only, where the breaker taxonomy is load-bearing.
* **R005** ``svc/`` (the ``StatusBus.publish`` entry point).
* **R006** everywhere (it only fires on the ``*.span(...)`` idiom —
  the observability plane's context-manager-only span discipline).

Suppressions
------------
One line, same line as the finding::

    t0 = time.monotonic()  # lint: disable=R001(wall_seconds is real elapsed time by design)

The parenthesized reason is REQUIRED — a reason-less suppression is
itself reported as ``R000`` and cannot be suppressed.  Multiple rules:
``# lint: disable=R001(why),R002(why)``.  Reasons may not contain
``)``.

Budget
------
``lint-budget-torch.json`` (repo root) records the blessed suppression count
per ``(file, rule)``.  ``--check`` fails on any unsuppressed finding
AND on suppression growth past the budget — so a new violation cannot
ride in under a fresh ``disable`` comment without a reviewed budget
bump — while grandfathered suppressions stay visible in every report.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from pathlib import Path

from .rules import RULES, Finding, ModuleInfo

#: default budget filename, at the repo root
BUDGET_FILE = "lint-budget-torch.json"

#: files R001 does not apply to — the clock owns real time
R001_ALLOWLIST = {"src/repro_torch/core/clock.py"}
#: transfer-stack prefixes R002 applies to
R002_SCOPE = ("src/repro_torch/core/", "src/repro_torch/connectors/",
              "src/repro_torch/fed/", "src/repro_torch/svc/",
              "src/repro_torch/catalog/")
R004_SCOPE = ("src/repro_torch/core/",)
R005_SCOPE = ("src/repro_torch/svc/",)

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=(.*)$")
_ITEM_RE = re.compile(r"(R\d{3})\s*(?:\(([^)]*)\))?")


def rule_applies(rule: str, rel: str) -> bool:
    if rule == "R001":
        return rel not in R001_ALLOWLIST
    if rule == "R002":
        return rel.startswith(R002_SCOPE)
    if rule == "R004":
        return rel.startswith(R004_SCOPE)
    if rule == "R005":
        return rel.startswith(R005_SCOPE)
    return True


@dataclass
class Suppression:
    rule: str
    line: int
    reason: str
    used: bool = False


def parse_suppressions(rel: str, source: str
                       ) -> tuple[dict[tuple[str, int], Suppression],
                                  list[Finding]]:
    """Per-line ``# lint: disable=`` markers -> {(rule, line): Suppression},
    plus R000 findings for reason-less markers."""
    sups: dict[tuple[str, int], Suppression] = {}
    meta: list[Finding] = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m is None:
            continue
        items = list(_ITEM_RE.finditer(m.group(1)))
        if not items:
            meta.append(Finding(
                "R000", rel, lineno,
                "malformed suppression: expected R00x(reason)"))
            continue
        for item in items:
            rule, reason = item.group(1), (item.group(2) or "").strip()
            if not reason:
                meta.append(Finding(
                    "R000", rel, lineno,
                    f"suppression of {rule} carries no reason — every "
                    "disable must say why"))
                continue
            sups[(rule, lineno)] = Suppression(rule, lineno, reason)
    return sups, meta


@dataclass
class LintReport:
    """Everything one run produced, pre-budget-verdict."""

    findings: list[Finding] = field(default_factory=list)  # unsuppressed
    suppressed: list[Finding] = field(default_factory=list)
    #: R000 meta-findings (reason-less suppressions) + parse failures
    meta: list[Finding] = field(default_factory=list)
    unused_suppressions: list[Suppression] = field(default_factory=list)
    files_checked: int = 0

    def suppression_counts(self) -> dict[str, dict[str, int]]:
        out: dict[str, dict[str, int]] = {}
        for f in self.suppressed:
            out.setdefault(f.file, {}).setdefault(f.rule, 0)
            out[f.file][f.rule] += 1
        return out

    @property
    def failing(self) -> list[Finding]:
        return self.meta + self.findings


def lint_file(path: Path, rel: str) -> tuple[list[Finding], list[Finding],
                                             list[Suppression]]:
    """-> (unsuppressed, suppressed, unused suppressions) for one file.
    A file that does not parse is one R000 finding (the compile lane
    owns syntax errors; the linter just refuses to vouch for the file).
    """
    source = path.read_text(encoding="utf-8")
    sups, meta = parse_suppressions(rel, source)
    try:
        mod = ModuleInfo.parse(rel, source)
    except SyntaxError as e:
        return (meta + [Finding("R000", rel, e.lineno or 1,
                                f"does not parse: {e.msg}")], [], [])
    raw: list[Finding] = []
    for rule, (_title, check) in RULES.items():
        if rule_applies(rule, rel):
            raw.extend(check(mod))
    open_, closed = list(meta), []
    for f in sorted(raw, key=lambda f: (f.line, f.rule)):
        sup = sups.get((f.rule, f.line))
        if sup is not None:
            sup.used = True
            f.suppressed, f.reason = True, sup.reason
            closed.append(f)
        else:
            open_.append(f)
    unused = [s for s in sups.values() if not s.used]
    return open_, closed, unused


def iter_targets(root: Path, paths: list[str] | None) -> list[Path]:
    """Python files to lint: explicit paths (files or dirs), or the
    default ``src/repro_torch`` tree under ``root``.  The linter's own
    package is excluded — its rule docs and regexes quote the very
    tokens the rules ban."""
    bases = [Path(p) if os.path.isabs(p) else root / p
             for p in (paths or ["src/repro_torch"])]
    out: list[Path] = []
    for base in bases:
        if base.is_file():
            out.append(base)
        else:
            out.extend(p for p in sorted(base.rglob("*.py"))
                       if "lint" not in p.parts)
    return out


def run_lint(root: Path, paths: list[str] | None = None) -> LintReport:
    report = LintReport()
    for path in iter_targets(root, paths):
        rel = path.resolve().relative_to(root.resolve()).as_posix()
        open_, closed, unused = lint_file(path, rel)
        report.findings.extend(open_)
        report.suppressed.extend(closed)
        report.unused_suppressions.extend(unused)
        report.files_checked += 1
    # split R000 back out of findings (kept in order above for locality)
    report.meta = [f for f in report.findings if f.rule == "R000"]
    report.findings = [f for f in report.findings if f.rule != "R000"]
    return report


# --------------------------------------------------------------------------
# budget
# --------------------------------------------------------------------------


def load_budget(path: Path) -> dict[str, dict[str, int]]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text(encoding="utf-8"))
    return data.get("suppressions", {})


def write_budget(path: Path, report: LintReport) -> None:
    payload = {
        "_comment": "Blessed # lint: disable= counts per (file, rule). "
                    "Grown only by review: regenerate with "
                    "`python -m repro_torch.lint --write-budget`.",
        "suppressions": {f: dict(sorted(rules.items())) for f, rules in
                         sorted(report.suppression_counts().items())},
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


def budget_violations(report: LintReport,
                      budget: dict[str, dict[str, int]]) -> list[str]:
    """Messages for every (file, rule) whose live suppression count
    exceeds its budgeted count (absent = 0): new violations must be
    fixed or get a reviewed budget bump, not a drive-by disable."""
    out = []
    for file, rules in sorted(report.suppression_counts().items()):
        for rule, n in sorted(rules.items()):
            allowed = budget.get(file, {}).get(rule, 0)
            if n > allowed:
                out.append(
                    f"{file}: {n} {rule} suppressions exceed the "
                    f"budgeted {allowed} — fix the new violation or "
                    f"regenerate {BUDGET_FILE} under review")
    return out
