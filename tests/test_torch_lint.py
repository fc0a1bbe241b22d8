"""The port's contract linter (``repro_torch.lint``) against the
reference's: each fixture tree, written once under ``src/repro/...`` and
once under ``src/repro_torch/...``, gives the same findings (rule, line,
message), suppressions and unused suppressions from each package's linter
over its own tree, with the path prefix mapped, so every rule is scoped to
the same layers of both packages.  The port's own tree passes
``python -m repro_torch.lint --check`` against its budget,
``lint-budget-torch.json``."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.lint.engine import run_lint as jax_run_lint
from repro.lint.rules import RULES as JAX_RULES
from repro_torch.lint.engine import (BUDGET_FILE, budget_violations, load_budget, run_lint,
                                     write_budget)
from repro_torch.lint.rules import RULES

REPO_ROOT = Path(__file__).resolve().parents[1]

#: one fixture per case: package-relative path -> source; each rule's
#: seeded violation, its scoping, a clean module, and the suppression forms
CASES = {
    "r001_wall_clock": {"core/thing.py": """\
        import time

        def poll():
            t0 = time.monotonic()
            return t0
        """},
    "r001_aliases": {"fed/thing.py": """\
        from time import monotonic as mono

        def poll():
            import time as _t
            _t.sleep(0.1)
            return mono()
        """},
    "r001_datetime_random": {"svc/thing.py": """\
        import datetime
        import random

        def stamp():
            return datetime.datetime.now(), random.random(), random.Random()
        """},
    "r001_clock_allowlisted": {"core/clock.py": """\
        import time

        def wall_now():
            return time.monotonic()
        """, "core/clock2.py": """\
        import time

        def wall_now():
            return time.monotonic()
        """},
    "r002_threads": {"connectors/thing.py": """\
        import threading
        from ..core.clock import bind_charge_owner

        def spawn(fn, pool):
            threading.Thread(target=fn, daemon=True).start()
            pool.submit(fn, 1)
            threading.Thread(target=bind_charge_owner(fn)).start()
        """, "catalog/thing.py": """\
        import threading

        def spawn(fn):
            threading.Thread(target=fn).start()
        """, "sim/thing.py": """\
        import threading

        def spawn(fn):
            threading.Thread(target=fn).start()
        """},
    "r003_locks": {"core/thing.py": """\
        class Q:
            def _pick_locked(self):
                return 1

            def pick(self):
                return self._pick_locked()

            def slow(self, clock, conn, session, path, ch):
                with self._lock:
                    clock.sleep(1.0)
                    conn.recv(session, path, ch)
                    return self._pick_locked()
        """},
    "r004_taxonomy": {"core/thing.py": """\
        def bad():
            try:
                raise Exception("boom")
            except Exception:
                pass
        """, "sim/thing.py": """\
        def tolerated():
            try:
                raise Exception("boom")
            except Exception:
                pass
        """},
    "r005_publish": {"svc/thing.py": """\
        class StatusBus:
            def publish(self, topic, data=None):
                self._fan_out(topic)

            def _fan_out(self, topic):
                self._cv.wait_for(lambda: True)
        """},
    "r006_spans": {"obs/thing.py": """\
        def traced(tracer):
            span = tracer.span("x")
            with tracer.span("y"):
                pass
            return span
        """},
    "clean": {"core/thing.py": """\
        import threading
        from .clock import Clock, bind_charge_owner, charge_to
        from .errors import TransientError

        class Worker:
            def __init__(self, clock):
                self.clock = clock
                self._lock = threading.Lock()

            def _pop_locked(self):
                return 1

            def run(self, task_id, pool, fn):
                with charge_to(task_id):
                    self.clock.sleep(0.5)
                with self._lock:
                    item = self._pop_locked()
                threading.Thread(target=bind_charge_owner(fn)).start()
                pool.submit(bind_charge_owner(fn), item)

            def fail(self):
                raise TransientError("routable")
        """},
    "suppressions": {"core/thing.py": """\
        import time

        def poll():
            a = time.monotonic()  # lint: disable=R001(fixture: sanctioned wall read)
            b = time.monotonic()  # lint: disable=R001
            c = time.time()  # lint: disable=R001(one),R002(not here)
            return a, b, c  # lint: disable=
        """, "launch/bench.py": """\
        def fine():
            return 1  # lint: disable=R001(stale: nothing to suppress)
        """},
    "syntax_error": {"data/broken.py": "def f(:\n    pass\n"},
}


def _write(root: Path, package: str, files: dict) -> None:
    for rel, src in files.items():
        p = root / "src" / package / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src), encoding="utf-8")


def _norm(report, package):
    """The report as plain tuples, its package prefix taken off the paths."""
    pfx = f"src/{package}/"

    def rows(fs):
        return sorted((f.rule, f.file.removeprefix(pfx), f.line, f.message, f.reason)
                      for f in fs)

    return {"findings": rows(report.findings), "meta": rows(report.meta),
            "suppressed": rows(report.suppressed),
            "unused": sorted((s.rule, s.line, s.reason) for s in report.unused_suppressions),
            "files": report.files_checked,
            "counts": {k.removeprefix(pfx): v for k, v in report.suppression_counts().items()}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_match_reference(tmp_path, case):
    _write(tmp_path / "ref", "repro", CASES[case])
    _write(tmp_path / "port", "repro_torch", CASES[case])
    ref = _norm(jax_run_lint(tmp_path / "ref"), "repro")
    port = _norm(run_lint(tmp_path / "port"), "repro_torch")
    assert port == ref
    if case != "clean":
        assert port["findings"] or port["meta"] or port["suppressed"], "the case found nothing"


def test_reasonless_suppression_is_r000_in_both(tmp_path):
    files = {"core/thing.py": "import time\nt = time.monotonic()  # lint: disable=R001\n"}
    _write(tmp_path / "ref", "repro", files)
    _write(tmp_path / "port", "repro_torch", files)
    for report in (jax_run_lint(tmp_path / "ref"), run_lint(tmp_path / "port")):
        assert [(f.rule, f.line) for f in report.failing] == [("R000", 2), ("R001", 2)]


def test_rules_match_reference():
    assert {k: v[0] for k, v in RULES.items()} == {k: v[0] for k, v in JAX_RULES.items()}


def test_budget_round_trip_and_growth_fails(tmp_path):
    _write(tmp_path, "repro_torch", CASES["suppressions"])
    report = run_lint(tmp_path)
    path = tmp_path / BUDGET_FILE
    write_budget(path, report)
    budget = load_budget(path)
    assert budget == {"src/repro_torch/core/thing.py": {"R001": 2}}
    assert budget_violations(report, budget) == []
    assert budget_violations(report, {}) and BUDGET_FILE in budget_violations(report, {})[0]


def _cli(*args, cwd=REPO_ROOT):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.lint", *args], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=120)


def test_port_tree_passes_check():
    """``python -m repro_torch.lint --check`` on the port: no unsuppressed
    finding, every suppression carries a reason, none unused, and the
    suppressions within ``lint-budget-torch.json``."""
    proc = _cli("--check", "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["ok"] is True and payload["findings"] == []
    assert payload["budget_violations"] == [] and payload["unused_suppressions"] == []
    assert payload["suppressed"] and all(f["reason"] for f in payload["suppressed"])
    assert all(f["file"].startswith("src/repro_torch/") for f in payload["suppressed"])
    assert payload["files_checked"] >= 80
    report = run_lint(REPO_ROOT)
    assert report.suppression_counts() == load_budget(REPO_ROOT / BUDGET_FILE)


def test_cli_reports_seeded_violation(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "core" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import time\nt = time.time()\n", encoding="utf-8")
    proc = _cli("--check", "--json", "--root", str(tmp_path))
    assert proc.returncode == 1
    payload = json.loads(proc.stdout)
    assert [(f["rule"], f["file"], f["line"]) for f in payload["findings"]] == \
        [("R001", "src/repro_torch/core/bad.py", 2)]
