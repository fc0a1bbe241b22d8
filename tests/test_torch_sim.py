"""The port's scenario harness (``repro_torch.sim``) against the reference's:
the same seeded scenario, run through each package's ``ScenarioRunner``,
ends in the same ``ScenarioResult.fingerprint()``, and both runs hold
every end-state invariant.

The cases are every canonical tree over every route with an empty
schedule, and the seeded transient, rate-limit, bit-flip, truncation and
session-drop schedules of ``tests/test_chaos_scenarios.py`` over its three
chaos routes.  Every runner uses a ``Clock(scale=0.0)`` (injected latency
is accounting only) and nothing asserts on wall time."""

import pytest

import repro.core  # noqa: F401  (imported before repro.sim: the reference's import cycle)
from repro.core.clock import Clock as JaxClock
from repro.core.faults import FaultSchedule as JaxFaultSchedule
from repro.core.transfer import TransferOptions as JaxTransferOptions
from repro.sim import ROUTES as JAX_ROUTES
from repro.sim import TREES as JAX_TREES
from repro.sim import ScenarioRunner as JaxScenarioRunner
from repro.sim import canonical_tree as jax_canonical_tree
from repro_torch.core.clock import Clock
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.transfer import TransferOptions
from repro_torch.sim import ROUTES, TREES, ScenarioRunner, canonical_tree

KB = 1024

#: tests/test_chaos_scenarios.py::CHAOS_ROUTES
CHAOS_ROUTES = ("posix->memory", "posix->cloud", "cloud->memory")

#: name -> (tree, schedule builder over a FaultSchedule class, options?):
#: the seeded schedules of tests/test_chaos_scenarios.py
SCHEDULES = {
    "transient": ("mixed", lambda FS: FS(seed=2).transient(op="recv*", at=1, times=1), False),
    "rate_limit": ("many-small", lambda FS: FS(seed=3).rate_limit(
        op="recv*", at=1, times=1, retry_after=0.25), False),
    "bit_flip": ("few-large", lambda FS: FS(seed=4).bit_flip(at=1, times=1), True),
    "truncate": ("few-large", lambda FS: FS(seed=6).truncate(
        after_bytes=100 * KB, at=1, times=1), False),
    "session_drop": ("many-small", lambda FS: FS(seed=5).session_drop(
        op="recv_batch", at=1, times=1), False),
}

JAX = (JaxScenarioRunner, JaxFaultSchedule, JaxClock, JaxTransferOptions)
PORT = (ScenarioRunner, FaultSchedule, Clock, TransferOptions)


def _run(side, base, tree, route, schedule=None, integrity=False):
    """One strict scenario through one package's runner; -> its result."""
    runner_cls, fs_cls, clock_cls, opts_cls = side
    runner = runner_cls(str(base), clock=clock_cls(scale=0.0))
    kw = {}
    if schedule is None:  # an empty schedule on both ends: no fault may be invented
        sched, kw["proxy"] = fs_cls(seed=1), "both"
    else:
        sched = SCHEDULES[schedule][1](fs_cls)
    if integrity:
        kw["options"] = opts_cls(startup_cost=0.0, integrity=True, retry_backoff=0.01)
    return runner.run(tree=tree, route=route, schedule=sched, strict=True, **kw)


def test_trees_and_routes_match_reference():
    assert ROUTES == JAX_ROUTES
    assert sorted(TREES) == sorted(JAX_TREES)
    for kind in TREES:
        assert canonical_tree(kind, 3) == jax_canonical_tree(kind, 3), kind


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("tree", sorted(TREES))
def test_empty_schedule_fingerprint_matches_reference(tmp_path, tree, route):
    ref = _run(JAX, tmp_path / "ref", tree, route)
    port = _run(PORT, tmp_path / "port", tree, route)
    assert ref.ok and port.ok, (ref.violations, port.violations)
    assert port.fingerprint() == ref.fingerprint()
    assert port.fingerprint()["faults_retried"] == 0
    assert port.dest == port.expected


@pytest.mark.parametrize("route", CHAOS_ROUTES)
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_seeded_schedule_fingerprint_matches_reference(tmp_path, schedule, route):
    tree, _, integrity = SCHEDULES[schedule]
    ref = _run(JAX, tmp_path / "ref", tree, route, schedule, integrity)
    port = _run(PORT, tmp_path / "port", tree, route, schedule, integrity)
    assert ref.ok and port.ok, (ref.violations, port.violations)
    fp = port.fingerprint()
    assert fp == ref.fingerprint()
    assert fp["events"], "the schedule fired no fault"
    assert fp["status"] == "SUCCEEDED"
    assert port.dest == port.expected
