"""Failure-scenario simulation harness (chaos lab).

A copy of ``repro/sim/__init__.py``: the port imports nothing of ``repro``.

The paper sells the Connector abstraction on *managed* transfer —
automatic retries, restart markers, end-to-end integrity (§2.2, §4, §7)
— and the ROADMAP north-star demands a fabric that "handles as many
scenarios as you can imagine".  This package is where those scenarios
live:

* :mod:`repro_torch.sim.scenarios` — canonical source trees (many-small,
  few-large, mixed, deep/empty dirs, zero-byte files, unicode names),
  connector routes (posix / memory / emulated cloud, in every pairing),
  and a :class:`~repro_torch.sim.scenarios.ScenarioRunner` that drives
  :class:`~repro_torch.core.transfer.TransferService` under a seed-
  deterministic :class:`~repro_torch.core.faults.FaultSchedule` and checks
  end-state invariants: the destination tree is byte-exact on success,
  restart markers are cleared, ``TaskStats`` accounting is consistent,
  and failures are clean (recorded per file), never wedged.

Everything runs on the model :class:`~repro_torch.core.clock.Clock`, so a
scenario with seconds of injected latency still finishes instantly under
``REPRO_TIME_SCALE=0``, and the same seed replays the same fault
sequence into the same ``TaskStats``.
"""

from .scenarios import (ROUTES, TREES, DegradedScenarioResult,
                        FanoutScenarioResult, FederatedScenarioResult,
                        MultiScenarioResult, ScenarioResult, ScenarioRunner,
                        canonical_tree)

__all__ = ["ROUTES", "TREES", "DegradedScenarioResult",
           "FanoutScenarioResult", "FederatedScenarioResult",
           "MultiScenarioResult", "ScenarioResult", "ScenarioRunner",
           "canonical_tree"]
