"""The port's federation plane (``repro_torch.fed``) and the scenario
runs built on it against the reference's.

* ``TransferSpec``'s JSON wire form is the same string in both packages,
  and a spec serialized by either package is read back by the other.
* ``run_federated`` (owner placement, one site failed mid-flight),
  ``run_fanout`` (one tree fanned out through the replica catalog, plain
  and under each catalog betrayal) and ``run_degraded("brownout")`` hold
  every invariant on the port, with the same per-task ``bytes_total`` and
  ``files_done`` and the same initial placements as the reference.

``chip_smoke.py``'s ``federate`` phase, which replicates a checkpoint
through the coordinator under faults and a site failure on the card, runs
here on the CPU at a small size.

Every runner uses a ``Clock(scale=0.0)``; the runners shut their managers
down (the fan-out's manager is shut down here); nothing asserts on wall
time."""

import importlib.util
import json
import os

import pytest

import repro.core  # noqa: F401  (imported before repro.fed / repro.sim: the reference's import cycle)
from repro.core.clock import Clock as JaxClock
from repro.core.transfer import TransferOptions as JaxTransferOptions
from repro.fed import PLACEMENT_POLICIES as JAX_PLACEMENT_POLICIES
from repro.fed import SPEC_STATES as JAX_SPEC_STATES
from repro.fed import TransferSpec as JaxTransferSpec
from repro.sim import ScenarioRunner as JaxScenarioRunner
from repro_torch.core.clock import Clock
from repro_torch.core.transfer import TransferOptions
from repro_torch.fed import (PLACEMENT_POLICIES, SPEC_STATES, FederatedCoordinator,
                             StrandedTasksError, TransferSpec)
from repro_torch.sim import ScenarioRunner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _specs(spec_cls, opts_cls):
    """A queued spec with options, and a paused one carrying markers,
    stats and replica hints, as a handoff sends them."""
    queued = spec_cls.new("t-0", "src-s0", "data/t0", "dst-ep", "out/t0", tenant="alice",
                          priority=2, options=opts_cls(integrity=True,
                                                       checksum_algorithm="lanesum32",
                                                       startup_cost=0.0),
                          route="posix->s3", n_files=3, nbytes=12345, origin_site="s0")
    paused = spec_cls.new("t-1", "src-s1", "data/t1", "dst-ep", "out/ü t1", tenant="bob",
                          options={"concurrency": 2}, nbytes=9000)
    paused.state = "paused"
    paused.trace_id = "trace-7"
    paused.stats = {"actual_model_seconds": 1.5, "resumes": 1}
    paused.markers = {"files": {"data/t1/a.bin": {"done": [[0, 4096], [8192, 808]],
                                                  "digests": {"0": "abc"}}}}
    paused.replicas = [{"content": "c", "size": 10, "src_sig": [10, 1.0],
                        "src_endpoint": "src-s1", "src_path": "data/t1/a.bin",
                        "endpoint_id": "dst-ep", "path": "out/a.bin", "site": "s1",
                        "digests": {}}]
    return [queued, paused]


def test_spec_wire_form_matches_reference():
    assert SPEC_STATES == JAX_SPEC_STATES
    for ref, port in zip(_specs(JaxTransferSpec, JaxTransferOptions),
                         _specs(TransferSpec, TransferOptions)):
        wire = port.to_json()
        assert wire == ref.to_json()
        assert port.to_payload() == ref.to_payload()
        back = TransferSpec.from_json(wire)
        assert back.to_json() == wire and back == port
        assert (back.done_bytes(), back.pending_bytes()) == (ref.done_bytes(),
                                                             ref.pending_bytes())


def test_spec_crosses_between_packages():
    """Each package reads the other's wire form and payload, and writes
    it back unchanged; unknown keys are ignored on both sides."""
    for ref, port in zip(_specs(JaxTransferSpec, JaxTransferOptions),
                         _specs(TransferSpec, TransferOptions)):
        assert TransferSpec.from_json(ref.to_json()).to_json() == ref.to_json()
        assert JaxTransferSpec.from_json(port.to_json()).to_json() == port.to_json()
        assert TransferSpec.from_payload(ref.to_payload()).to_json() == ref.to_json()
        assert JaxTransferSpec.from_payload(port.to_payload()).to_json() == port.to_json()
        extra = dict(json.loads(ref.to_json()), future_field=1)
        assert TransferSpec.from_json(json.dumps(extra)).to_json() == ref.to_json()
    bad = json.loads(_specs(TransferSpec, TransferOptions)[0].to_json())
    bad["state"] = "running"
    for cls in (TransferSpec, JaxTransferSpec):
        with pytest.raises(ValueError):
            cls.from_json(json.dumps(bad))


def test_coordinator_surface():
    assert PLACEMENT_POLICIES == JAX_PLACEMENT_POLICIES
    assert issubclass(StrandedTasksError, Exception)
    coord = FederatedCoordinator(placement="owner")
    try:
        coord.assert_third_party()
        assert coord.model_seconds() == 0.0
    finally:
        coord.shutdown(wait=False)


def _per_task(res):
    return [(r.task.stats.bytes_total, r.task.stats.files_done) for r in res.results]


def _first_placements(coord):
    first = {}
    for tid, sid, reason in coord.metrics.placement_log:
        if reason == "submit":
            first.setdefault(tid, sid)
    return first


def test_run_federated_matches_reference(tmp_path):
    kw = dict(n_sites=2, n_tasks=4, placement="owner", fail_site=True, strict=True)
    ref = JaxScenarioRunner(str(tmp_path / "ref"), clock=JaxClock(scale=0.0)).run_federated(**kw)
    port = ScenarioRunner(str(tmp_path / "port"), clock=Clock(scale=0.0)).run_federated(**kw)
    assert ref.ok and port.ok, (ref.violations, port.violations)
    assert _per_task(port) == _per_task(ref)
    assert _first_placements(port.coordinator) == _first_placements(ref.coordinator)
    assert port.moved and all(sid != "s1" for _, sid in port.moved)
    assert all(t.status == t.SUCCEEDED for t in port.tasks)
    for tid, _ in port.moved:
        assert port.coordinator.task(tid).stats.origin_site == "s1"
    port.coordinator.assert_third_party()


@pytest.mark.parametrize("chaos", ["none", "evict", "stale", "corrupt"])
def test_run_fanout_matches_reference(tmp_path, chaos):
    out = []
    for runner in (JaxScenarioRunner(str(tmp_path / "ref"), clock=JaxClock(scale=0.0)),
                   ScenarioRunner(str(tmp_path / "port"), clock=Clock(scale=0.0))):
        res = runner.run_fanout(n_fanout=4, chaos=chaos, strict=True)
        res.manager.shutdown(wait=True, timeout=60)
        assert res.ok, res.violations
        out.append(res)
    ref, port = out
    assert _per_task(port) == _per_task(ref)
    assert port.tree_bytes == ref.tree_bytes
    if chaos == "none":
        assert port.source_bytes == ref.source_bytes == port.tree_bytes
        assert port.replica_hits == ref.replica_hits > 0
    else:  # a betrayed catalog: more source bytes moved, never wrong bytes
        assert port.source_bytes >= 2 * port.tree_bytes
    assert all(r.dest == r.expected for r in port.results)


def test_run_degraded_brownout_matches_reference(tmp_path):
    ref = JaxScenarioRunner(str(tmp_path / "ref"), clock=JaxClock(scale=0.0)).run_degraded(
        "brownout", seed=0, strict=True)
    port = ScenarioRunner(str(tmp_path / "port"), clock=Clock(scale=0.0)).run_degraded(
        "brownout", seed=0, strict=True)
    assert ref.ok and port.ok, (ref.violations, port.violations)
    assert _per_task(port) == _per_task(ref)
    assert port.transitions[0] == "closed->open"
    assert port.transitions[-1] == "half-open->closed"
    assert port.retries_by_kind.get("HalfOpenProbe", 0) >= 1
    assert port.retries_by_kind.get("EndpointUnavailable", 0) >= 1
    assert all(r.task.status == r.task.SUCCEEDED and r.dest == r.expected
               for r in port.results)


def test_chip_smoke_federate_phase_on_cpu(tmp_path):
    """The card's federate phase on a small checkpoint on the CPU: both
    copies placed at the source's owner and handed off when it fails, faults
    injected and retried, the third copy served by the catalog, and every
    replica restored byte for byte (its digests on the CPU's plain path, so
    no kernel launch)."""
    torch = pytest.importorskip("torch")
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.connectors.posix import PosixConnector
    from repro_torch.kernels.checksum import kernel as cs_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g = torch.Generator().manual_seed(0)
    params = {"embed": {"table": torch.randn(1024, 2304, generator=g).to(torch.bfloat16)},
              "blocks": {"w": torch.randn(3, 1024, 1024, generator=g),
                         "b": torch.randn(3, 64, generator=g)},
              "norm": torch.ones(128)}
    save_checkpoint(params, PosixConnector(str(tmp_path)), "ckpt", step=3)
    row = smoke.federate(torch, (fa_kernel, cs_kernel, ssm_kernel), str(tmp_path), params,
                         torch.device("cpu"), ["cpu"], hold_bytes=6 << 20)
    assert row["placed"] == {"fed-s3": "s0", "fed-gcs": "s0"}
    assert row["handoffs"] and all(h["to"] != "s0" for h in row["handoffs"])
    assert row["faults_injected"]["transient"] > 0 and row["faults_injected"]["truncate"] > 0
    assert row["faults_retried"] > 0 and row["coordinator_model_s"] == 0.0
    third = row["copies"]["s3_catalog"]
    assert third["replica_hits"] == row["files"] and third["source_bytes_read"] == 0
    assert set(row["restores"]) == {"s3", "gcs", "s3_catalog"}
    assert row["checksum_launches"] == 0
