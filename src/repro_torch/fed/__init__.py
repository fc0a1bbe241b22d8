"""Federation plane: multiple site control planes, one third-party
coordinator.

A copy of ``repro/fed/__init__.py``: the port imports nothing of ``repro``.

* :mod:`repro_torch.fed.spec` — :class:`TransferSpec`, the JSON-round-trip
  submission value that lets a task (including a paused one, hole map
  and checksum fold riding along) move between control planes.
* :mod:`repro_torch.fed.coordinator` — :class:`FederatedCoordinator`:
  endpoint-ownership placement (owner / least-loaded /
  advisor-predicted-fastest), periodic queue-state digest exchange,
  task handoff, site-failure re-homing, a heartbeat monitor that
  auto-triggers failover from missed digests, and hysteresis-gated
  proactive rebalancing (:class:`RebalancePolicy`) — all without ever
  touching file bytes (enforced by the charge-attribution clock).
"""

from .coordinator import (PLACEMENT_POLICIES, FederatedCoordinator,
                          FedMetrics, QueueDigest, RebalancePolicy,
                          SiteHandle, StrandedTasksError)
from .spec import SPEC_STATES, TransferSpec

__all__ = [
    "FederatedCoordinator", "FedMetrics", "PLACEMENT_POLICIES",
    "QueueDigest", "RebalancePolicy", "SiteHandle", "SPEC_STATES",
    "StrandedTasksError", "TransferSpec",
]
