"""Service plane: subscription-based status streaming (see bus.py).

A copy of ``repro/svc/__init__.py``: the port imports nothing of ``repro``.

Re-exports the public surface so callers write ``from repro_torch.svc import
StatusBus`` — the module layout stays an implementation detail.
"""

from .bus import EVENT_TYPES, StatusBus, StatusEvent, Subscription

__all__ = ["EVENT_TYPES", "StatusBus", "StatusEvent", "Subscription"]
