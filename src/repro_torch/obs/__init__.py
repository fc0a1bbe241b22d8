"""Observability plane: model-time tracing + labeled metrics.

A copy of ``repro/obs/__init__.py``: the port imports nothing of ``repro``.

Two halves, both wall-clock-free (contract R001 holds here too):

* :mod:`repro_torch.obs.trace` — :class:`Tracer` spans riding the charge-
  attribution clock; deterministic JSONL + Perfetto-loadable Chrome
  trace exports; the per-task category tallies behind
  ``TaskStats.time_budget()``.
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` counters / gauges
  / histograms with fixed bucket bounds, absorbing the scattered
  per-plane counters via snapshot-time collectors, scraped as sorted
  Prometheus-flavoured text.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_BUCKETS)
from .trace import CATEGORIES, NULL_TRACER, Span, Tracer

__all__ = [
    "CATEGORIES", "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_TRACER", "Span", "Tracer",
]
