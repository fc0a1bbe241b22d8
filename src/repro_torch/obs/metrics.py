"""Labeled metrics registry — counters, gauges, histograms — with no
wall time anywhere.

A copy of ``repro/obs/metrics.py``: the port imports nothing of ``repro``.

The fleet already counts things in four ad-hoc places (``ManagerMetrics``
dataclass fields, ``EndpointHealth.snapshot()``, ``ReplicaCatalog.
stats()``, ``StatusBus.published``).  Those stay — tests and operators
read them directly — but :class:`MetricsRegistry` absorbs them behind
one labeled namespace: native instruments for the hot-path series
(``repro_tasks_total{site,tenant,status}``-style), plus **collectors**
(zero-arg callables returning ``{metric_name: value}`` or
``{metric_name: {label_key: value}}``) that pull the per-plane dataclass
counters in at snapshot/scrape time, so absorbing a plane costs one
``register_collector`` call and no churn in the plane itself.

Determinism: histogram bucket bounds are fixed at construction,
snapshots and scrapes are sorted by (name, labels) — two runs of a
deterministic scenario produce identical scrape text.
"""

from __future__ import annotations

import threading

#: default histogram bounds (model seconds): geometric-ish ladder wide
#: enough for both sub-second control-plane waits and hour-long chaos
#: tasks; fixed so same-seed runs bucket identically
DEFAULT_BUCKETS = (0.005, 0.02, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, 300.0, 1800.0)


def _label_key(labels: dict) -> tuple:
    """Canonical hashable form: sorted (k, str(v)) pairs."""
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonic labeled counter."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._samples: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._samples.get(_label_key(labels), 0.0)

    def samples(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._samples)


class Gauge(Counter):
    """Labeled point-in-time value (``set`` replaces, ``inc`` adjusts)."""

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._samples[_label_key(labels)] = value


class Histogram:
    """Labeled histogram over fixed, deterministic bucket bounds.
    Cumulative bucket counts plus sum/count, Prometheus-style."""

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        #: label key -> [per-bucket counts..., +Inf count]
        self._counts: dict[tuple, list] = {}
        self._sums: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def snapshot(self) -> dict[tuple, dict]:
        """label key -> {"count", "sum", "buckets": {bound: cumulative}}
        (cumulative counts, le-style)."""
        out = {}
        with self._lock:
            for key, counts in self._counts.items():
                cum, buckets = 0, {}
                for bound, n in zip(self.buckets, counts):
                    cum += n
                    buckets[bound] = cum
                out[key] = {"count": cum + counts[-1],
                            "sum": self._sums.get(key, 0.0),
                            "buckets": buckets}
        return out


class MetricsRegistry:
    """One scrape surface for the whole fleet.

    Instruments are memoized by name (two ``counter("x")`` calls return
    the same object); collectors are pulled at snapshot/scrape time so
    legacy per-plane counters need no write-path changes."""

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._instruments: dict[str, object] = {}
        self._collectors: list = []
        self._lock = threading.Lock()

    def _full(self, name: str) -> str:
        return f"{self.namespace}_{name}" if self.namespace else name

    def _get(self, name: str, cls, **kw):
        full = self._full(name)
        with self._lock:
            inst = self._instruments.get(full)
            if inst is None:
                inst = cls(full, **kw)
                self._instruments[full] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {full!r} already registered as "
                    f"{type(inst).__name__}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, help=help, buckets=buckets)

    def register_collector(self, fn) -> None:
        """``fn() -> {name: value}`` or ``{name: {label_key: value}}``;
        called at snapshot/scrape time.  Names are namespaced on the
        way out; a collector that raises is skipped (scraping must
        never take the fleet down)."""
        with self._lock:
            self._collectors.append(fn)

    # ---- read side -------------------------------------------------------
    def _collected(self) -> dict:
        out: dict = {}
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                got = fn() or {}
            except Exception:
                continue
            for name, value in got.items():
                out[self._full(name)] = value
        return out

    def snapshot(self) -> dict:
        """Deterministically-ordered nested dict of every sample:
        ``{metric: {label_string: value}}`` for counters/gauges,
        ``{metric: {label_string: {count, sum, buckets}}}`` for
        histograms, plus collector outputs."""
        out: dict = {}
        with self._lock:
            instruments = dict(self._instruments)
        for name in sorted(instruments):
            inst = instruments[name]
            if isinstance(inst, Histogram):
                snap = inst.snapshot()
                out[name] = {_render_labels(k): snap[k]
                             for k in sorted(snap)}
            else:
                samples = inst.samples()
                out[name] = {_render_labels(k): samples[k]
                             for k in sorted(samples)}
        collected = self._collected()
        for name in sorted(collected):
            out.setdefault(name, collected[name])
        return out

    def scrape(self) -> str:
        """Prometheus-flavoured text exposition, line-sorted within
        each metric — stable across same-seed runs."""
        lines: list[str] = []
        with self._lock:
            instruments = dict(self._instruments)
        for name in sorted(instruments):
            inst = instruments[name]
            if getattr(inst, "help", ""):
                lines.append(f"# HELP {name} {inst.help}")
            if isinstance(inst, Histogram):
                lines.append(f"# TYPE {name} histogram")
                snap = inst.snapshot()
                for key in sorted(snap):
                    s = snap[key]
                    base = dict(key)
                    for bound in inst.buckets:
                        lk = _render_labels(_label_key(
                            dict(base, le=f"{bound:g}")))
                        lines.append(
                            f"{name}_bucket{lk} {s['buckets'][bound]}")
                    lk = _render_labels(_label_key(
                        dict(base, le="+Inf")))
                    lines.append(f"{name}_bucket{lk} {s['count']}")
                    lines.append(
                        f"{name}_sum{_render_labels(key)} {s['sum']:g}")
                    lines.append(
                        f"{name}_count{_render_labels(key)} "
                        f"{s['count']}")
            else:
                kind = "gauge" if isinstance(inst, Gauge) else "counter"
                lines.append(f"# TYPE {name} {kind}")
                samples = inst.samples()
                for key in sorted(samples):
                    lines.append(
                        f"{name}{_render_labels(key)} "
                        f"{samples[key]:g}")
        collected = self._collected()
        for name in sorted(collected):
            value = collected[name]
            if isinstance(value, dict):
                for lk in sorted(value, key=str):
                    lines.append(f'{name}{{key="{lk}"}} '
                                 f"{value[lk]:g}")
            else:
                lines.append(f"{name} {value:g}")
        return "\n".join(lines) + "\n"
