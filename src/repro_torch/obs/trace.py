"""Model-time tracing riding the charge-attribution clock.

A copy of ``repro/obs/trace.py``: the port imports nothing of ``repro``.

A :class:`Tracer` produces **spans** — named, categorized windows of a
task's timeline — without ever reading the wall clock.  The span
context lives in the same thread-local slot as the charge owner
(:mod:`repro_torch.core.clock`), travels across worker/sender/pool threads
through ``bind_charge_owner``, and is charged by ``Clock.sleep`` itself:
every model-second a thread sleeps lands on the innermost span open on
that thread (``Span.self_seconds``) and on the tracer's per-task
category tally.  That tally is what makes ``TaskStats.time_budget()``
exact — it is fed by the very same ``sleep`` calls that feed
``Clock.charged``, so the decomposition and the total can never drift.

Two export formats:

* :meth:`Tracer.export_jsonl` — the canonical, deterministic form.  One
  span per line, sorted by a semantic key, carrying only seed-stable
  fields (ids, names, categories, attrs, per-span self seconds) — byte-
  identical across same-seed runs of a deterministic scenario.  Global
  virtual timestamps are deliberately excluded: concurrent tasks all
  advance the shared virtual clock, so start offsets depend on thread
  interleaving even when every per-task quantity is exact.
* :meth:`Tracer.export_chrome` — Chrome trace-event JSON (``ph: "X"``
  complete events over virtual microseconds), loadable in Perfetto /
  ``chrome://tracing`` for a visual timeline.  Interleaving-dependent by
  construction; no byte-stability claim.

Span discipline: ``Tracer.span(...)`` may only be used as a ``with``
context manager (lint rule R006) — a leaked open span would swallow
every later charge on its thread and corrupt the time-budget sum.
"""

from __future__ import annotations

import json
import threading
from collections import deque

from ..core.clock import (_swap_trace_context, current_trace_context,
                          trace_context)

#: span categories with a fixed place in ``TaskStats.time_budget()``;
#: spans may use other categories, but these are the vocabulary the
#: data/control planes charge under (and the budget reports in order)
CATEGORIES = ("startup", "overhead", "wire", "integrity", "backoff",
              "replica", "session", "queue", "other")


class Span:
    """One traced window.  ``self_seconds`` is the model time charged by
    the owning thread while this span was its innermost — the
    deterministic quantity; ``t0``/``t1`` are global virtual timestamps
    kept for the Chrome export only.

    A span is its own ``with`` guard AND its own thread-local trace
    context: entering swaps it into the clock's attribution slot,
    ``Clock.sleep`` calls :meth:`charge` on it directly, and exiting
    restores the parent context and records the span.  One object per
    span — this path runs per traced storage op, so the earlier
    three-object form (guard + span + child context) was measurable
    fleet CPU."""

    __slots__ = ("tracer", "trace_id", "task_id", "name", "category",
                 "attrs", "t0", "t1", "self_seconds", "thread", "_prev",
                 "_entered")

    #: duck-type marker for ``Clock.sleep``-compatible contexts: both
    #: Span and the root _SpanCtx expose ``span``/``charge``
    def __init__(self, tracer, trace_id, task_id, name, category,
                 attrs, t0, thread):
        self.tracer = tracer
        self.trace_id = trace_id
        self.task_id = task_id
        self.name = name
        self.category = category
        self.attrs = attrs
        self.t0 = t0
        self.t1 = None
        self.self_seconds = 0.0
        self.thread = thread
        self._prev = None
        self._entered = False

    @property
    def span(self):
        """As a trace context, a Span is its own innermost span."""
        return self

    def charge(self, model_seconds: float) -> None:
        # hot path: this runs on EVERY Clock.sleep under a span.  The
        # span is owned by the thread that opened it, so the owner
        # accumulates lock-free; only a charge from a thread the
        # context was rebound onto (bind_charge_owner inside an open
        # span) pays the lock.  The per-task tally is folded once, at
        # span close.
        if self.thread == threading.get_ident():
            self.self_seconds += model_seconds
        else:
            with self.tracer._lock:
                self.self_seconds += model_seconds

    def __enter__(self):
        self.thread = threading.get_ident()
        self.t0 = self.tracer._now()
        self._prev = _swap_trace_context(self)
        self._entered = True
        return self

    def __exit__(self, *exc):
        if self._entered:
            self._entered = False
            _swap_trace_context(self._prev)
            self.t1 = self.tracer._now()
            self.tracer._record_span(self)
        return False

    def key(self):
        """Deterministic sort key for the canonical export."""
        return (self.trace_id, self.task_id, self.category, self.name,
                json.dumps(self.attrs, sort_keys=True),
                self.self_seconds)


class _SpanCtx:
    """Root trace context for a task binding: which trace/task spans
    opened on this thread attach to, before any span is open.
    Installed via ``repro_torch.core.clock.trace_context`` and captured
    across threads by ``bind_charge_owner``.  ``charge`` is the
    duck-typed hook ``Clock.sleep`` calls — at the root there is no
    open span, so the charge lands in the budget's ``other``
    remainder."""

    __slots__ = ("tracer", "trace_id", "task_id")

    #: a root context has no innermost span
    span = None

    def __init__(self, tracer, trace_id, task_id):
        self.tracer = tracer
        self.trace_id = trace_id
        self.task_id = task_id

    def charge(self, model_seconds: float) -> None:
        return


class _NullCM:
    """Shared no-op context manager: what a disabled tracer's ``bind``
    and ``span`` return, so instrumented code pays one attribute lookup
    and an empty ``with`` when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CM = _NullCM()


class Tracer:
    """Fleet-wide span collector.  Thread-safe; bounded (``max_spans``
    ring with an exact ``spans_dropped`` counter, mirroring the
    StatusBus subscriber discipline).  ``clock`` is any object with a
    ``virtual_elapsed`` attribute — virtual timestamps only, never wall
    time."""

    MAX_SPANS = 65536

    def __init__(self, clock=None, enabled: bool = True,
                 max_spans: int = MAX_SPANS):
        self.enabled = enabled
        self.clock = clock
        self.max_spans = max_spans
        self._spans: deque = deque()
        #: task_id -> {category -> model seconds charged under a span}
        self._tally: dict[str, dict[str, float]] = {}
        self.spans_recorded = 0
        self.spans_dropped = 0
        self.binds = 0
        self._lock = threading.Lock()

    # ---- binding ---------------------------------------------------------
    def bind(self, trace_id: str, task_id: str):
        """Root binding for a task run: every span opened (on this
        thread or any ``bind_charge_owner``-crossed thread) while the
        block is active attaches to ``trace_id``/``task_id``."""
        if not self.enabled:
            return _NULL_CM
        self.binds += 1
        return trace_context(_SpanCtx(self, trace_id, task_id))

    def span(self, name: str, category: str = "other", **attrs):
        """Open a span; ``with`` context manager ONLY (lint R006).
        Outside any tracer binding (no task context on this thread)
        there is nothing to attach to, so the no-op guard comes back."""
        if not self.enabled:
            return _NULL_CM
        parent = current_trace_context()
        if parent is None or not isinstance(parent, (Span, _SpanCtx)):
            return _NULL_CM
        return Span(self, parent.trace_id, parent.task_id, name,
                    category, attrs, 0.0, 0)

    def record(self, name: str, category: str, t0: float, t1: float,
               trace_id: str = "", task_id: str = "", **attrs) -> None:
        """Record a retroactive window (queue wait, breaker state
        window, federation handoff) that was observed, not slept
        through: it appears in exports but charges nothing to the
        time-budget tallies."""
        if not self.enabled:
            return
        span = Span(self, trace_id, task_id, name, category, attrs,
                    t0, 0)
        span.t1 = t1
        self._record_span(span)

    # ---- charge plumbing -------------------------------------------------
    def _now(self) -> float:
        return self.clock.virtual_elapsed if self.clock is not None \
            else 0.0

    def _record_span(self, span: Span) -> None:
        with self._lock:
            if span.task_id and span.self_seconds:
                per = self._tally.setdefault(span.task_id, {})
                per[span.category] = per.get(span.category, 0.0) \
                    + span.self_seconds
            if len(self._spans) >= self.max_spans:
                self._spans.popleft()
                self.spans_dropped += 1
            self._spans.append(span)
            self.spans_recorded += 1

    # ---- tallies ---------------------------------------------------------
    def category_seconds(self, task_id: str) -> dict[str, float]:
        """Snapshot of the per-category model seconds charged under
        spans for ``task_id`` (cumulative across runs/resumes — callers
        wanting a per-run delta snapshot before and after)."""
        with self._lock:
            return dict(self._tally.get(task_id, {}))

    def forget(self, task_id: str) -> None:
        """Drop a finished/exported task's tally so the table stays
        bounded over a long-lived fleet (sibling of ``Clock.forget``)."""
        with self._lock:
            self._tally.pop(task_id, None)

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    # ---- exports ---------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """Canonical deterministic export: one span per line, sorted by
        semantic key, seed-stable fields only.  Returns the number of
        lines written."""
        spans = sorted(self.spans(), key=Span.key)
        with open(path, "w") as fh:
            for s in spans:
                fh.write(json.dumps(
                    {"trace_id": s.trace_id, "task_id": s.task_id,
                     "name": s.name, "category": s.category,
                     "attrs": s.attrs,
                     "self_seconds": round(s.self_seconds, 9)},
                    sort_keys=True) + "\n")
        return len(spans)

    def export_chrome(self, path: str) -> int:
        """Chrome trace-event JSON over *virtual* microseconds — open it
        in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.  Complete
        (``ph: "X"``) events; pid = task, tid = a stable per-thread
        index in first-seen order."""
        spans = self.spans()
        tids: dict[int, int] = {}
        events = []
        for s in spans:
            tid = tids.setdefault(s.thread, len(tids))
            t1 = s.t1 if s.t1 is not None else s.t0
            events.append({
                "name": s.name, "cat": s.category, "ph": "X",
                "ts": round(s.t0 * 1e6, 3),
                "dur": round(max(0.0, t1 - s.t0) * 1e6, 3),
                "pid": s.task_id or s.trace_id or "fleet",
                "tid": tid,
                "args": dict(s.attrs, trace_id=s.trace_id,
                             self_seconds=round(s.self_seconds, 9)),
            })
        with open(path, "w") as fh:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, fh)
        return len(events)


#: shared disabled tracer: the default for a bare ``TransferService``
#: so un-instrumented construction paths pay (almost) nothing
NULL_TRACER = Tracer(enabled=False)
