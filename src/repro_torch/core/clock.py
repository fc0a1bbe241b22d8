"""Scaled clock + emulated network links.

A copy of ``repro/core/clock.py``: the port imports nothing of ``repro``.

The WAN/cloud environment of the paper is emulated deterministically:
every latency/bandwidth constant is expressed in *model seconds* and
multiplied by a global ``time_scale`` before any real sleep happens.
``time_scale=0`` turns all waits into pure accounting (used by unit
tests); benchmarks use a small positive scale so that measured
wall-clock times are dominated by the modeled terms.

The link model reproduces the phenomena the paper measures:

* per-API-call round-trip latency  -> per-file overhead ``t0`` (Eq. 4)
* per-stream vs aggregate bandwidth -> throughput-vs-concurrency curves
  (Figs. 13-17): rate = min(per_stream, aggregate / active_streams)
* local contention                  -> slight decline past saturation
  ("aggregated throughput first increases ... and eventually drops
  slowly, because of local contention", §6)
"""

from __future__ import annotations

import functools
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


def _env_scale() -> float:
    return float(os.environ.get("REPRO_TIME_SCALE", "0.0"))


# --------------------------------------------------------------------------
# sanctioned wall-clock escape hatch
# --------------------------------------------------------------------------
# Model time only advances while charged work runs, so a *model*
# deadline can never fire against a wedged real thread — harnesses and
# cv-slicing loops that bound REAL threads (scenario kill windows, the
# coordinator's caller-facing wait_all timeout) genuinely need the wall
# clock.  They get it from these two helpers and nowhere else: the
# contract linter (rule R001, ``python -m repro_torch.lint``) bans direct
# ``time.time/monotonic/sleep`` outside this module, so every wall
# read in the stack is greppable as wall_now/wall_sleep and auditable
# here.  Neither helper charges model time; code that does model-visible
# waiting must go through ``Clock.sleep`` under a bound charge owner.


def wall_now() -> float:
    """Monotonic *wall* seconds — for bounding real threads that may
    wedge, never for stamping model-visible state."""
    return time.monotonic()


def wall_sleep(seconds: float) -> None:
    """Real sleep — for harness polls between wall_now() checks."""
    time.sleep(seconds)


# --------------------------------------------------------------------------
# charge attribution
# --------------------------------------------------------------------------
#: thread-local charge owner, shared by every Clock instance so one task
#: keeps a single identity across the service clock, link clocks, and
#: fault-schedule clocks
_attribution = threading.local()


def current_charge_owner() -> str | None:
    """The owner (task id) the current thread charges model time to."""
    return getattr(_attribution, "owner", None)


def current_trace_context():
    """The observability span context active on this thread, or ``None``.

    Opaque to the clock: :mod:`repro_torch.obs` installs a context object via
    :func:`trace_context`, and :meth:`Clock.sleep` calls its ``charge``
    hook so every model-second lands on the innermost open span.  The
    clock never imports ``obs`` — the coupling is one duck-typed method.
    """
    return getattr(_attribution, "trace", None)


@contextmanager
def charge_to(owner: str | None):
    """Attribute every model-time charge made by this thread (latency,
    bandwidth, backoff, injected delay) to ``owner`` for the duration of
    the block.  Nests: the previous owner is restored on exit."""
    prev = getattr(_attribution, "owner", None)
    _attribution.owner = owner
    try:
        yield
    finally:
        _attribution.owner = prev


def _swap_trace_context(ctx):
    """Install ``ctx`` as the thread's span context and return the
    previous one.  The raw form of :func:`trace_context` for the span
    enter/exit hot path, where a generator context manager per span is
    measurable fleet overhead; callers MUST restore the returned
    previous context themselves."""
    prev = getattr(_attribution, "trace", None)
    _attribution.trace = ctx
    return prev


@contextmanager
def trace_context(ctx):
    """Make ``ctx`` the thread's active span context for the duration of
    the block (the tracing sibling of :func:`charge_to`).  Nests: the
    previous context is restored on exit."""
    prev = getattr(_attribution, "trace", None)
    _attribution.trace = ctx
    try:
        yield
    finally:
        _attribution.trace = prev


def bind_charge_owner(fn):
    """Capture the *calling* thread's charge owner — and its active span
    context — and re-establish both in whichever thread eventually runs
    ``fn``.  This is how attribution crosses thread boundaries: per-task
    worker threads, sender threads, connector stream pools, and —
    critically — session-level batch pools that are shared across tasks
    (the owner is captured per submitted work item, not per pool
    thread).  Spans opened on the far side of the boundary therefore
    attach to the same task timeline as the submitting thread's."""
    owner = current_charge_owner()
    trace = current_trace_context()
    if owner is None and trace is None:
        return fn

    @functools.wraps(fn)
    def bound(*args, **kwargs):
        with charge_to(owner), trace_context(trace):
            return fn(*args, **kwargs)

    return bound


class Clock:
    """Monotonic clock whose sleeps are scaled; also keeps *virtual*
    elapsed accounting so tests with scale=0 can still assert on modeled
    time.

    Sub-millisecond scaled sleeps are batched per thread (a "sleep
    debt") so emulation fidelity survives small scales — Python's
    ``time.sleep`` has ~0.1 ms of overhead that would otherwise swamp
    the modeled latencies.
    """

    MIN_REAL_SLEEP = 1e-3

    def __init__(self, scale: float | None = None):
        self.scale = _env_scale() if scale is None else scale
        self._virtual = 0.0
        self._lock = threading.Lock()
        self._debt = threading.local()
        #: owner -> model seconds charged while that owner was current
        self._charges: dict[str, float] = {}

    def sleep(self, model_seconds: float) -> None:
        if model_seconds <= 0:
            return
        owner = current_charge_owner()
        with self._lock:
            self._virtual += model_seconds
            if owner is not None:
                self._charges[owner] = \
                    self._charges.get(owner, 0.0) + model_seconds
        trace = getattr(_attribution, "trace", None)
        if trace is not None:
            # outside self._lock: the span context takes its own lock
            trace.charge(model_seconds)
        if self.scale <= 0:
            return
        real = model_seconds * self.scale
        debt = getattr(self._debt, "v", 0.0) + real
        if debt >= self.MIN_REAL_SLEEP:
            self._debt.v = 0.0
            time.sleep(debt)
        else:
            self._debt.v = debt

    @property
    def virtual_elapsed(self) -> float:
        return self._virtual

    def charged(self, owner: str) -> float:
        """Model seconds charged to ``owner`` on this clock.  Unlike
        ``virtual_elapsed`` (which every concurrent task inflates), this
        is exact per task: concurrent tasks partition the clock's total
        instead of each observing all of it."""
        with self._lock:
            return self._charges.get(owner, 0.0)

    def forget(self, owner: str) -> None:
        """Drop a finished owner's tally so the charge table stays
        bounded over a long-lived fleet."""
        with self._lock:
            self._charges.pop(owner, None)

    def now(self) -> float:
        return time.monotonic()


DEFAULT_CLOCK = Clock()


@dataclass
class TokenBucket:
    """API call-quota model (Google Drive / Box, paper §4).

    ``rate`` calls per model-second, burst ``capacity``.  When empty,
    raises through the caller as a RateLimitError with a retry hint.
    """

    rate: float
    capacity: float
    clock: Clock = field(default_factory=lambda: DEFAULT_CLOCK)

    def __post_init__(self):
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._vlast = 0.0
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> float:
        """Returns 0.0 on success, else model-seconds to wait."""
        with self._lock:
            now = time.monotonic()
            if self.clock.scale > 0:
                elapsed_model = (now - self._last) / self.clock.scale
            else:
                # Pure-accounting mode: refill from virtual clock.
                elapsed_model = self.clock.virtual_elapsed - self._vlast
            self._last = now
            self._vlast = self.clock.virtual_elapsed
            self._tokens = min(self.capacity, self._tokens + elapsed_model * self.rate)
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate


@dataclass
class Link:
    """A network hop.  Bandwidths in model-bytes per model-second.

    ``transmit`` charges time in chunks so the effective per-stream rate
    reacts to how many streams are concurrently active (the paper's
    concurrency behaviour).
    """

    name: str
    rtt: float  # model seconds, one round trip
    per_stream_bw: float  # B/s a single TCP stream can carry
    aggregate_bw: float  # B/s the whole link can carry
    contention: float = 0.015  # fractional agg-bw loss per stream past knee
    chunk: int = 1 << 21
    clock: Clock = field(default_factory=lambda: DEFAULT_CLOCK)

    def __post_init__(self):
        self._active = 0
        self._lock = threading.Lock()

    def round_trip(self, n: int = 1) -> None:
        self.clock.sleep(self.rtt * n)

    def _per_stream_rate(self) -> float:
        with self._lock:
            act = max(1, self._active)
        knee = max(1.0, self.aggregate_bw / self.per_stream_bw)
        agg = self.aggregate_bw
        if act > knee:
            agg *= max(0.3, 1.0 - self.contention * (act - knee))
        return min(self.per_stream_bw, agg / act)

    def transmit(self, nbytes: int, streams: int = 1) -> None:
        """Move ``nbytes`` using ``streams`` parallel TCP streams (the
        GridFTP parallelism / SDK multipart knob).  Fair-shares the
        aggregate among all active streams on the link."""
        if nbytes <= 0:
            return
        streams = max(1, streams)
        with self._lock:
            self._active += streams
        try:
            left = nbytes
            while left > 0:
                step = min(left, self.chunk * streams)
                self.clock.sleep(step / (streams * self._per_stream_rate()))
                left -= step
        finally:
            with self._lock:
                self._active -= streams


#: A zero-cost link (co-located processes).
def loopback(clock: Clock | None = None) -> Link:
    return Link("loopback", rtt=0.0, per_stream_bw=float("inf"),
                aggregate_bw=float("inf"), clock=clock or DEFAULT_CLOCK)
