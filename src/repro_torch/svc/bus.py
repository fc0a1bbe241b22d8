"""Event-streamed status delivery for the managed transfer service.

A copy of ``repro/svc/bus.py``: the port imports nothing of ``repro``.

The paper's pitch is a service clients *observe* without sitting in the
data path; at fleet scale that observation must not be a poll.  This
module is the service plane's transport: a ``StatusBus`` that managers
and the federation coordinator publish typed lifecycle events through,
and that any number of subscribers consume via bounded per-subscriber
ring buffers.  Task status, fleet digests, and federation placement all
become push streams; ``wait``-style callers and subscribers share the
same completion signal (the manager's condition variable), so no code
path re-polls on a wall-clock timer.

Event taxonomy
--------------
Task lifecycle, published by ``TransferManager`` at each queue
mutation while it still holds the manager lock (so per-task event
order on the bus matches the queue's actual state transitions):

``queued``       task accepted into the ready queue (also on import)
``dispatched``   task activated onto a worker
``progress``     bytes advanced (``bytes_done``/``bytes_total`` data)
``paused``       task checkpointed out of the running/queued set
``resumed``      paused task re-entered the ready queue
``handed_off``   task exported to a peer site (federation)
``done``         terminal success
``failed``       terminal failure
``cancelled``    terminal cancellation
``digest``       a queue-digest snapshot was recomputed (etag miss);
                 the event payload is the digest dict itself

The federation coordinator additionally publishes ``placed`` (every
spec placement, with the reason: submit/handoff/failover/rebalance),
``failover`` and ``beat``.

The observability plane adds ``metrics``: a periodic
:class:`~repro_torch.obs.MetricsRegistry` snapshot published by the manager
every N terminal completions, so subscribers can scrape the fleet's
counters off the same stream they already watch for lifecycle events.

Backpressure contract
---------------------
Publishing never blocks and never drops for *fast* subscribers; each
subscriber owns a bounded ring (default 256 events).  When a slow
subscriber's ring is full the *oldest* undelivered event is dropped and
that subscriber's ``dropped`` counter is incremented — exactly one
increment per lost event, so a consumer can always tell how much of the
stream it missed (the ``seq`` gap agrees with ``dropped``).  Slow
consumers therefore degrade to "fresh tail + loss count" rather than
stalling the publisher or growing unbounded queues.  ``unsubscribe``
(or ``Subscription.close``) detaches the ring and frees its buffer
immediately; further publishes never touch it.

Timestamps are *model* time (``Clock.virtual_elapsed``): under the
simulated clock two same-seed runs produce identical event streams, and
staleness measurements in ``benchmarks/bench_svc.py`` are deterministic.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass

from ..core.clock import DEFAULT_CLOCK, Clock

#: every event type the service plane emits (see module docstring)
EVENT_TYPES = (
    "queued", "dispatched", "progress", "paused", "resumed",
    "handed_off", "done", "failed", "cancelled", "digest",
    "placed", "failover", "beat", "metrics",
)


@dataclass(frozen=True)
class StatusEvent:
    """One immutable service-plane event.

    ``seq`` is a per-bus monotonic sequence number assigned at publish;
    a subscriber observing ``seq`` gaps lost exactly ``dropped`` events.
    ``t`` is model time (``Clock.virtual_elapsed`` at publish).
    """

    seq: int
    t: float
    type: str
    site_id: str = ""
    task_id: str = ""
    data: dict | None = None


class Subscription:
    """One subscriber's bounded event ring (see backpressure contract).

    Consumers either ``poll()`` (non-blocking drain) or ``next()``
    (block on the subscription's condition variable until an event
    arrives).  ``dropped`` counts events lost to drop-oldest; it is
    exact.  Close (or ``StatusBus.unsubscribe``) frees the buffer.
    """

    def __init__(self, bus: "StatusBus", capacity: int = 256,
                 types: tuple[str, ...] | None = None,
                 task_id: str | None = None):
        if capacity < 1:
            raise ValueError("subscription capacity must be >= 1")
        self._bus = bus
        self.capacity = capacity
        #: optional filters, applied at publish (misses cost nothing)
        self.types = tuple(types) if types else None
        self.task_id = task_id
        self._cv = threading.Condition()
        self._ring: deque[StatusEvent] = deque()
        #: exact count of events lost to drop-oldest backpressure
        self.dropped = 0
        #: events accepted into the ring (delivered or later dropped)
        self.delivered = 0
        self.closed = False

    # -- publisher side (called by the bus; never blocks) -------------
    def _wants(self, ev: StatusEvent) -> bool:
        if self.types is not None and ev.type not in self.types:
            return False
        if self.task_id is not None and ev.task_id != self.task_id:
            return False
        return True

    def _offer(self, ev: StatusEvent) -> None:
        with self._cv:
            if self.closed:
                return
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.dropped += 1
            self._ring.append(ev)
            self.delivered += 1
            self._cv.notify_all()

    # -- consumer side ------------------------------------------------
    def poll(self, max_events: int | None = None) -> list[StatusEvent]:
        """Drain up to ``max_events`` buffered events (all by default)
        without blocking."""
        with self._cv:
            if max_events is None or max_events >= len(self._ring):
                out = list(self._ring)
                self._ring.clear()
            else:
                out = [self._ring.popleft() for _ in range(max_events)]
            return out

    def next(self, timeout: float | None = None) -> StatusEvent | None:
        """Block until one event is available (or ``timeout`` wall
        seconds elapse / the subscription closes); pop and return it."""
        with self._cv:
            if not self._cv.wait_for(
                    lambda: self._ring or self.closed, timeout):
                return None
            if not self._ring:
                return None
            return self._ring.popleft()

    def __len__(self) -> int:
        with self._cv:
            return len(self._ring)

    def close(self) -> None:
        """Detach from the bus and free the buffer."""
        self._bus.unsubscribe(self)


class StatusBus:
    """Publish/subscribe hub for service-plane status events.

    One bus per manager (and one per coordinator).  ``publish`` stamps
    events with the bus clock's model time, assigns the per-bus ``seq``
    and fans out to every matching subscription under the bus lock;
    subscriptions do their own locking, so the only lock order is
    bus -> subscription (never the reverse) and publishing from inside
    the manager lock is safe.  With zero subscribers a publish is a
    counter increment — managers publish unconditionally.
    """

    def __init__(self, site_id: str = "", clock: Clock | None = None):
        self.site_id = site_id
        self.clock = clock or DEFAULT_CLOCK
        self._lock = threading.Lock()
        self._subs: list[Subscription] = []
        self._seq = itertools.count()
        #: total events published (including zero-subscriber publishes)
        self.published = 0

    # -- subscriber management ----------------------------------------
    def subscribe(self, capacity: int = 256,
                  types: tuple[str, ...] | None = None,
                  task_id: str | None = None) -> Subscription:
        """Attach a bounded-ring subscriber; optional event-type and
        task-id filters are applied at publish time."""
        sub = Subscription(self, capacity=capacity, types=types,
                           task_id=task_id)
        with self._lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        """Detach ``sub`` and free its buffer; idempotent."""
        with self._lock:
            try:
                self._subs.remove(sub)
            except ValueError:
                pass
        with sub._cv:
            sub.closed = True
            sub._ring.clear()
            sub._cv.notify_all()

    @property
    def subscribers(self) -> int:
        with self._lock:
            return len(self._subs)

    # -- publishing ----------------------------------------------------
    def publish(self, etype: str, task_id: str = "",
                data: dict | None = None, t: float | None = None,
                site_id: str | None = None) -> StatusEvent:
        """Publish one event; never blocks (see backpressure contract).

        ``t`` defaults to the bus clock's model time; pass it explicitly
        when the event belongs to another site's clock (federation).
        """
        with self._lock:
            ev = StatusEvent(
                seq=next(self._seq),
                t=self.clock.virtual_elapsed if t is None else t,
                type=etype,
                site_id=self.site_id if site_id is None else site_id,
                task_id=task_id,
                data=data,
            )
            self.published += 1
            subs = [s for s in self._subs if s._wants(ev)]
        for sub in subs:
            sub._offer(ev)
        return ev
