"""Multi-task control plane for the managed transfer service.

A copy of ``repro/core/manager.py``: the port imports nothing of ``repro``.

The paper's contribution is not the Connector alone but the *managed*
third-party service built on it — an orchestrator that initiates
source->destination transfers without sitting in the data path and runs
many tasks at once for performance, error handling, and integrity
(paper §2.1-§2.2).  :class:`TransferManager` is that control plane:

* a priority/FIFO submission queue with a global worker budget and
  per-endpoint concurrency caps, so a fleet of tasks cannot overrun a
  single storage endpoint;
* full task lifecycle — ``submit`` / ``pause`` / ``resume`` / ``cancel``
  / ``wait`` — where a paused task is checkpointed through the
  service's :class:`~repro_torch.core.transfer.MarkerStore` and a resume
  re-opens only the unfinished holes;
* fair scheduling across *tenants* (credential identities from
  :class:`~repro_torch.core.transfer.CredentialStore`): tenants take turns in
  round-robin order, so one user's 10k-file task cannot starve others;
* session sharing: one live connector :class:`Session` per endpoint,
  refcounted across every task that touches it (a
  :class:`SessionPool`), instead of a start/destroy pair per task;
* model-driven routing, closed-loop: a submission naming multiple
  candidate routes is placed by :meth:`~repro_torch.core.perfmodel.Advisor.best`,
  the batch policy sized by
  :meth:`~repro_torch.core.perfmodel.Advisor.coalesce_threshold`, and the
  prediction vs. the *charge-accounted* model-time actual (exact per
  task even under concurrency — every clock charge names its owning
  task, see :mod:`repro_torch.core.clock`) recorded in
  :class:`~repro_torch.core.transfer.TaskStats`.  Every ``refit_every``
  completions per route the manager refits that route's perf model from
  a bounded ring of recent observations and pushes the refreshed
  ``coalesce_threshold``/concurrency into still-queued submissions, so
  a live fleet converges without resubmission (the paper's §5 "easily
  characterized in different contexts without exhaustive benchmarking",
  automated).

:class:`~repro_torch.core.transfer.TransferService` keeps the per-task engine
(expansion, pipes, batches, retries, markers); a bare ``service.submit``
is just the degenerate case of this manager with default knobs.
"""

from __future__ import annotations

import heapq
import itertools
import statistics
import threading
from collections import deque
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field, replace

from .clock import charge_to
from .connector import Session, iter_files
from .perfmodel import Advisor, Route, fit_perf_model
from .transfer import (Endpoint, TransferOptions, TransferService,
                       TransferTask)
from ..obs import MetricsRegistry, Tracer
from ..obs.trace import NULL_TRACER
from ..svc import StatusBus


# --------------------------------------------------------------------------
# session sharing across tasks
# --------------------------------------------------------------------------
class _PoolEntry:
    """One pooled session generation: its own refcount and drain flag.
    A fresh generation replacing a dead session starts at refcount 0 and
    stale holders of the old generation can never touch it — releases
    are matched by session identity, not by endpoint key."""

    __slots__ = ("session", "refs", "draining")

    def __init__(self, session: Session):
        self.session = session
        self.refs = 0
        self.draining = False


class SessionPool:
    """One live connector session per endpoint, shared by every task the
    manager runs against it.

    The per-task engine historically paid ``start``/``destroy`` per
    task; at fleet scale that is a fresh activation (and a fresh batch
    worker pool) per task per endpoint.  The pool refcounts instead:
    ``acquire`` starts a session on first use, every later task reuses
    it, and sessions stay warm between tasks until :meth:`close_all`
    (manager shutdown) destroys them.

    Each pooled session is a :class:`_PoolEntry` *generation*: when a
    session dies mid-task (provider drop, chaos) the next ``acquire``
    starts a replacement generation, and the dead generation's holders
    release against *their* entry — never the replacement's refcount —
    so a stale release can neither go negative nor destroy a live
    session early.  Draining is likewise per generation: ``close_all``
    retires the entries that exist at that moment, and the pool stays
    usable for later work instead of destroying every future session at
    refcount zero.
    """

    def __init__(self, creds):
        self._creds = creds
        self._lock = threading.Lock()
        #: key -> current generation for that endpoint
        self._current: dict[tuple, _PoolEntry] = {}
        #: id(session) -> its entry, for every generation still holding
        #: references (current or retired)
        self._by_session: dict[int, _PoolEntry] = {}

    @staticmethod
    def _key(ep: Endpoint) -> tuple:
        return (id(ep.connector), ep.resolved_id())

    def acquire(self, ep: Endpoint) -> Session:
        with self._lock:
            key = self._key(ep)
            entry = self._current.get(key)
            if entry is None or entry.session.closed or entry.draining:
                if entry is not None and entry.refs <= 0:
                    # a generation that died while idle has no holders
                    # left to drain it — drop its tracking entry here
                    self._by_session.pop(id(entry.session), None)
                session = ep.connector.start(
                    self._creds.lookup(ep.resolved_id()))
                entry = _PoolEntry(session)
                self._current[key] = entry
                self._by_session[id(session)] = entry
            entry.refs += 1
            return entry.session

    def release(self, ep: Endpoint, session: Session) -> None:
        """Return one reference on ``session``.  A release against a
        generation that has since been replaced only drains that old
        generation; if the session is unknown (already fully drained)
        it is a no-op."""
        victim = None
        with self._lock:
            entry = self._by_session.get(id(session))
            if entry is None or entry.refs <= 0:
                return
            entry.refs -= 1
            key = self._key(ep)
            retired = self._current.get(key) is not entry
            if entry.refs == 0 and (entry.draining or retired
                                    or entry.session.closed):
                # last holder off a dead/draining/replaced generation
                # completes its teardown — never under a live transfer
                self._by_session.pop(id(session), None)
                if not retired:
                    del self._current[key]
                victim = entry.session
        if victim is not None and not victim.closed:
            victim.connector.destroy(victim)

    @property
    def live_sessions(self) -> int:
        with self._lock:
            return sum(1 for e in self._current.values()
                       if not e.session.closed)

    def close_all(self) -> None:
        """Destroy the idle sessions now and mark the in-use ones
        draining (their final ``release`` destroys them).  Only the
        generations alive at this moment are affected: sessions started
        afterwards pool normally again."""
        victims = []
        with self._lock:
            for key, entry in list(self._current.items()):
                entry.draining = True
                if entry.refs <= 0:
                    del self._current[key]
                    self._by_session.pop(id(entry.session), None)
                    victims.append(entry.session)
        for session in victims:
            if not session.closed:
                session.connector.destroy(session)


# --------------------------------------------------------------------------
# submissions
# --------------------------------------------------------------------------
@dataclass
class RouteCandidate:
    """One route a submission may take; ``name`` matches an Advisor
    :class:`~repro_torch.core.perfmodel.Route` so the manager can predict."""

    name: str
    src: Endpoint
    dst: Endpoint


@dataclass
class _Submission:
    task: TransferTask
    src: Endpoint
    dst: Endpoint
    options: TransferOptions
    tenant: str
    priority: int
    seq: int
    route_name: str = ""
    n_files_hint: int = 0
    nbytes_hint: int = 0
    #: a resume raced an in-flight pause: when the run loop drains with
    #: status PAUSED, re-queue instead of filing into the paused set
    resume_pending: bool = False
    #: model time this submission (last) entered the ready queue — the
    #: start of the retroactive "queue-wait" span recorded at dispatch
    enqueued_at: float = 0.0
    #: seq of this submission's live heap entry, or None when it holds
    #: none (running / paused / cancelled).  A heap item is a tombstone
    #: unless its seq matches — that is what lets pause/cancel dequeue
    #: in O(1) and the scheduler pop lazily instead of re-sorting
    queued_seq: int | None = None
    #: which refit generation of the route model produced
    #: ``predicted_seconds`` (0 = the seed fit, k = after the k-th refit)
    predict_gen: int = 0

    @property
    def ep_ids(self) -> set[str]:
        return {self.src.resolved_id(), self.dst.resolved_id()}


@dataclass
class ManagerMetrics:
    """Control-plane accounting, for caps/fairness assertions."""

    submitted: int = 0
    completed: int = 0
    cancelled: int = 0
    pauses: int = 0
    resumes: int = 0
    #: federation traffic: tasks serialized out to / imported from a
    #: peer control plane
    exports: int = 0
    imports: int = 0
    peak_active: int = 0
    #: high-water mark of concurrently-active tasks touching an endpoint
    peak_by_endpoint: dict = field(default_factory=dict)
    #: how many dispatches each tenant has received (fairness evidence)
    dispatches_by_tenant: dict = field(default_factory=dict)
    #: (tenant, task_id) in dispatch order — round-robin observability
    dispatch_log: list = field(default_factory=list)
    #: dispatches deferred because an endpoint's circuit breaker was
    #: open at pick time (health plane, :mod:`repro_torch.core.health`)
    health_deferrals: int = 0
    #: route -> automatic refits performed by the online loop
    refits: dict = field(default_factory=dict)
    #: digest() calls answered from the etag cache (queue generation
    #: unchanged) vs. recomputed — the service plane's "an unchanged
    #: snapshot costs ~0" evidence
    digest_hits: int = 0
    digest_misses: int = 0
    #: (route, predict_gen, predicted_s, actual_s) per successful routed
    #: task, in completion order — the prediction-vs-actual error record
    #: the refit loop is judged by.  A bounded ring, like the
    #: observation history: a long-lived fleet must not grow it forever.
    prediction_log: deque = field(
        default_factory=lambda: deque(maxlen=ManagerMetrics.PREDICTION_LOG))

    PREDICTION_LOG = 512


# --------------------------------------------------------------------------
# the manager
# --------------------------------------------------------------------------
class TransferManager:
    """Owns a fleet of :class:`TransferTask`s over one
    :class:`TransferService`.

    Scheduling model: each tenant has a priority heap of submissions;
    tenants take strict round-robin turns, and within a turn the
    tenant's best eligible entry (lowest ``priority``, then FIFO) runs.
    An entry is eligible when the global worker budget has a free slot
    and neither of its endpoints is at ``per_endpoint_cap`` active
    tasks.  Dispatch is event-driven — submissions, completions, and
    resumes pump the scheduler; there is no polling thread.
    """

    def __init__(self, service: TransferService | None = None,
                 advisor: Advisor | None = None, max_workers: int = 4,
                 per_endpoint_cap: int | None = 2,
                 share_sessions: bool = True, refit_every: int = 8,
                 history_limit: int = 64, site_id: str = "",
                 health=None, catalog=None, tracer=None, registry=None,
                 metrics_every: int = 16, **service_kw):
        self.service = service or TransferService(**service_kw)
        if health is not None:
            # shared health plane: the data plane's retry loop and this
            # scheduler consult the SAME registry, so a breaker opened
            # by one task's failures steers every later dispatch
            self.service.health = health
        if catalog is not None:
            # shared replica plane: the data plane publishes/serves
            # replicas from the SAME catalog this scheduler (and the
            # federation digest exchange) scores placement against
            self.service.catalog = catalog
        self.advisor = advisor
        #: federation identity: which site control plane this manager is
        #: (stamped into TaskStats.site so attribution survives handoff)
        self.site_id = site_id
        self.max_workers = max(1, max_workers)
        self.per_endpoint_cap = per_endpoint_cap
        #: auto-refit a route's perf model after this many successful
        #: routed completions on it (0/None disables the online loop)
        self.refit_every = refit_every
        #: observations kept per route — a bounded ring, so refits track
        #: recent traffic instead of averaging over the fleet's lifetime
        self.history_limit = max(2, history_limit)
        self.sessions = SessionPool(self.service.creds) if share_sessions \
            else None
        self.metrics = ManagerMetrics()
        #: observability plane (repro.obs): a model-time tracer shared
        #: with the data plane — spans opened inside TransferService
        #: attach to the task each run loop binds — plus a labeled
        #: metrics registry absorbing the per-plane counters
        if tracer is None and self.service.tracer.enabled:
            # the caller pre-wired a live tracer on the service: share it
            self.tracer = self.service.tracer
        else:
            self.tracer = tracer or Tracer(clock=self.service.clock)
            self.service.tracer = self.tracer
        if self.service.health is not None \
                and self.service.health.tracer is NULL_TRACER:
            self.service.health.tracer = self.tracer
        self.registry = registry or MetricsRegistry()
        #: publish a "metrics" bus event every N terminal completions
        #: (0 disables the periodic stream)
        self.metrics_every = max(0, metrics_every)
        self._tasks_total = self.registry.counter(
            "tasks_total", "terminal task outcomes by site/tenant/status")
        self._task_seconds = self.registry.histogram(
            "task_model_seconds",
            "charged model seconds per terminal task")
        self._queue_wait = self.registry.histogram(
            "queue_wait_model_seconds",
            "model seconds from enqueue to dispatch")
        self.registry.register_collector(self._collect_metrics)
        self._lock = threading.RLock()
        #: service plane: lifecycle/progress event stream (see repro.svc)
        self.bus = StatusBus(site_id=site_id, clock=self.service.clock)
        #: one condition variable on the manager lock carries every
        #: completion/queue-mutation signal: wait_all blocks on it and
        #: every _touch_locked notifies it — no poll-and-sleep anywhere
        self._cv = threading.Condition(self._lock)
        #: queue-state generation — the digest etag.  Bumped by every
        #: queue mutation (submit/dispatch/pause/resume/cancel/finish/
        #: export/import), never by reads, so an unchanged fleet answers
        #: digest() from cache
        self._generation = 0
        self._digest_cache: dict | None = None
        self._queues: dict[str, list] = {}   # tenant -> [(prio, seq, sub)]
        self._rr: list[str] = []             # tenant round-robin order
        self._queued: dict[str, _Submission] = {}
        self._running: dict[str, _Submission] = {}
        self._paused: dict[str, _Submission] = {}
        self._all: dict[str, _Submission] = {}
        self._active_eps: dict[str, int] = {}
        self._seq = itertools.count()
        #: per-route bounded ring of (n_files, nbytes, model_seconds)
        #: from completed tasks — the online-refit observation log
        self._history: dict[str, deque] = {}
        #: per-route successful completions since the last refit
        self._since_refit: dict[str, int] = {}
        #: per-route refit generation (0 = seed model)
        self._refit_gen: dict[str, int] = {}
        self._shutdown = False

    @property
    def health(self):
        """The shared :class:`~repro_torch.core.health.EndpointHealth` registry
        (``None`` when the health plane is off)."""
        return self.service.health

    @property
    def catalog(self):
        """The shared :class:`~repro_torch.catalog.ReplicaCatalog` (``None``
        when the replica plane is off)."""
        return self.service.catalog

    # ---- observability plane ---------------------------------------------
    def _collect_metrics(self) -> dict:
        """Snapshot-time collector absorbing the legacy per-plane
        counters (ManagerMetrics, bus, tracer, health, catalog) into
        the registry namespace without any write-path changes."""
        m = self.metrics
        out = {
            "manager_submitted_total": m.submitted,
            "manager_completed_total": m.completed,
            "manager_cancelled_total": m.cancelled,
            "manager_pauses_total": m.pauses,
            "manager_resumes_total": m.resumes,
            "manager_exports_total": m.exports,
            "manager_imports_total": m.imports,
            "manager_health_deferrals_total": m.health_deferrals,
            "manager_peak_active": m.peak_active,
            "bus_events_published_total": self.bus.published,
            "tracer_spans_recorded_total": self.tracer.spans_recorded,
            "tracer_spans_dropped_total": self.tracer.spans_dropped,
        }
        health = self.service.health
        if health is not None:
            snap = health.snapshot()
            out["health_endpoints"] = len(snap)
            out["health_breakers_open"] = sum(
                1 for s in snap.values() if s["state"] != "closed")
            out["health_denials_total"] = sum(
                s["denials"] for s in snap.values())
        catalog = self.service.catalog
        if catalog is not None:
            for k, v in catalog.stats().items():
                if isinstance(v, (int, float)):
                    out[f"catalog_{k}"] = v
        return out

    def scrape(self) -> str:
        """Prometheus-flavoured text of every fleet metric (native
        instruments + absorbed per-plane counters)."""
        return self.registry.scrape()

    # ---- service plane: mutation signal + event publication --------------
    def _touch_locked(self, etype: str | None = None,
                      task: TransferTask | None = None, **data) -> None:
        """Record one queue mutation (caller holds the lock): bump the
        digest generation (etag), invalidate the cached snapshot, wake
        every condition-variable waiter (``wait_all``), and publish the
        lifecycle event on the bus."""
        self._generation += 1
        self._digest_cache = None
        self._cv.notify_all()
        if etype is not None and task is not None:
            self.bus.publish(etype, task_id=task.task_id,
                             data=data or None, site_id=self.site_id)

    def _wire_task(self, task: TransferTask) -> None:
        """Point the task's emit hook at this bus, so the data plane's
        progress ticks stream to subscribers without knowing about the
        manager."""
        bus, site, tid = self.bus, self.site_id, task.task_id
        task._emit = lambda etype, data=None: bus.publish(
            etype, task_id=tid, data=data, site_id=site)

    # ---- submission ------------------------------------------------------
    def submit(self, src: Endpoint | None = None, dst: Endpoint | None = None,
               options: TransferOptions | None = None, *,
               task_id: str | None = None, tenant: str | None = None,
               priority: int = 0,
               candidates: list[RouteCandidate] | None = None,
               n_files: int = 0, nbytes: int = 0,
               sync: bool = False) -> TransferTask:
        """Enqueue one transfer.  Either a concrete ``(src, dst)`` pair
        or ``candidates`` (Advisor-routed) must be given.  ``tenant``
        defaults to the credential identity behind the source endpoint;
        lower ``priority`` runs earlier within a tenant's turn.
        ``n_files``/``nbytes`` are workload hints for route prediction
        (estimated by expanding the source when omitted)."""
        if candidates:
            src, dst, options, route_name, predicted, (n_files, nbytes) = \
                self._choose_route(candidates, options, n_files, nbytes)
        elif src is None or dst is None:
            raise ValueError("submit needs src+dst or candidates")
        else:
            route_name, predicted = "", 0.0
        options = options or TransferOptions()
        task = self.service.make_task(src, dst, task_id)
        if tenant is None:
            tenant = self.service.creds.identity(src.resolved_id())
        task.stats.tenant = tenant
        task.stats.route = route_name
        task.stats.predicted_seconds = predicted
        task.stats.site = self.site_id
        task.stats.origin_site = self.site_id
        task.trace_id = f"trace-{task.task_id}"
        with self._lock:
            if self._shutdown:
                raise RuntimeError("manager is shut down")
            sub = _Submission(task, src, dst, options, tenant, priority,
                              next(self._seq), route_name=route_name,
                              n_files_hint=n_files, nbytes_hint=nbytes,
                              predict_gen=self._refit_gen.get(route_name, 0))
            self._wire_task(task)
            self._enqueue_locked(sub)
            self.metrics.submitted += 1
            self._touch_locked("queued", task, tenant=tenant,
                               priority=priority)
        self._pump()
        if sync:
            task.wait()
        return task

    def _enqueue_locked(self, sub: _Submission) -> None:
        heap = self._queues.setdefault(sub.tenant, [])
        heapq.heappush(heap, (sub.priority, sub.seq, sub))
        sub.queued_seq = sub.seq
        sub.enqueued_at = self.service.clock.virtual_elapsed
        if sub.tenant not in self._rr:
            self._rr.append(sub.tenant)
        self._queued[sub.task.task_id] = sub
        self._all[sub.task.task_id] = sub

    # ---- advisor routing -------------------------------------------------
    def _choose_route(self, candidates, options, n_files, nbytes):
        """Pick the candidate route the fitted models predict fastest.
        Each candidate is ranked against its OWN source tree (replicas
        may differ in shape — one side may already be coalesced into few
        large objects); concurrency and the coalesce threshold are then
        sized from the winner."""
        if self.advisor is None:
            raise ValueError("candidate routing needs an advisor")
        estimates: dict[tuple, tuple[int, int]] = {}  # shared-src cache
        best = None
        for cand in candidates:
            for route in self.advisor.routes:
                if route.name == cand.name:
                    break
            else:
                raise ValueError(f"no advisor route named {cand.name!r}")
            if n_files:
                workload = (n_files, nbytes)
            else:
                key = (id(cand.src.connector), cand.src.path)
                if key not in estimates:
                    estimates[key] = self._estimate_workload(cand.src)
                workload = estimates[key]
            catalog = self.service.catalog
            replica_bytes = 0 if catalog is None else catalog.held_bytes_at(
                (cand.dst.resolved_id(),), cand.src.resolved_id(),
                cand.src.path)
            _, cc, predicted = Advisor([route]).best(
                *workload, replica_bytes=replica_bytes)
            health = self.service.health
            if health is not None and health.denied(cand.src.resolved_id(),
                                                    cand.dst.resolved_id()):
                # score around open breakers: a huge (not infinite)
                # penalty keeps a healthy replica winning whenever one
                # exists, while an all-unhealthy candidate set still
                # places somewhere instead of erroring
                predicted *= 1e6
            if best is None or predicted < best[3]:
                best = (cand, route, cc, predicted, workload)
        cand, route, cc, predicted, workload = best
        # copy before tuning: the caller may share one TransferOptions
        # across submissions, and the advisor's knobs are per-task
        options = replace(options) if options is not None \
            else TransferOptions()
        options.concurrency = max(1, min(cc, route.max_concurrency))
        options.coalesce_threshold = self.advisor.coalesce_threshold(route)
        return cand.src, cand.dst, options, route.name, predicted, workload

    def _estimate_workload(self, src: Endpoint) -> tuple[int, int]:
        """(n_files, nbytes) by expanding the source prefix — the same
        walk ``_execute`` will do, done early so the Advisor can place
        the task before it runs."""
        release = None
        if self.sessions is not None:
            session = self.sessions.acquire(src)
            release = lambda: self.sessions.release(src, session)
        else:
            session = src.connector.start(
                self.service.creds.lookup(src.resolved_id()))
            release = lambda: src.connector.destroy(session)
        try:
            info = src.connector.stat(session, src.path)
            if not info.is_dir:
                return 1, info.size
            n = total = 0
            for fi in iter_files(src.connector, session, src.path):
                n += 1
                total += fi.size
            return max(n, 1), total
        finally:
            release()

    # ---- scheduling ------------------------------------------------------
    def _eligible_locked(self, sub: _Submission) -> bool:
        if self.per_endpoint_cap is None:
            return True
        return all(self._active_eps.get(ep_id, 0) < self.per_endpoint_cap
                   for ep_id in sub.ep_ids)

    def _pick_locked(self, ignore_health: bool = False) -> _Submission | None:
        """Next runnable submission: tenants rotate round-robin; within
        a tenant, lowest (priority, seq) whose endpoints are under cap
        and (when the health plane is on) have no open breaker.

        The heaps use lazy deletion: pause/cancel (and a pick itself)
        clear ``sub.queued_seq`` instead of scanning + re-heapifying, so
        a pick is O(log n) pops — tombstones fall out here, and entries
        popped while their endpoints were at cap (or breaker-denied)
        are pushed back.  (The old sorted(heap) + heap.remove + heapify
        pick was O(n log n) each, O(n^2 log n) to drain a fleet-sized
        queue.)"""
        if len(self._running) >= self.max_workers:
            return None
        health = None if ignore_health else self.service.health
        for _ in range(len(self._rr)):
            tenant = self._rr.pop(0)
            self._rr.append(tenant)
            heap = self._queues.get(tenant)
            if not heap:
                continue
            picked = None
            deferred = []
            while heap:
                item = heapq.heappop(heap)
                sub = item[2]
                if sub.queued_seq != item[1]:
                    continue  # tombstone: dequeued or re-queued since
                if not self._eligible_locked(sub):
                    deferred.append(item)  # at cap: stays queued
                    continue
                if health is not None and health.denied(*sub.ep_ids):
                    # an endpoint breaker is open: don't burn a worker
                    # slot fast-failing — leave it queued; completions
                    # (and the _pump liveness fallback) re-pick it
                    self.metrics.health_deferrals += 1
                    deferred.append(item)
                    continue
                sub.queued_seq = None
                picked = sub
                break
            for item in deferred:
                heapq.heappush(heap, item)
            if picked is not None:
                return picked
        return None

    def _activate_locked(self, sub: _Submission) -> None:
        tid = sub.task.task_id
        self._queued.pop(tid, None)
        # claim idleness here, not in the worker thread: a pause landing
        # between dispatch and the run loop's own clear must not let
        # wait_idle() return before the run loop has reacted
        sub.task._idle.clear()
        self._running[tid] = sub
        for ep_id in sub.ep_ids:
            n = self._active_eps.get(ep_id, 0) + 1
            self._active_eps[ep_id] = n
            peak = self.metrics.peak_by_endpoint
            peak[ep_id] = max(peak.get(ep_id, 0), n)
        self.metrics.peak_active = max(self.metrics.peak_active,
                                       len(self._running))
        by_tenant = self.metrics.dispatches_by_tenant
        by_tenant[sub.tenant] = by_tenant.get(sub.tenant, 0) + 1
        self.metrics.dispatch_log.append((sub.tenant, tid))
        # queue time was waited out, not slept through: a retroactive
        # span (visible in exports, charges nothing) + a histogram point
        now = self.service.clock.virtual_elapsed
        self.tracer.record("queue-wait", "queue", sub.enqueued_at, now,
                           trace_id=sub.task.trace_id, task_id=tid,
                           tenant=sub.tenant)
        self._queue_wait.observe(max(0.0, now - sub.enqueued_at),
                                 site=self.site_id, tenant=sub.tenant)
        self._touch_locked("dispatched", sub.task, tenant=sub.tenant)

    def _pump(self) -> None:
        """Dispatch every runnable submission to a worker thread."""
        with self._lock:
            if self._shutdown:
                return
            while True:
                sub = self._pick_locked()
                if sub is None and not self._running \
                        and self.service.health is not None:
                    # liveness backstop: with everything health-deferred
                    # and nothing running, no completion will ever pump
                    # again — admit one denied submission anyway and let
                    # the data plane's admit() gate pace it (fast-fail +
                    # breaker retry_after), instead of wedging the queue
                    sub = self._pick_locked(ignore_health=True)
                if sub is None:
                    return
                self._activate_locked(sub)
                threading.Thread(target=self._run_one, args=(sub,),  # lint: disable=R002(the worker IS the charge boundary — _run establishes charge_to with the task id itself)
                                 daemon=True).start()

    @contextmanager
    def _pooled_sessions(self, src: Endpoint, dst: Endpoint):
        s_src = self.sessions.acquire(src)
        try:
            s_dst = self.sessions.acquire(dst)
            try:
                yield s_src, s_dst
            finally:
                self.sessions.release(dst, s_dst)
        finally:
            self.sessions.release(src, s_src)

    def _run_one(self, sub: _Submission) -> None:
        # per-task charge accounting: the run attributes every model-time
        # charge (across all the threads it fans out into) to this task,
        # so the delta is exact even with max_workers > 1 — concurrent
        # tasks partition the shared clock instead of each observing all
        # of it
        clock = self.service.clock
        tid = sub.task.task_id
        c0 = clock.charged(tid)
        t0 = self.tracer.category_seconds(tid)
        scope = self._pooled_sessions if self.sessions is not None else None
        try:
            self.service._run(sub.task, sub.src, sub.dst, sub.options,
                              session_scope=scope)
        finally:
            # the span-category delta mirrors the charge delta exactly:
            # both are fed by the same Clock.sleep calls, so the
            # time_budget decomposition cannot drift from the total
            t1 = self.tracer.category_seconds(tid)
            spans = {cat: secs - t0.get(cat, 0.0)
                     for cat, secs in t1.items()
                     if secs - t0.get(cat, 0.0) > 0.0}
            self._on_done(sub, clock.charged(tid) - c0, spans)

    def _on_done(self, sub: _Submission, model_seconds: float,
                 span_seconds: dict | None = None) -> None:
        task = sub.task
        refit_due: str | None = None
        with self._lock:
            tid = task.task_id
            self._running.pop(tid, None)
            for ep_id in sub.ep_ids:
                n = self._active_eps.get(ep_id, 0) - 1
                if n > 0:
                    self._active_eps[ep_id] = n
                else:
                    self._active_eps.pop(ep_id, None)
            task.stats.actual_model_seconds += model_seconds
            for cat, secs in (span_seconds or {}).items():
                ss = task.stats.span_seconds
                ss[cat] = ss.get(cat, 0.0) + secs
            if task.status == TransferTask.PAUSED:
                self.metrics.pauses += 1
                if sub.resume_pending:
                    # a resume raced the drain: straight back to the queue
                    sub.resume_pending = False
                    task._pause_req.clear()
                    task.status = TransferTask.PENDING
                    task.stats.resumes += 1
                    self.metrics.resumes += 1
                    sub.seq = next(self._seq)
                    self._enqueue_locked(sub)
                    etype = "resumed"
                else:
                    self._paused[tid] = sub
                    etype = "paused"
            elif task.status == TransferTask.CANCELLED:
                self.metrics.cancelled += 1
                self.service.clock.forget(tid)
                self.tracer.forget(tid)
                etype = "cancelled"
            else:
                self.metrics.completed += 1
                self.service.clock.forget(tid)
                self.tracer.forget(tid)
                etype = "done" if task.status == TransferTask.SUCCEEDED \
                    else "failed"
                if task.status == TransferTask.SUCCEEDED and sub.route_name:
                    route = sub.route_name
                    self._history.setdefault(
                        route, deque(maxlen=self.history_limit)).append(
                        (task.stats.files_total, task.stats.bytes_total,
                         task.stats.actual_model_seconds))
                    self.metrics.prediction_log.append(
                        (route, sub.predict_gen,
                         task.stats.predicted_seconds,
                         task.stats.actual_model_seconds))
                    if self.refit_every:
                        n = self._since_refit.get(route, 0) + 1
                        if n >= self.refit_every:
                            # reset under the lock: a sibling completion
                            # must not schedule a second refit
                            self._since_refit[route] = 0
                            refit_due = route
                        else:
                            self._since_refit[route] = n
            self._touch_locked(etype, task, status=task.status)
        if etype in ("done", "failed", "cancelled"):
            self._tasks_total.inc(site=self.site_id, tenant=sub.tenant,
                                  status=task.status)
            self._task_seconds.observe(task.stats.actual_model_seconds,
                                       site=self.site_id,
                                       status=task.status)
            if self.metrics_every:
                n = self.metrics.completed + self.metrics.cancelled
                if n % self.metrics_every == 0:
                    # periodic registry snapshot on the event stream, so
                    # subscribers scrape metrics off the bus they already
                    # watch (outside the manager lock: collectors take
                    # plane locks of their own)
                    self.bus.publish("metrics",
                                     data=self.registry.snapshot(),
                                     site_id=self.site_id)
        if refit_due is not None:
            self._auto_refit(refit_due)
        self._pump()

    def _auto_refit(self, route_name: str) -> None:
        """One turn of the closed loop: refit the route from its recent
        observations, then push the refreshed model's knobs into every
        still-queued submission on that route so the in-flight fleet
        converges without resubmission."""
        model = self.refit_route(route_name)
        with self._lock:
            if model is None:
                return
            gen = self._refit_gen.get(route_name, 0) + 1
            self._refit_gen[route_name] = gen
            refits = self.metrics.refits
            refits[route_name] = refits.get(route_name, 0) + 1
            route = next((r for r in self.advisor.routes
                          if r.name == route_name), None)
            if route is None:
                return
            adv = Advisor([route])
            threshold = self.advisor.coalesce_threshold(route)
            for sub in self._queued.values():
                if sub.route_name != route_name:
                    continue
                _, cc, predicted = adv.best(
                    max(1, sub.n_files_hint), sub.nbytes_hint)
                sub.options.concurrency = max(
                    1, min(cc, route.max_concurrency))
                sub.options.coalesce_threshold = threshold
                sub.task.stats.predicted_seconds = predicted
                sub.predict_gen = gen

    # ---- lifecycle -------------------------------------------------------
    def get(self, task_id: str) -> TransferTask:
        return self.service.get(task_id)

    def pause(self, task_id: str) -> bool:
        """Request a pause.  A queued task pauses immediately; a running
        task checkpoints its in-flight files through the MarkerStore and
        goes PAUSED once its run loop drains (``task.wait_idle()``)."""
        with self._lock:
            sub = self._queued.pop(task_id, None)
            if sub is not None:
                sub.queued_seq = None  # tombstone its heap entry
                sub.task.status = TransferTask.PAUSED
                self._paused[task_id] = sub
                self.metrics.pauses += 1
                self._touch_locked("paused", sub.task, while_queued=True)
                return True
            sub = self._running.get(task_id)
            if sub is not None and not sub.task._done.is_set():
                sub.task.request_pause()
                return True
        return False

    def resume(self, task_id: str) -> bool:
        """Re-queue a paused task; restart markers re-open only the
        holes, so completed ranges are never re-sent."""
        with self._lock:
            sub = self._paused.pop(task_id, None)
            if sub is None:
                # the pause may still be draining its run loop: cancel
                # the request and let _on_done re-queue on drain
                run_sub = self._running.get(task_id)
                if run_sub is not None \
                        and run_sub.task._pause_req.is_set() \
                        and not run_sub.task._done.is_set():
                    run_sub.resume_pending = True
                    return True
                return False
            task = sub.task
            task._pause_req.clear()
            task.status = TransferTask.PENDING
            task.stats.resumes += 1
            self.metrics.resumes += 1
            sub.seq = next(self._seq)  # back of the tenant's FIFO
            self._enqueue_locked(sub)
            self._touch_locked("resumed", task)
        self._pump()
        return True

    def cancel(self, task_id: str) -> bool:
        with self._lock:
            sub = self._queued.pop(task_id, None) \
                or self._paused.pop(task_id, None)
            if sub is not None:
                sub.queued_seq = None  # tombstone its heap entry
                sub.task.request_cancel()
                self.service.markers.clear(task_id)
                self.metrics.cancelled += 1
                sub.task._finish(TransferTask.CANCELLED)
                # a paused task may have accumulated charges in earlier
                # runs; this is its terminal state, so drop its tally
                self.service.clock.forget(task_id)
                self._touch_locked("cancelled", sub.task)
                return True
            sub = self._running.get(task_id)
            if sub is not None:
                sub.task.request_cancel()
                return True
        return False

    def wait(self, task_id: str, timeout: float | None = None) -> bool:
        return self.service.get(task_id).wait(timeout)

    def _drained_locked(self) -> bool:
        """True when no task is pending: everything in ``_all`` is
        either finished or filed into the paused set."""
        return all(s.task._done.is_set() or tid in self._paused
                   for tid, s in self._all.items())

    def wait_all(self, timeout: float | None = None) -> bool:
        """Wait until every non-paused task has finished.

        Event-driven: blocks on the manager condition variable that
        every queue mutation (completion, pause filing, export, ...)
        notifies via :meth:`_touch_locked` — the same signal StatusBus
        subscribers ride.  The old implementation re-polled a pending
        snapshot every 20 ms of wall time (and only ever waited on
        ``pending[0]``); completion latency is now one ``notify``."""
        with self._cv:
            return self._cv.wait_for(self._drained_locked, timeout)

    def shutdown(self, wait: bool = True,
                 timeout: float | None = None) -> None:
        """Stop dispatching, optionally drain running tasks, and close
        the shared sessions."""
        if wait:
            self.wait_all(timeout)
        with self._lock:
            self._shutdown = True
            # backstop for tasks that never reached a terminal _on_done
            # (left paused, still running at a no-wait shutdown): their
            # charge tallies die with the fleet
            for tid in self._all:
                self.service.clock.forget(tid)
        if self.sessions is not None:
            self.sessions.close_all()

    # ---- federation: live-task travel + queue-state digests --------------
    def export_state(self, task_id: str) -> dict | None:
        """Serialize a queued or paused task for travel to a peer site.

        Removes the task from this control plane: its heap entry is
        tombstoned, its marker state (hole map + per-range digests) is
        folded into the payload and cleared locally, and the local
        handle finishes ``HANDED_OFF`` so waiters unblock.  Charge
        accounting travels too — ``actual_model_seconds`` accrued here
        rides in the payload and the importing site resumes the sum, so
        per-task model time stays exact across control planes.

        Returns ``None`` for a running or finished task (pause and wait
        for the drain first — the coordinator does)."""
        with self._lock:
            sub = self._queued.pop(task_id, None)
            state = "queued"
            if sub is None:
                sub = self._paused.pop(task_id, None)
                state = "paused"
            if sub is None:
                return None
            sub.queued_seq = None  # tombstone any live heap entry
            self._all.pop(task_id, None)
            self.metrics.exports += 1
            # notify inside the locked pop: wait_all's predicate stops
            # consulting this task the moment it leaves _all, and the
            # HANDED_OFF finish below runs outside the lock
            self._touch_locked("handed_off", sub.task, state=state)
        st = sub.task.stats
        payload = {
            "version": 1,
            "task_id": task_id,
            "state": state,
            "tenant": sub.tenant,
            "priority": sub.priority,
            "origin_site": st.origin_site or self.site_id,
            "trace_id": sub.task.trace_id,
            "src": {"endpoint_id": sub.src.resolved_id(),
                    "path": sub.src.path},
            "dst": {"endpoint_id": sub.dst.resolved_id(),
                    "path": sub.dst.path},
            "options": asdict(sub.options),
            "route": sub.route_name,
            "n_files": sub.n_files_hint,
            "nbytes": sub.nbytes_hint,
            "stats": {"predicted_seconds": st.predicted_seconds,
                      "actual_model_seconds": st.actual_model_seconds,
                      "resumes": st.resumes,
                      "span_seconds": dict(st.span_seconds)},
            "markers": self.service.markers.export_state(task_id),
            # replica hints: where verified copies of this source
            # already live, so the adopting site's catalog can satisfy
            # the task by replica reads (hints are re-validated there)
            "replicas": (self.service.catalog.export_hints(
                sub.src.resolved_id(), sub.src.path)
                if self.service.catalog is not None else []),
        }
        self.service.markers.clear(task_id)
        self.service.clock.forget(task_id)
        self.tracer.forget(task_id)
        sub.task._finish(TransferTask.HANDED_OFF)
        return payload

    def import_state(self, payload: dict, src: Endpoint,
                     dst: Endpoint) -> TransferTask:
        """Adopt a task serialized by a peer's :meth:`export_state`.

        ``src``/``dst`` are this site's resolutions of the payload's
        endpoint ids (connectors cannot travel; endpoint ownership maps
        can).  The traveled marker state is installed first, so a
        paused task resumes re-sending only its holes; carried stats
        keep tenant/site attribution and the charge-accounted model
        seconds accrued elsewhere."""
        fields = TransferOptions.__dataclass_fields__
        options = TransferOptions(**{k: v
                                     for k, v in payload.get("options",
                                                             {}).items()
                                     if k in fields})
        carried = payload.get("stats", {})
        task = self.service.make_task(src, dst, payload["task_id"])
        task.stats.tenant = payload.get("tenant", "")
        task.stats.route = payload.get("route", "")
        task.stats.site = self.site_id
        task.stats.origin_site = payload.get("origin_site", "")
        task.stats.predicted_seconds = carried.get("predicted_seconds", 0.0)
        task.stats.actual_model_seconds = \
            carried.get("actual_model_seconds", 0.0)
        task.stats.resumes = carried.get("resumes", 0)
        task.stats.span_seconds = dict(carried.get("span_seconds", {}))
        # the trace id travels: spans on this site stitch into the same
        # timeline the task accrued at its origin
        task.trace_id = payload.get("trace_id") \
            or f"trace-{task.task_id}"
        if payload.get("state") == "cancelled":
            # terminal on arrival: registered for observability only —
            # and its markers are NOT installed (nothing would ever
            # clear them, and a later same-id submission must not
            # inherit a cancelled task's hole map)
            task.request_cancel()
            task._finish(TransferTask.CANCELLED)
            return task
        markers = payload.get("markers")
        if markers and markers.get("files"):
            self.service.markers.import_state(task.task_id, markers)
        if self.service.catalog is not None:
            for hint in payload.get("replicas", []) or []:
                self.service.catalog.merge_hint(hint)
        with self._lock:
            if self._shutdown:
                raise RuntimeError("manager is shut down")
            sub = _Submission(task, src, dst, options,
                              payload.get("tenant", "anonymous"),
                              payload.get("priority", 0), next(self._seq),
                              route_name=payload.get("route", ""),
                              n_files_hint=payload.get("n_files", 0),
                              nbytes_hint=payload.get("nbytes", 0))
            if payload.get("state") == "paused":
                # adopting a paused task IS its resume
                task.stats.resumes += 1
                self.metrics.resumes += 1
            self._wire_task(task)
            self._enqueue_locked(sub)
            self.metrics.submitted += 1
            self.metrics.imports += 1
            self._touch_locked("queued", task, imported=True)
        self._pump()
        return task

    def settled(self, task_id: str) -> bool:
        """True once no run loop (or its completion bookkeeping) holds
        the task — it is queued, paused, or finished, so exporting it
        or tearing the manager down cannot race its charge accounting."""
        with self._lock:
            return task_id not in self._running

    def digest(self, fresh: bool = False) -> dict:
        """Queue-state snapshot a federation coordinator exchanges
        between sites: depth, in-flight bytes, and per-endpoint
        saturation — plus a monotonic ``etag`` (the queue-state
        generation).

        While no queue mutation has happened since the last call the
        cached snapshot is returned as-is, so heartbeating an unchanged
        fleet costs ~0 (a dict lookup; ``metrics.digest_hits`` counts
        these).  ``fresh=True`` forces a recompute — the pre-etag cost,
        kept as the benchmark baseline.  In-flight byte counts only
        advance *across* generations; within one, progress freshness is
        the StatusBus event stream's job, not the digest's.

        Saturation: ``active/cap`` per endpoint when a cap is set.  An
        uncapped manager used to report ``0.0`` for every endpoint —
        least-loaded and rebalance placement saw a fully-busy uncapped
        site as idle — so it now falls back to a busy-based signal,
        ``min(1, active/worker_budget)``."""
        with self._lock:
            snap = self._digest_cache
            if snap is not None and not fresh \
                    and snap["etag"] == self._generation:
                self.metrics.digest_hits += 1
                return snap
            in_flight = sum(
                max(0, s.task.stats.bytes_total - s.task.stats.bytes_done)
                for s in self._running.values())
            cap = self.per_endpoint_cap
            budget = max(1, self.max_workers)
            saturation = {ep: (n / cap if cap
                               else min(1.0, n / budget))
                          for ep, n in self._active_eps.items()}
            health = self.service.health
            catalog = self.service.catalog
            snap = {"site_id": self.site_id,
                    "queued": len(self._queued),
                    "running": len(self._running),
                    "paused": len(self._paused),
                    "in_flight_bytes": in_flight,
                    "saturation": saturation,
                    "unavailable_endpoints":
                        sorted(health.unavailable()) if health is not None
                        else [],
                    # replica plane: stats + per-source held-bytes map so
                    # a federation coordinator can score replica hits.
                    # Rides the queue-state etag: completions (the only
                    # durable publishes that matter for placement) always
                    # mutate the queue, so freshness tracks the cache.
                    "catalog": ({"stats": catalog.stats(),
                                 "sources": catalog.source_summary()}
                                if catalog is not None else {}),
                    "etag": self._generation}
            self._digest_cache = snap
            self.metrics.digest_misses += 1
            # a recompute IS the periodic digest delta: stream it, so
            # subscribers track queue state without calling digest()
            self.bus.publish("digest", data=snap, site_id=self.site_id)
            return snap

    # ---- observability / online refit -----------------------------------
    def counts(self) -> dict:
        with self._lock:
            return {"queued": len(self._queued),
                    "running": len(self._running),
                    "paused": len(self._paused),
                    "active_by_endpoint": dict(self._active_eps)}

    def observations(self, route_name: str) -> list[tuple[int, int, float]]:
        with self._lock:
            return list(self._history.get(route_name, []))

    def prediction_error(self, route_name: str | None = None,
                         generation: int | None = None,
                         min_generation: int | None = None) -> float | None:
        """Median relative prediction error ``|predicted - actual| /
        actual`` over the recorded prediction log, optionally filtered
        by route and by refit generation (``generation=0`` is the seed
        model; ``min_generation=1`` is everything predicted after at
        least one online refit).  ``None`` when nothing matches — the
        refit loop's convergence is judged by this shrinking."""
        with self._lock:
            rows = [(p, a) for r, g, p, a in self.metrics.prediction_log
                    if (route_name is None or r == route_name)
                    and (generation is None or g == generation)
                    and (min_generation is None or g >= min_generation)]
        if not rows:
            return None
        return statistics.median(
            abs(p - a) / max(a, 1e-9) for p, a in rows)

    def refit_route(self, route_name: str, min_points: int = 3):
        """Refit one advisor route from recorded (n_files, seconds)
        observations — the paper's §5 regression, rerun on live traffic
        instead of a benchmark sweep.  Observations are charge-accounted
        per task (see :meth:`_run_one`), so they are exact even when the
        fleet recorded them with ``max_workers > 1``; the bounded
        per-route ring (``history_limit``) ages stale traffic out.
        Called automatically every ``refit_every`` completions per route,
        and still callable on demand.  Returns the new
        :class:`~repro_torch.core.perfmodel.PerfModel`, or ``None`` when there
        are too few (or degenerate) points."""
        if self.advisor is None:
            return None
        pts = self.observations(route_name)
        if len(pts) < max(2, min_points):
            return None
        route = next((r for r in self.advisor.routes
                      if r.name == route_name), None)
        if route is None:
            return None
        n_files = [p[0] for p in pts]
        seconds = [p[2] for p in pts]
        bytes_mean = int(sum(p[1] for p in pts) / len(pts))
        try:
            model = fit_perf_model(route_name, n_files, seconds, bytes_mean,
                                   s0=route.model.s0)
        except ValueError:  # degenerate xs (all same file count)
            return None
        route.model = model
        return model
