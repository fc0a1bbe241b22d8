"""Federated multi-site control plane (paper §2.1, scaled to a fleet of
control planes).

A copy of ``repro/fed/coordinator.py``: the port imports nothing of ``repro``.

The paper's orchestrator coordinates transfers between sites *without
sitting in the data path*.  :class:`FederatedCoordinator` reproduces
that one level up: it registers N :class:`~repro_torch.core.manager.
TransferManager` sites with endpoint-ownership maps, routes each
serialized :class:`~repro_torch.fed.spec.TransferSpec` to a site by a
pluggable placement policy, exchanges periodic queue-state digests, and
supports **handoff** — re-serializing a queued or paused task from an
overloaded or failed site and resuming it on a peer, the traveled hole
map guaranteeing only the missing bytes are re-sent.

Third-party semantics are enforced by the charge-attribution clock
(:mod:`repro_torch.core.clock`): every coordinator entry point runs with the
coordinator as the thread's charge owner, so any model time it accrued
would be tallied against it — :meth:`model_seconds` must therefore read
0.0, and :meth:`assert_third_party` turns that into a hard invariant.
Data-plane time lands on worker threads that re-bind the charge owner
to the task, so cross-site stats stay attributed to the originating
tenant and task, never to the coordinator.  The coordinator's own
drain/settle polls advance the *model* clock (never ``time.monotonic``)
under a sibling ``#wait`` identity, so deadlines are wall-clock-free
and the invariant still reads 0.0 (see :meth:`wait_seconds`).  The one
deliberate exception is the caller-facing ``wait_all(timeout=)`` bound:
model time never advances while every site idles, so a model deadline
could never fire there — that timeout runs on the sanctioned
:func:`~repro_torch.core.clock.wall_now` helper (which charges nothing, so
the third-party invariant is untouched).

Health plane (heartbeats + hysteresis rebalancing)
--------------------------------------------------
The existing digest exchange doubles as a **heartbeat** carrier: a site
whose ``digest()`` call raises has missed a beat, and
:meth:`FederatedCoordinator.beat` auto-triggers the :meth:`fail_site`
re-homing path once ``miss_threshold`` consecutive beats are missed —
no caller intervention.  A :class:`RebalancePolicy` adds a sustained-
saturation signal with hysteresis (enter/exit thresholds + a minimum
dwell time over the model clock, plus a per-task move cooldown, so
specs don't ping-pong) that proactively migrates *queued* specs off
degrading sites through the same ``export_state``/``import_state``
handoff the failure path uses.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field

from ..catalog import hint_bytes
from ..core.clock import charge_to, wall_now
from ..core.connector import Connector
from ..core.perfmodel import Advisor
from ..core.transfer import Endpoint, TransferTask
from ..svc import StatusBus
from .spec import TransferSpec

#: built-in placement policy names (see :meth:`FederatedCoordinator._place`)
PLACEMENT_POLICIES = ("owner", "least-loaded", "advisor")

#: real seconds per idle-wait poll while draining/settling a task
POLL_REAL = 0.05
#: model seconds charged (to the coordinator's ``#wait`` identity) per
#: poll, so drain/settle deadlines advance even at time scale 0
POLL_MODEL = 0.05


class StrandedTasksError(LookupError):
    """A site failure could not re-home every task.  ``moved`` lists
    the ``(task_id, new_site_id)`` pairs that WERE re-homed before the
    error (the work is not lost, only unreported by the return value);
    ``stranded`` names the tasks left on the dead site's durable
    store."""

    def __init__(self, site_id: str, moved, stranded):
        self.site_id = site_id
        self.moved = list(moved)
        self.stranded = list(stranded)
        super().__init__(
            f"no live site could adopt {self.stranded!r} from "
            f"{site_id!r}; their marker state remains on the dead "
            f"site's store ({len(self.moved)} others re-homed first)")


@dataclass
class QueueDigest:
    """One site's periodic queue-state report, as exchanged between
    control planes: enough for placement, nothing data-plane."""

    site_id: str
    seq: int
    queued: int
    running: int
    paused: int
    in_flight_bytes: int
    #: endpoint id -> active tasks / per-endpoint cap (busy-based
    #: ``active / worker budget`` when the site is uncapped)
    saturation: dict = field(default_factory=dict)
    #: endpoint ids whose circuit breaker the site reports as open
    #: (health plane, :mod:`repro_torch.core.health`)
    unavailable: list = field(default_factory=list)
    #: replica-plane summary from the site's catalog —
    #: ``{"stats": {...}, "sources": {source_key: bytes}}`` — so
    #: placement can score replica hits without touching the site
    #: (see :mod:`repro_torch.catalog`); empty when the site has no catalog
    catalog: dict = field(default_factory=dict)
    #: the site manager's queue-state generation this digest reflects;
    #: an unchanged etag means the site's queue has not mutated, so the
    #: coordinator reuses the previous digest instead of rebuilding
    etag: int = -1

    @property
    def depth(self) -> int:
        return self.queued + self.running


@dataclass
class FedMetrics:
    submissions: int = 0
    handoffs: int = 0
    failovers: int = 0
    #: failovers triggered by the heartbeat monitor (a strict subset of
    #: ``failovers``; the rest were caller-invoked ``fail_site``)
    auto_failovers: int = 0
    #: queued specs migrated by the hysteresis rebalancer
    rebalances: int = 0
    digest_exchanges: int = 0
    #: per-site digests answered by the etag cache during exchanges —
    #: the "beat() consumes the etag instead of recomputing" evidence
    digest_reuses: int = 0
    #: site_id -> cumulative missed heartbeats (digest() calls that
    #: raised); reset never — per-site consecutive-miss state lives on
    #: the SiteHandle
    heartbeat_misses: dict = field(default_factory=dict)
    #: task_ids left stranded by heartbeat-driven failovers (the
    #: auto path swallows StrandedTasksError so one sick site can't
    #: abort the whole beat — the strandings are recorded here)
    stranded: list = field(default_factory=list)
    #: site_id -> tasks placed there (initial placements + handoffs in)
    placements: dict = field(default_factory=dict)
    #: (task_id, site_id, reason) in placement order — "submit",
    #: "handoff", "failover", or "rebalance"
    placement_log: list = field(default_factory=list)


class SiteHandle:
    """One registered site: its manager, the endpoints it can reach,
    and the subset it *owns* (is closest to)."""

    def __init__(self, site_id: str, manager, endpoints: dict, owns):
        self.site_id = site_id
        self.manager = manager
        self.endpoints: dict[str, Connector] = dict(endpoints)
        self.owns = set(endpoints if owns is None else owns)
        self.alive = True
        self.digest: QueueDigest | None = None
        #: consecutive digest exchanges this site failed to answer
        self.missed_beats = 0
        #: hysteresis rebalancer state: is the site currently marked hot,
        #: and since when (model clock) its signal has been >= enter
        self.hot = False
        self.hot_since: float | None = None

    def resolves(self, spec: TransferSpec) -> bool:
        return (spec.src_endpoint in self.endpoints
                and spec.dst_endpoint in self.endpoints)

    def endpoint_pair(self, spec: TransferSpec) -> tuple[Endpoint, Endpoint]:
        src = Endpoint(self.endpoints[spec.src_endpoint], spec.src_path,
                       spec.src_endpoint)
        dst = Endpoint(self.endpoints[spec.dst_endpoint], spec.dst_path,
                       spec.dst_endpoint)
        return src, dst

    def load(self) -> int:
        """Queue depth from the last digest exchange (live snapshot when
        none has happened yet)."""
        if self.digest is not None:
            return self.digest.depth
        c = self.manager.counts()
        return c["queued"] + c["running"]


@dataclass
class RebalancePolicy:
    """Hysteresis knobs for proactive queued-spec migration.

    A site's *signal* is ``max(max endpoint saturation, min(1, queued /
    queue_norm))`` from its last digest.  The site turns **hot** only
    after the signal has stayed >= ``enter`` for ``dwell`` model
    seconds, and stops being hot only once the signal drops <= ``exit``
    — the enter/exit gap plus the dwell are the hysteresis that keeps
    borderline sites from flapping.  Each :meth:`FederatedCoordinator.
    maybe_rebalance` tick moves at most ``max_moves`` queued specs off
    hot sites (to the least-loaded non-hot candidate below ``enter``),
    and a spec that just moved is pinned for ``move_cooldown`` model
    seconds so it cannot ping-pong."""

    enter: float = 0.75
    exit: float = 0.35
    dwell: float = 1.0
    queue_norm: int = 8
    max_moves: int = 2
    move_cooldown: float = 5.0


class FederatedCoordinator:
    """Routes serialized submissions across registered sites and moves
    live tasks between them.  Never opens a connector session, never
    touches file bytes: it handles *references* (specs, endpoint ids,
    digests), exactly the paper's third-party posture.

    ``placement`` picks the site for a spec: ``"owner"`` (the site
    whose ownership map claims the spec's *source* endpoint — the
    paper's place-close-to-the-source rule; least-loaded among multiple
    owners), ``"least-loaded"`` (smallest queue depth from the digest
    exchange), ``"advisor"`` (fastest predicted completion: each
    candidate site's Advisor route prediction scaled by its queue
    depth), or any callable ``(spec, candidates) -> SiteHandle``.
    """

    def __init__(self, placement: str = "owner", name: str = "fed",
                 digest_every: int = 4, miss_threshold: int = 3,
                 rebalance: RebalancePolicy | None = None,
                 bus: StatusBus | None = None, catalog=None):
        self.placement = placement
        #: optional federation-wide :class:`~repro_torch.catalog.ReplicaCatalog`
        #: installed on every registered site that has none of its own —
        #: the dedupe-aware-routing convenience for in-process fleets.
        #: The coordinator itself only ever reads digests (metadata):
        #: replica reads happen on site data planes, so third-party
        #: semantics are untouched.
        self.catalog = catalog
        #: service plane: placement/failover/beat event stream; events
        #: are stamped with the involved site's model clock when one is
        #: known (the coordinator itself has no clock — third party)
        self.bus = bus or StatusBus(site_id=f"fed:{name}")
        #: charge-clock identity all coordinator work is attributed to;
        #: third-party semantics == this owner's tally stays 0.0
        self.charge_owner = f"fed:{name}"
        #: sibling identity for drain/settle deadline polls: model time
        #: lands here, visibly, WITHOUT breaking assert_third_party()
        self.wait_owner = f"fed:{name}#wait"
        #: exchange queue-state digests every this many submissions
        #: (and on demand via :meth:`exchange_digests`)
        self.digest_every = max(1, digest_every)
        #: consecutive missed heartbeats before :meth:`beat` auto-fails
        #: a site
        self.miss_threshold = max(1, miss_threshold)
        #: hysteresis rebalancing policy (None = reactive failover only)
        self.rebalance = rebalance
        self.metrics = FedMetrics()
        self._sites: dict[str, SiteHandle] = {}
        self._placements: dict[str, str] = {}      # task_id -> site_id
        self._tasks: dict[str, TransferTask] = {}  # task_id -> live handle
        self._specs: dict[str, TransferSpec] = {}  # last serialized form
        #: task_id -> model time of its last rebalance move (cooldown)
        self._moved_at: dict[str, float] = {}
        self._digest_seq = itertools.count(1)
        self._since_exchange = 0
        self._lock = threading.RLock()

    # ---- membership ------------------------------------------------------
    def register_site(self, site_id: str, manager,
                      endpoints: dict[str, Connector],
                      owns=None) -> SiteHandle:
        """Register one site control plane.  ``endpoints`` maps endpoint
        id -> connector for every endpoint the site can reach; ``owns``
        names the subset it is authoritative (closest) for — defaults
        to all of them."""
        with self._lock:
            if site_id in self._sites:
                raise ValueError(f"site {site_id!r} already registered")
            if not manager.site_id:
                manager.site_id = site_id
            if self.catalog is not None \
                    and manager.service.catalog is None:
                manager.service.catalog = self.catalog
            site = SiteHandle(site_id, manager, endpoints, owns)
            self._sites[site_id] = site
            return site

    def sites(self) -> dict[str, SiteHandle]:
        with self._lock:
            return dict(self._sites)

    def site_of(self, task_id: str) -> str | None:
        with self._lock:
            return self._placements.get(task_id)

    def task(self, task_id: str) -> TransferTask:
        """The task's *current* live handle (follows handoffs)."""
        with self._lock:
            return self._tasks[task_id]

    def last_spec(self, task_id: str) -> TransferSpec | None:
        """The most recent serialized form the coordinator placed —
        after a handoff this is the traveled spec, hole map included."""
        with self._lock:
            return self._specs.get(task_id)

    # ---- queue-state digests ---------------------------------------------
    def exchange_digests(self) -> dict[str, QueueDigest]:
        with self._lock, charge_to(self.charge_owner):
            return self._exchange_locked()

    def _exchange_locked(self) -> dict[str, QueueDigest]:
        out = {}
        for site in self._sites.values():
            if not site.alive:
                continue
            try:
                d = site.manager.digest()
            except Exception:
                # the digest stream IS the heartbeat: a site that can't
                # answer has missed a beat.  Keep its stale digest for
                # placement until beat() decides it is dead.
                site.missed_beats += 1
                misses = self.metrics.heartbeat_misses
                misses[site.site_id] = misses.get(site.site_id, 0) + 1
                continue
            site.missed_beats = 0
            etag = d.get("etag", -1)
            prev = site.digest
            if prev is not None and etag >= 0 and etag == prev.etag:
                # etag hit: the site's queue has not mutated since the
                # last beat — keep the previous digest, skip the rebuild
                self.metrics.digest_reuses += 1
                out[site.site_id] = prev
                continue
            site.digest = QueueDigest(
                site_id=site.site_id, seq=next(self._digest_seq),
                queued=d["queued"], running=d["running"],
                paused=d["paused"],
                in_flight_bytes=d["in_flight_bytes"],
                saturation=d["saturation"],
                unavailable=list(d.get("unavailable_endpoints", [])),
                catalog=dict(d.get("catalog", {}) or {}),
                etag=etag)
            out[site.site_id] = site.digest
        self.metrics.digest_exchanges += 1
        self._since_exchange = 0
        return out

    def _maybe_exchange_locked(self) -> None:
        self._since_exchange += 1
        if self._since_exchange >= self.digest_every \
                or self.metrics.digest_exchanges == 0:
            self._exchange_locked()

    # ---- heartbeat monitor ----------------------------------------------
    def beat(self, timeout: float = 30.0) -> list[str]:
        """One heartbeat tick: exchange digests (a ``digest()`` call
        that raises is a missed beat), auto-fail any live site at
        ``miss_threshold`` consecutive misses via the :meth:`fail_site`
        re-homing path, then run the hysteresis rebalancer if a policy
        is set.  Returns the site ids failed over on this tick.

        A stranded task on a dead site must not abort the rest of the
        beat — :class:`StrandedTasksError` is swallowed here and the
        task ids recorded in ``metrics.stranded`` instead."""
        with self._lock, charge_to(self.charge_owner):
            self._exchange_locked()
            due = [s.site_id for s in self._sites.values()
                   if s.alive and s.missed_beats >= self.miss_threshold]
        failed = []
        for site_id in due:
            try:
                self.fail_site(site_id, timeout=timeout)
            except StrandedTasksError as e:
                self.metrics.stranded.extend(e.stranded)
            self.metrics.auto_failovers += 1
            failed.append(site_id)
        if self.rebalance is not None:
            self.maybe_rebalance()
        self.bus.publish("beat", data={"failed": list(failed)})
        return failed

    # ---- hysteresis rebalancing -----------------------------------------
    @staticmethod
    def _signal(site: SiteHandle, policy: RebalancePolicy) -> float:
        """Degradation signal in [0, 1]: the worse of endpoint
        saturation and normalized queue depth, from the last digest."""
        d = site.digest
        if d is None:
            return 0.0
        sat = max(d.saturation.values(), default=0.0)
        return max(sat, min(1.0, d.queued / max(1, policy.queue_norm)))

    def maybe_rebalance(self) -> list[tuple[str, str, str]]:
        """One rebalancer tick over the last exchanged digests: update
        each site's hot/cold hysteresis state, then migrate up to
        ``max_moves`` *queued* specs (never running — their bytes are
        in flight; never paused — a pause is an operator/failover
        decision) from hot sites to the least-loaded cold candidate.
        Returns ``[(task_id, from_site, to_site), ...]``."""
        policy = self.rebalance
        if policy is None:
            return []
        moved: list[tuple[str, str, str]] = []
        with self._lock, charge_to(self.charge_owner):
            live = [s for s in self._sites.values() if s.alive]
            for s in live:
                sig = self._signal(s, policy)
                now = s.manager.service.clock.virtual_elapsed
                if s.hot:
                    if sig <= policy.exit:   # hysteresis: exit < enter
                        s.hot = False
                        s.hot_since = None
                elif sig >= policy.enter:
                    if s.hot_since is None:
                        s.hot_since = now
                    if now - s.hot_since >= policy.dwell:
                        s.hot = True  # sustained, not a blip
                else:
                    s.hot_since = None
            budget = policy.max_moves
            for site in live:
                if not site.hot or budget <= 0:
                    continue
                now = site.manager.service.clock.virtual_elapsed
                for tid, sid in list(self._placements.items()):
                    if budget <= 0:
                        break
                    if sid != site.site_id:
                        continue
                    task = self._tasks[tid]
                    if task.status != TransferTask.PENDING:
                        continue  # queued specs only
                    last = self._moved_at.get(tid)
                    if last is not None \
                            and now - last < policy.move_cooldown:
                        continue  # anti-ping-pong pin
                    ref = self._specs.get(tid)
                    if ref is None:
                        continue
                    dests = [c for c in live
                             if c.site_id != site.site_id and not c.hot
                             and c.resolves(ref)
                             and self._signal(c, policy) < policy.enter]
                    if not dests:
                        continue
                    payload = site.manager.export_state(tid)
                    if payload is None:
                        continue  # started running since the check
                    spec = TransferSpec.from_payload(payload)
                    dest = min(dests, key=lambda s: s.load())
                    self._import_at_locked(dest, spec, reason="rebalance")
                    self.metrics.rebalances += 1
                    self._moved_at[tid] = now
                    moved.append((tid, site.site_id, dest.site_id))
                    budget -= 1
        return moved

    # ---- placement -------------------------------------------------------
    def _candidates(self, spec: TransferSpec,
                    exclude: str | None = None) -> list[SiteHandle]:
        sites = [s for s in self._sites.values()
                 if s.alive and s.site_id != exclude and s.resolves(spec)]
        if not sites:
            raise LookupError(
                f"no live site resolves both endpoints of {spec.task_id!r} "
                f"({spec.src_endpoint!r} -> {spec.dst_endpoint!r})")
        return sites

    def _place(self, spec: TransferSpec,
               candidates: list[SiteHandle]) -> SiteHandle:
        if callable(self.placement):
            return self.placement(spec, candidates)
        if self.placement == "owner":
            owners = [s for s in candidates if spec.src_endpoint in s.owns]
            pool = owners or candidates
            # replica-aware tiebreak: equal load, prefer the site whose
            # catalog already holds more of this source (dedupe-aware
            # routing — bytes it will not have to move)
            return min(pool, key=lambda s: (s.load(),
                                            -self._replica_bytes(s, spec)))
        if self.placement == "least-loaded":
            return min(candidates,
                       key=lambda s: (s.load(),
                                      -self._replica_bytes(s, spec)))
        if self.placement == "advisor":
            return min(candidates, key=lambda s: self._predicted(s, spec))
        raise ValueError(f"unknown placement policy {self.placement!r}")

    @staticmethod
    def _replica_bytes(site: SiteHandle, spec: TransferSpec) -> int:
        """Bytes the site's replica catalog reports already holding for
        the spec's source — scored from the last exchanged digest (the
        metadata plane), with a live-catalog fallback before the first
        exchange.  Clamped to the workload hint so a stale summary can
        never make a transfer look free-er than its own size."""
        d = site.digest
        sources = d.catalog.get("sources", {}) if d is not None else {}
        if not sources:
            cat = getattr(site.manager, "catalog", None)
            if cat is None:
                return 0
            held = cat.held_bytes_at((spec.dst_endpoint,),
                                     spec.src_endpoint, spec.src_path)
        else:
            held = hint_bytes(sources, spec.src_endpoint, spec.src_path)
        return min(held, spec.nbytes) if spec.nbytes else held

    def _predicted(self, site: SiteHandle, spec: TransferSpec) -> float:
        """Predicted completion on ``site``: the Advisor's route model
        for this workload — minus the bytes the site's replica catalog
        says need not cross the wire — serialized behind the site's
        current queue depth (depth+1 workloads of this shape, a
        deliberately simple backlog model).  Sites without a fitted
        advisor sort last."""
        adv = site.manager.advisor
        if adv is None or not adv.routes:
            return float("inf")
        route = next((r for r in adv.routes if r.name == spec.route),
                     adv.routes[0])
        _, _, eta = Advisor([route]).best(
            max(1, spec.n_files), spec.nbytes,
            replica_bytes=self._replica_bytes(site, spec))
        return eta * (1 + site.load())

    # ---- submission ------------------------------------------------------
    def submit(self, spec: TransferSpec | str,
               sync: bool = False) -> TransferTask:
        """Place one serialized submission on a site and return that
        site's live task handle.  Accepts a :class:`TransferSpec` or
        its JSON wire form."""
        if isinstance(spec, str):
            spec = TransferSpec.from_json(spec)
        spec.validate()
        with self._lock, charge_to(self.charge_owner):
            self.metrics.submissions += 1
            self._maybe_exchange_locked()
            site = self._place(spec, self._candidates(spec))
            task = self._import_at_locked(site, spec, reason="submit")
        if sync:
            task.wait()
        return task

    def _import_at_locked(self, site: SiteHandle, spec: TransferSpec,
                          reason: str) -> TransferTask:
        if not spec.origin_site:
            spec.origin_site = site.site_id  # first placement is origin
        src, dst = site.endpoint_pair(spec)
        task = site.manager.import_state(spec.to_payload(), src, dst)
        self._placements[spec.task_id] = site.site_id
        self._tasks[spec.task_id] = task
        self._specs[spec.task_id] = spec
        self.metrics.placements[site.site_id] = \
            self.metrics.placements.get(site.site_id, 0) + 1
        self.metrics.placement_log.append(
            (spec.task_id, site.site_id, reason))
        now = site.manager.service.clock.virtual_elapsed
        # charge-free adoption marker on the adopting site's tracer: the
        # traveled trace id stitches this into the task's origin timeline
        site.manager.tracer.record(
            "adopt", "queue", now, now,
            trace_id=spec.trace_id or task.trace_id,
            task_id=spec.task_id, site=site.site_id, reason=reason)
        self.bus.publish("placed", task_id=spec.task_id,
                         data={"site": site.site_id, "reason": reason},
                         t=now)
        return task

    # ---- handoff ---------------------------------------------------------
    def _poll_tick(self, clock, task) -> None:
        """One drain/settle poll: a short *real* wait for the worker to
        go idle, then a model-clock step charged to the ``#wait``
        identity so the model deadline advances even at time scale 0 —
        and :meth:`assert_third_party` (which audits ``charge_owner``,
        not the wait sibling) still reads 0.0."""
        task.wait_idle(POLL_REAL)
        with charge_to(self.wait_owner):
            clock.sleep(POLL_MODEL)

    def _drain_export(self, site: SiteHandle, task_id: str,
                      timeout: float) -> dict | None:
        """Export a task from ``site``, pausing it first if it is
        running.  ``None`` when the task finished before it could be
        exported (the handoff lost the race — nothing to move).
        ``timeout`` is MODEL seconds on the site's clock: wall-clock
        free, like every other deadline in the stack."""
        mgr = site.manager
        payload = mgr.export_state(task_id)
        if payload is not None:
            return payload
        mgr.pause(task_id)
        try:
            task = mgr.get(task_id)
        except KeyError:
            return None
        clock = mgr.service.clock
        deadline = clock.virtual_elapsed + timeout
        while clock.virtual_elapsed < deadline:
            payload = mgr.export_state(task_id)
            if payload is not None:
                return payload
            if task._done.is_set():
                return None  # completed/failed before the pause landed
            self._poll_tick(clock, task)
        raise TimeoutError(
            f"task {task_id!r} did not drain off {site.site_id!r} "
            f"within {timeout} model seconds")

    def _precheck_adoption(self, task_id: str, origin_id: str,
                           to_site: str | None) -> None:
        """Raise BEFORE the destructive export if no site could adopt
        the task — endpoints never change across handoffs, so the last
        placed spec answers this without touching the origin."""
        ref = self._specs.get(task_id)
        if ref is None:
            raise LookupError(f"unknown task {task_id!r}")
        if to_site is not None:
            site = self._sites.get(to_site)
            if site is None or not (site.alive and site.resolves(ref)):
                raise LookupError(
                    f"site {to_site!r} cannot adopt {task_id!r}")
        else:
            self._candidates(ref, exclude=origin_id)

    def _await_settled(self, site: SiteHandle, task_id: str,
                       timeout: float) -> None:
        """Wait until ``task_id`` has no run loop (paused checkpoint
        durable, charge bookkeeping complete) or finished.  ``timeout``
        is MODEL seconds on the site's clock."""
        mgr = site.manager
        try:
            task = mgr.get(task_id)
        except KeyError:
            return
        clock = mgr.service.clock
        deadline = clock.virtual_elapsed + timeout
        while clock.virtual_elapsed < deadline:
            if task._done.is_set() or (task.status == TransferTask.PAUSED
                                       and mgr.settled(task_id)):
                return
            self._poll_tick(clock, task)
        raise TimeoutError(
            f"task {task_id!r} did not settle on {site.site_id!r} "
            f"within {timeout} model seconds")

    def handoff(self, task_id: str, to_site: str | None = None,
                timeout: float = 30.0) -> TransferTask | None:
        """Move one queued/paused/running task to a peer site.  A
        running task is paused and drained first, so its hole map (and
        checksum fold) travel and the peer re-sends only the holes.
        Returns the adopting site's task handle, or ``None`` when the
        task finished before it could move."""
        with self._lock:
            origin_id = self._placements.get(task_id)
            if origin_id is None:
                raise LookupError(f"unknown task {task_id!r}")
            origin = self._sites[origin_id]
            self._precheck_adoption(task_id, origin_id, to_site)
        with charge_to(self.charge_owner):
            h0 = origin.manager.service.clock.virtual_elapsed
            payload = self._drain_export(origin, task_id, timeout)
            if payload is None:
                return None
            spec = TransferSpec.from_payload(payload)
            with self._lock:
                try:
                    if to_site is not None:
                        site = self._sites[to_site]
                        if not (site.alive and site.resolves(spec)):
                            raise LookupError(
                                f"site {to_site!r} cannot adopt "
                                f"{task_id!r}")
                    else:
                        site = self._place(
                            spec, self._candidates(spec,
                                                   exclude=origin_id))
                except Exception:
                    # never strand an exported task: the origin adopts
                    # its own spec back (a queued re-import) rather
                    # than losing the traveled marker state
                    if origin.alive:
                        self._import_at_locked(origin, spec,
                                               reason="handoff-abort")
                    raise
                task = self._import_at_locked(site, spec, reason="handoff")
                self.metrics.handoffs += 1
                # the drain→adoption window, on the origin's clock;
                # record() charges nothing, so the coordinator's
                # third-party invariant (0.0 model seconds) holds
                origin.manager.tracer.record(
                    "handoff", "queue", h0,
                    origin.manager.service.clock.virtual_elapsed,
                    trace_id=spec.trace_id, task_id=task_id,
                    origin=origin_id, to=site.site_id)
        return task

    # ---- site failure ----------------------------------------------------
    def fail_site(self, site_id: str,
                  timeout: float = 30.0) -> list[tuple[str, str]]:
        """Take a site out of rotation and re-home every task it still
        holds.  Running tasks are paused (their partial progress is
        checkpointed through the site's MarkerStore — the emulation of
        a crash with durable restart markers), serialized, and resumed
        on peers re-sending only the holes.  Returns
        ``[(task_id, new_site_id), ...]`` for every task moved."""
        with self._lock:
            site = self._sites[site_id]
            site.alive = False
            doomed = [tid for tid, sid in self._placements.items()
                      if sid == site_id
                      and not self._tasks[tid]._done.is_set()]
            # a task no peer can adopt must NOT be exported (the export
            # would clear the only copy of its marker state); it is
            # still paused and drained below, so its checkpoint lands
            # on the dead site's durable store before teardown
            stranded = []
            for tid in doomed:
                try:
                    self._precheck_adoption(tid, site_id, None)
                except LookupError:
                    stranded.append(tid)
            adoptable = [tid for tid in doomed if tid not in stranded]
        moved: list[tuple[str, str]] = []
        try:
            with charge_to(self.charge_owner):
                # request every pause first — stranded tasks included,
                # or they would keep streaming on the "failed" site and
                # shutdown would forget their live charge tallies —
                # then drain: tasks checkpoint concurrently, not
                # serially
                for tid in doomed:
                    site.manager.pause(tid)
                for tid in stranded:
                    try:
                        self._await_settled(site, tid, timeout)
                    except TimeoutError:
                        pass  # reported via StrandedTasksError below
                for tid in adoptable:
                    try:
                        payload = self._drain_export(site, tid, timeout)
                    except TimeoutError:
                        # one wedged drain must not abort the rest of
                        # the failover (or lose the `moved` record)
                        stranded.append(tid)
                        continue
                    if payload is None:
                        continue  # finished during the drain
                    spec = TransferSpec.from_payload(payload)
                    with self._lock:
                        peer = self._place(
                            spec, self._candidates(spec,
                                                   exclude=site_id))
                        self._import_at_locked(peer, spec,
                                               reason="failover")
                    moved.append((tid, peer.site_id))
        finally:
            self.metrics.failovers += 1
            site.manager.shutdown(wait=False)
            self.bus.publish("failover",
                             data={"site": site_id, "moved": len(moved),
                                   "stranded": len(stranded)})
        if stranded:
            raise StrandedTasksError(site_id, moved, stranded)
        return moved

    # ---- lifecycle fan-out ----------------------------------------------
    def wait_all(self, timeout: float | None = None) -> bool:
        """Wait until every placed task has finished on its current
        site (paused tasks excluded, as in ``TransferManager``).

        Delegates to each live site's condition-variable ``wait_all``
        (one notify per completion — no wall-clock re-poll slicing);
        the outer loop only re-checks for tasks that migrated to
        another site (handoff / failover) while a site was draining.
        A task stranded on no live site falls back to a bounded wait
        on its own done event.

        ``timeout`` is a *wall* bound by design: it exists to hand
        control back to a caller even when the fleet is wedged, and
        model time never advances while every site idles — a model
        deadline could never fire.  Routed through the sanctioned
        ``wall_now`` helper (see the module docstring)."""
        deadline = None if timeout is None else wall_now() + timeout

        def _pending_locked():
            return [t for t in self._tasks.values()
                    if not t._done.is_set()
                    and t.status != TransferTask.PAUSED]

        while True:
            with self._lock:
                pending = _pending_locked()
                sites = [s for s in self._sites.values() if s.alive]
            if not pending:
                return True
            drained = True
            for site in sites:
                remaining = None if deadline is None \
                    else deadline - wall_now()
                if remaining is not None and remaining <= 0:
                    return False
                drained = site.manager.wait_all(remaining) and drained
            with self._lock:
                still = _pending_locked()
            if not still:
                return True
            if drained:
                # every live site is drained yet tasks remain: they are
                # stranded off-site (dead site / mid-migration) — wait
                # on the task itself, bounded so migrations re-check
                remaining = None if deadline is None \
                    else deadline - wall_now()
                if remaining is not None and remaining <= 0:
                    return False
                step = 0.1 if remaining is None else min(0.1, remaining)
                still[0].wait(step)

    def shutdown(self, wait: bool = True,
                 timeout: float | None = None) -> None:
        if wait:
            self.wait_all(timeout)
        with self._lock:
            sites = list(self._sites.values())
        for site in sites:
            if site.alive:
                site.manager.shutdown(wait=False)

    # ---- third-party invariant ------------------------------------------
    def model_seconds(self) -> float:
        """Model time charged to the coordinator across every site's
        clock.  The third-party contract says this is exactly 0.0: the
        coordinator moves references, the sites' worker threads move
        bytes (and charge their own tasks)."""
        clocks = {}
        with self._lock:
            for site in self._sites.values():
                clock = site.manager.service.clock
                clocks[id(clock)] = clock
        return sum(c.charged(self.charge_owner) for c in clocks.values())

    def wait_seconds(self) -> float:
        """Model time spent polling drain/settle deadlines, across every
        site's clock.  Charged to the ``#wait`` sibling identity — it is
        coordination overhead, observable here, and deliberately NOT a
        third-party violation: no data-plane byte ever moves under it."""
        clocks = {}
        with self._lock:
            for site in self._sites.values():
                clock = site.manager.service.clock
                clocks[id(clock)] = clock
        return sum(c.charged(self.wait_owner) for c in clocks.values())

    def assert_third_party(self) -> None:
        charged = self.model_seconds()
        if charged > 0.0:
            raise AssertionError(
                f"third-party violation: coordinator {self.charge_owner!r} "
                f"accrued {charged:.6f} model seconds of data-plane time")
