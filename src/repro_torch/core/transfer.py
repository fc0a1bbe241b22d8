"""Managed third-party transfer service (paper §2.1-§2.2, §4).

A copy of ``repro/core/transfer.py``: the port imports nothing of ``repro``.

The service plays the role Globus plays for Connector endpoints: a
*client* submits a transfer between two endpoints and walks away
("fire-and-forget"); the service

  * expands directories and tracks per-file progress (paper §2.2),
  * drives ``concurrency`` files in flight, each with ``parallelism``
    outstanding block streams on the DTN<->DTN data channel,
  * persists restart markers so a killed transfer resumes byte-exact
    (holey transfers, paper §3 ``get_read_range``),
  * retries transient faults (API quotas, flaky links) with backoff,
  * optionally enforces end-to-end integrity: checksum at source during
    streaming, re-read + checksum at destination after write (paper §7),
  * never puts the client in the data path (third-party semantics).

The data channel between the two connectors' DTNs is an emulated link
chosen from their locations: same location -> loopback, otherwise the
WAN (where GridFTP's parallel streams and out-of-order blocks are what
the paper credits for Conn-cloud's wins, §6.2).

Small-file regime (paper §5.3.2 / §8)
-------------------------------------
Eq. 4 (``T = N*t0 + B/R + S0``) says per-file overhead ``t0`` dominates
many-small-file transfers, so the service coalesces files smaller than
``TransferOptions.coalesce_threshold`` into *batches* of up to
``max_batch_files``.  Each batch shares ONE pipelined control-channel
exchange (one ``file_pipeline_cost``, not one per file) and one
``_FilePipe`` pool, and moves through the Connector bulk data-plane API
(``send_batch``/``recv_batch``) where Connectors amortize their own
per-file costs (request pipelining, grouped API admission, reused
session worker pools).  Files at or above the threshold keep the
per-file path with its intra-file ``parallelism``.  Size the threshold
from a fitted model via ``Advisor.coalesce_threshold`` (perfmodel);
``coalesce_threshold=0`` disables batching entirely.  A failure inside
a batch is contained to its file: that file falls back to the per-file
retry path while its batch-mates complete normally.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import threading
import time
from collections import deque
from contextlib import ExitStack, contextmanager
from dataclasses import dataclass, field

from ..obs.trace import NULL_TRACER
from .clock import (Clock, DEFAULT_CLOCK, Link, bind_charge_owner, charge_to,
                    loopback)
from .connector import (AppChannel, ByteRange, Connector, Credential, Session,
                        iter_files)
from .errors import (EndpointUnavailable, IntegrityError, PermanentError,
                     TransientError, TruncatedStream)
from .integrity import hasher

MB = 1024 * 1024


def _retry_jitter(task_id: str, path: str, attempt: int) -> float:
    """Deterministic uniform [0, 1) from (task_id, path, attempt) — the
    per-attempt jitter seed for retry backoff.  Hash-derived rather than
    drawn from a shared RNG stream so coalesced batch-mates (same fault,
    same attempt number, different paths) spread out instead of retrying
    in lockstep, while a same-seed replay of the same task stays
    byte-for-byte reproducible."""
    basis = f"{task_id}|{path}|{attempt}".encode()
    h = hashlib.sha1(basis).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


def _blame_endpoint(err: Exception, endpoint_id: str) -> None:
    """Stamp the endpoint an error is attributed to, if nothing (e.g. a
    health-plane denial) already claimed it — how the retry loop knows
    which breaker/budget to charge."""
    if not getattr(err, "endpoint_id", ""):
        try:
            err.endpoint_id = endpoint_id
        except (AttributeError, TypeError):
            pass  # exotic exception types without settable attrs


class TaskInterrupted(Exception):
    """Control-flow signal: a pause/cancel request reached an in-flight
    file.  Never counts as a fault or a failure — the interrupted file
    stays pending, its partial ranges checkpointed through the
    :class:`MarkerStore` so a resume re-opens only the holes."""


# --------------------------------------------------------------------------
# credential management (paper Fig. 3: the GCS-manager role)
# --------------------------------------------------------------------------
class CredentialStore:
    """Credentials are registered out-of-band, keyed by endpoint; the
    transfer service only ever handles the *reference* (paper: "The
    credentials are never sent via the hosted Globus transfer
    service")."""

    def __init__(self):
        self._creds: dict[str, Credential] = {}

    def register(self, endpoint_id: str, cred: Credential) -> None:
        self._creds[endpoint_id] = cred

    def lookup(self, endpoint_id: str) -> Credential | None:
        return self._creds.get(endpoint_id)

    def identity(self, endpoint_id: str) -> str:
        """Tenant identity behind an endpoint's credential — the unit of
        fair scheduling in the manager.  Credentials may carry an
        explicit ``identity``/``user`` field; otherwise the scheme is the
        best available grouping, and unregistered endpoints share one
        anonymous tenant."""
        cred = self._creds.get(endpoint_id)
        if cred is None:
            return "anonymous"
        return cred.data.get("identity") or cred.data.get("user") \
            or cred.scheme


@dataclass(frozen=True)
class Endpoint:
    """A (connector, base path) pair, as registered with the service."""

    connector: Connector
    path: str
    endpoint_id: str = ""

    def resolved_id(self) -> str:
        return self.endpoint_id or self.connector.name


# --------------------------------------------------------------------------
# options / task bookkeeping
# --------------------------------------------------------------------------
@dataclass
class TransferOptions:
    concurrency: int = 4            # files in flight (paper "cc")
    parallelism: int = 4            # streams per file on the data channel
    blocksize: int = 4 * MB
    integrity: bool = False         # paper §7 strong integrity checking
    checksum_algorithm: str = "sha256"
    max_retries: int = 5
    max_integrity_retries: int = 2
    retry_backoff: float = 0.5      # model seconds, doubled per attempt
    #: model seconds a file keeps waiting on consecutive breaker/budget
    #: fast-fail denials (``EndpointUnavailable``) before giving up.
    #: Denials are local — no storage op happens — so they do NOT count
    #: against ``max_retries``; this deadline is what bounds them.  The
    #: window restarts on an admitted attempt AND on any breaker
    #: transition in the health registry (recovery progress: probes
    #: cycling, breakers closing), so a file only gives up after the
    #: health plane has been *stuck* this long — e.g. a dead endpoint
    #: whose retry budget is dry and whose breaker stays open.
    unavailable_patience: float = 30.0
    startup_cost: float = 2.3       # third-party coordination (paper §5.4)
    file_pipeline_cost: float = 0.005  # pipelined per-file command cost
    auto_tune: bool = False         # §8: probe concurrency upward
    max_concurrency: int = 32
    verify_sampling: float = 1.0    # fraction of files integrity-checked
    #: files strictly smaller than this are coalesced into pipelined
    #: batches (§5.3.2/§8 small-file regime); 0 disables batching.
    #: ``Advisor.coalesce_threshold`` sizes this from a fitted model.
    coalesce_threshold: int = 1 * MB
    max_batch_files: int = 32       # files per pipelined batch
    #: per-range digest granularity for integrity-on transfers: streamed
    #: holes are chopped into segments of this many bytes and each
    #: durable segment's digest is journaled in the MarkerStore, so a
    #: resume (or a federated handoff) folds the prior segments instead
    #: of re-reading the source for the §7 end-to-end checksum
    digest_segment: int = 4 * MB


@dataclass
class FileResult:
    src: str
    dst: str
    size: int
    attempts: int = 0
    checksum: str | None = None
    ok: bool = False
    error: str | None = None


@dataclass
class TaskStats:
    bytes_total: int = 0
    bytes_done: int = 0
    files_total: int = 0
    files_done: int = 0
    files_failed: int = 0
    faults_retried: int = 0
    integrity_failures: int = 0
    #: files a coalesced batch handed back to the per-file retry path
    batch_fallbacks: int = 0
    #: files satisfied from the replica catalog (a near-destination
    #: replica read instead of a source read) and the bytes they saved
    #: the wire; ``replica_fallbacks`` counts replica reads that failed
    #: validation (stale/corrupt/evicted) and fell back to a transfer
    replica_hits: int = 0
    replica_bytes: int = 0
    replica_fallbacks: int = 0
    #: transient-fault retries keyed by error class name (observability
    #: for fault schedules: RateLimitError / FaultInjected / ...)
    retries_by_kind: dict = field(default_factory=dict)
    wall_seconds: float = 0.0
    effective_concurrency: float = 0.0
    #: control-plane provenance (filled by the TransferManager)
    tenant: str = ""
    route: str = ""
    #: federation provenance: the site control plane currently running
    #: the task, and the site it was first submitted at — attribution
    #: (tenant, model seconds) follows the task across handoffs
    site: str = ""
    origin_site: str = ""
    #: Advisor prediction vs. what the model clock actually charged, so
    #: the per-route perf model can be refit online from live traffic
    predicted_seconds: float = 0.0
    actual_model_seconds: float = 0.0
    #: how many times the task was paused and resumed
    resumes: int = 0
    #: span category -> model seconds charged under that category's
    #: spans (observability plane; merged per run by the manager, and
    #: traveling with the task across federation handoffs)
    span_seconds: dict = field(default_factory=dict)

    def time_budget(self) -> dict[str, float]:
        """Decompose ``actual_model_seconds`` into span categories.

        The categorized tallies come from the very same ``Clock.sleep``
        calls that produced ``actual_model_seconds`` (obs plane: every
        charge lands on the innermost open span), and the ``"other"``
        bucket is defined as the remainder — so the returned values sum
        to the charged total by construction, making the Advisor's Eq. 4
        prediction error *attributable* ("the model missed because
        backoff, not wire")."""
        budget: dict[str, float] = {}
        categorized = 0.0
        for cat in sorted(self.span_seconds):
            secs = self.span_seconds[cat]
            budget[cat] = budget.get(cat, 0.0) + secs
            categorized += secs
        budget["other"] = budget.get("other", 0.0) \
            + (self.actual_model_seconds - categorized)
        return budget


class TransferTask:
    """Control-channel handle the client polls (never in the data path)."""

    PENDING, ACTIVE, SUCCEEDED, FAILED = "PENDING", "ACTIVE", "SUCCEEDED", "FAILED"
    PAUSED, CANCELLED = "PAUSED", "CANCELLED"
    #: terminal on THIS control plane only: the task was serialized and
    #: handed to a peer site, which owns its lifecycle from here on
    HANDED_OFF = "HANDED_OFF"

    RATE_WINDOW = 4096   # ring-buffer capacity for throughput samples
    EVENTS_WINDOW = 4096  # ring-buffer capacity for the event log

    def __init__(self, task_id: str, clock: Clock | None = None):
        self.task_id = task_id
        self.status = self.PENDING
        self.stats = TaskStats()
        self.files: list[FileResult] = []
        #: observability plane: the trace id this task's spans attach
        #: to; assigned by the manager at submit and carried across
        #: federation handoffs in the TransferSpec
        self.trace_id = ""
        # (model_time, message) pairs — stamped with the owning
        # service's clock, so same-seed runs log identical streams.
        # Bounded ring (mirrors the StatusBus subscriber discipline):
        # the oldest entries fall off past EVENTS_WINDOW, counted
        # exactly in events_dropped, so a million-block task can't grow
        # memory without limit.
        self._events: deque[tuple[float, str]] = deque()
        self.events_dropped = 0
        #: rate samples shed by the bounded ring (exact count; the ring
        #: itself is the deque's maxlen)
        self.rate_samples_dropped = 0
        self._clock = clock or DEFAULT_CLOCK
        #: service-plane hook: the owning manager points this at its
        #: StatusBus so progress ticks stream to subscribers
        self._emit = None
        self._done = threading.Event()
        self._lock = threading.Lock()
        # control plane: pause/cancel requests checked by the run loop
        # between work items and by in-flight pipes between block claims
        self._pause_req = threading.Event()
        self._cancel_req = threading.Event()
        # set whenever no run loop is executing this task (a paused task
        # is idle but not done; the manager waits on this to re-dispatch)
        self._idle = threading.Event()
        self._idle.set()
        # bounded ring buffer: append is O(1), old samples fall off
        self._rate_samples: deque[tuple[float, int]] = deque(
            maxlen=self.RATE_WINDOW)

    # ---- control plane -------------------------------------------------
    def request_pause(self) -> None:
        self._pause_req.set()

    def request_cancel(self) -> None:
        self._cancel_req.set()

    def interrupt_exc(self) -> TaskInterrupted | None:
        """Non-None when a pause/cancel request is outstanding; handed to
        in-flight pipes so they stop claiming new block ranges."""
        if self._cancel_req.is_set():
            return TaskInterrupted("cancelled")
        if self._pause_req.is_set():
            return TaskInterrupted("paused")
        return None

    def interrupted(self) -> bool:
        return self._pause_req.is_set() or self._cancel_req.is_set()

    def wait_idle(self, timeout: float | None = None) -> bool:
        """True once no run loop is executing the task (done OR paused)."""
        return self._idle.wait(timeout)

    @property
    def events(self) -> list[tuple[float, str]]:
        """Snapshot of the retained event log, oldest first (a list, so
        existing ``task.events[-5:]`` readers keep working); entries
        shed by the ring are counted in ``events_dropped``."""
        with self._lock:
            return list(self._events)

    def log(self, msg: str) -> None:
        with self._lock:
            if len(self._events) >= self.EVENTS_WINDOW:
                self._events.popleft()
                self.events_dropped += 1
            self._events.append((self._clock.virtual_elapsed, msg))

    def _bytes_tick(self, n: int) -> None:
        """Credit (or, for integrity re-sends, un-credit) progress.
        Stamped with *model* time — like ``events``, so rate samples
        and streamed progress events are deterministic under the
        simulated clock."""
        now = self._clock.virtual_elapsed
        with self._lock:
            self.stats.bytes_done += n
            if len(self._rate_samples) == self.RATE_WINDOW:
                self.rate_samples_dropped += 1  # maxlen sheds the oldest
            self._rate_samples.append((now, self.stats.bytes_done))
            done, total = self.stats.bytes_done, self.stats.bytes_total
        emit = self._emit
        if emit is not None:  # outside the task lock: the bus is a leaf
            emit("progress", {"bytes_done": done, "bytes_total": total})

    def _note_fault(self, err: Exception) -> None:
        """Account one transient fault the service will work around, by
        error class — makes a fault schedule observable in TaskStats."""
        with self._lock:
            self.stats.faults_retried += 1
            kind = type(err).__name__
            self.stats.retries_by_kind[kind] = \
                self.stats.retries_by_kind.get(kind, 0) + 1

    def _note_batch_fallback(self) -> None:
        with self._lock:
            self.stats.batch_fallbacks += 1

    def _note_replica(self, nbytes: int) -> None:
        """Account one file served from the replica catalog — ``nbytes``
        never crossed the source's wire."""
        with self._lock:
            self.stats.replica_hits += 1
            self.stats.replica_bytes += nbytes

    def _note_replica_fallback(self) -> None:
        with self._lock:
            self.stats.replica_fallbacks += 1

    def _note_probe(self) -> None:
        """Account one attempt admitted as a half-open breaker probe —
        a distinct ``retries_by_kind`` pseudo-kind (not a fault: the
        probe may well succeed and close the breaker)."""
        with self._lock:
            self.stats.retries_by_kind["HalfOpenProbe"] = \
                self.stats.retries_by_kind.get("HalfOpenProbe", 0) + 1

    def throughput(self, window: float = 2.0) -> float:
        """Instantaneous B/s over the trailing window (perf markers).
        ``window`` is *model* seconds — samples are model-clock
        stamped."""
        with self._lock:
            if len(self._rate_samples) < 2:
                return 0.0
            t1, b1 = self._rate_samples[-1]
            for t0, b0 in reversed(self._rate_samples):
                if t1 - t0 >= window:
                    break
            dt = max(1e-9, t1 - t0)
            return (b1 - b0) / dt

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def _finish(self, status: str) -> None:
        self.status = status
        self._idle.set()
        self._done.set()


# --------------------------------------------------------------------------
# restart markers
# --------------------------------------------------------------------------
class MarkerStore:
    """Persists per-file completed ranges so a killed service resumes
    without re-sending bytes (paper §3 restart/'holey' transfers).

    Layout per task: a base snapshot ``<task>.marker.json`` plus an
    append-only JSONL journal ``<task>.marker.jsonl``.  Per-file
    progress is ``append``-ed — O(record) I/O instead of rewriting the
    whole task state on every file — and the journal is folded into the
    snapshot every ``compact_every`` records.  ``load``/``save``/
    ``append``/``clear`` all take the store lock, so a resume racing an
    in-flight flush can never observe a torn state.
    """

    def __init__(self, root: str, compact_every: int = 256):
        self.root = root
        self.compact_every = compact_every
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._journal_counts: dict[str, int] = {}

    def _path(self, task_id: str) -> str:
        return os.path.join(self.root, f"{task_id}.marker.json")

    def _journal_path(self, task_id: str) -> str:
        return os.path.join(self.root, f"{task_id}.marker.jsonl")

    def load(self, task_id: str) -> dict:
        with self._lock:
            return self._load_locked(task_id)

    def _load_locked(self, task_id: str) -> dict:
        state = {"files": {}}
        p = self._path(task_id)
        if os.path.exists(p):
            with open(p) as f:
                state = json.load(f)
        j = self._journal_path(task_id)
        if os.path.exists(j):
            with open(j) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        break  # torn tail from a crash mid-append
                    st = state["files"].setdefault(
                        rec["file"], {"done": [], "complete": False})
                    for k in ("done", "complete", "checksum", "src_sig"):
                        if k in rec:
                            st[k] = rec[k]
                    if rec.get("reset_digests"):
                        # an integrity re-send threw the prior bytes
                        # away; their digests must not survive it
                        st.pop("digests", None)
                    if "digests" in rec:
                        # per-range digests accumulate across records (a
                        # resume adds its holes' segments to the prior
                        # run's), unlike "done" where the latest wins
                        st.setdefault("digests", {}).update(rec["digests"])
        return state

    def save(self, task_id: str, state: dict) -> None:
        """Full snapshot: rewrites the base and truncates the journal."""
        with self._lock:
            self._save_locked(task_id, state)

    def _save_locked(self, task_id: str, state: dict) -> None:
        p = self._path(task_id)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, p)
        j = self._journal_path(task_id)
        if os.path.exists(j):
            os.remove(j)
        self._journal_counts.pop(task_id, None)

    def append(self, task_id: str, path: str, entry: dict) -> None:
        """Record one file's progress — O(record), not O(task state)."""
        with self._lock:
            with open(self._journal_path(task_id), "a") as f:
                f.write(json.dumps({"file": path, **entry}) + "\n")
            n = self._journal_counts.get(task_id, 0) + 1
            self._journal_counts[task_id] = n
            if n >= self.compact_every:
                self._save_locked(task_id, self._load_locked(task_id))

    def clear(self, task_id: str) -> None:
        with self._lock:
            for p in (self._path(task_id), self._journal_path(task_id)):
                if os.path.exists(p):
                    os.remove(p)
            self._journal_counts.pop(task_id, None)

    # ---- marker travel (federation handoff) ------------------------------
    def export_state(self, task_id: str) -> dict:
        """Folded snapshot of a task's marker state, JSON-clean — the
        hole maps (and per-range digests) that let a peer control plane
        resume the task re-sending only the missing bytes."""
        return self.load(task_id)

    def import_state(self, task_id: str, state: dict) -> None:
        """Install a traveled marker snapshot for ``task_id`` (full
        snapshot semantics: replaces any local state)."""
        self.save(task_id, state)


def _merge_ranges(ranges: list[list[int]]) -> list[list[int]]:
    out: list[list[int]] = []
    for off, ln in sorted(ranges):
        if out and off <= out[-1][0] + out[-1][1]:
            end = max(out[-1][0] + out[-1][1], off + ln)
            out[-1][1] = end - out[-1][0]
        else:
            out.append([off, ln])
    return out


class IntervalTracker:
    """Incrementally-merged disjoint interval set.

    ``add`` keeps the ``[offset, length]`` list sorted and coalesced via
    bisect instead of re-sorting every recorded range on every block ack
    (the old ``_merge_ranges``-per-callback hot path).  Streams write
    mostly-sequentially, so intervals collapse and the list stays tiny.
    """

    __slots__ = ("_r", "covered")

    def __init__(self, ranges=None):
        self._r: list[list[int]] = _merge_ranges(
            [list(r) for r in (ranges or [])])
        self.covered: int = sum(ln for _, ln in self._r)

    def add(self, offset: int, length: int) -> None:
        if length <= 0:
            return
        r = self._r
        end = offset + length
        i = bisect.bisect_right(r, offset, key=lambda e: e[0])
        if i > 0 and r[i - 1][0] + r[i - 1][1] >= offset:
            i -= 1
            offset = r[i][0]
            end = max(end, r[i][0] + r[i][1])
        j = i
        while j < len(r) and r[j][0] <= end:
            end = max(end, r[j][0] + r[j][1])
            j += 1
        removed = sum(ln for _, ln in r[i:j])
        r[i:j] = [[offset, end - offset]]
        self.covered += (end - offset) - removed

    def ranges(self) -> list[list[int]]:
        return [list(x) for x in self._r]


def _holes(size: int, done: list[list[int]]) -> list[ByteRange]:
    done = _merge_ranges(done)
    holes, at = [], 0
    for off, ln in done:
        if off > at:
            holes.append(ByteRange(at, off - at))
        at = max(at, off + ln)
    if at < size:
        holes.append(ByteRange(at, size - at))
    return holes


# --------------------------------------------------------------------------
# streaming per-range digests (§7 checksum fold across pauses/handoffs)
# --------------------------------------------------------------------------
#: composite checksums (folded from per-range digests) carry this prefix
#: so verification knows to chop the destination at the same boundaries
COMPOSITE_PREFIX = "r:"


def _range_key(offset: int, length: int) -> str:
    return f"{offset}:{length}"


def _key_range(key: str) -> tuple[int, int]:
    off, _, ln = key.partition(":")
    return int(off), int(ln)


class RangeDigester:
    """Streaming digests over a fixed plan of byte segments.

    The plan is the run's holes chopped into ``segment``-byte pieces.
    ``push`` folds blocks in ascending-offset order (buffering the
    out-of-order ones) and finalizes one digest per completed segment —
    so when a transfer is paused, cancelled, or handed to a peer site,
    the digests of the fully-landed segments travel in the MarkerStore
    and the resume *folds* them into the §7 end-to-end checksum instead
    of re-reading the source.
    """

    def __init__(self, plan: list[ByteRange], algorithm: str):
        self._plan = list(plan)
        self._alg = algorithm
        self._i = 0
        self._h = hasher(algorithm) if self._plan else None
        self._pos = self._plan[0].offset if self._plan else 0
        self._pending: dict[int, bytes] = {}
        #: "offset:length" -> hexdigest for every completed segment
        self.digests: dict[str, str] = {}

    @classmethod
    def for_holes(cls, holes: list[ByteRange], algorithm: str,
                  segment: int) -> "RangeDigester":
        segment = max(1, segment)
        plan = []
        for h in holes:
            off = h.offset
            while off < h.end:
                ln = min(segment, h.end - off)
                plan.append(ByteRange(off, ln))
                off += ln
        return cls(plan, algorithm)

    def push(self, offset: int, data: bytes) -> None:
        """Fold one streamed block (caller holds the pipe lock).  Blocks
        arrive from claim order so they never span holes, but may span
        the digester's segment boundaries."""
        if self._i >= len(self._plan):
            return
        self._pending[offset] = data
        while self._i < len(self._plan) and self._pos in self._pending:
            chunk = self._pending.pop(self._pos)
            while chunk and self._i < len(self._plan):
                seg = self._plan[self._i]
                take = min(len(chunk), seg.end - self._pos)
                self._h.update(chunk[:take])
                self._pos += take
                chunk = chunk[take:]
                if self._pos >= seg.end:
                    self.digests[_range_key(seg.offset, seg.length)] = \
                        self._h.hexdigest()
                    self._i += 1
                    if self._i < len(self._plan):
                        self._h = hasher(self._alg)
                        self._pos = self._plan[self._i].offset

    def completed(self, durable: list[list[int]]) -> dict[str, str]:
        """Digests of segments whose bytes are all *durable* (inside the
        given written ranges).  A block is folded at push time, before
        the storage write acks — a segment digest is only trustworthy
        for resume once every byte under it actually landed."""
        merged = _merge_ranges([list(r) for r in durable])
        out = {}
        for key, hexd in self.digests.items():
            off, ln = _key_range(key)
            if any(o <= off and off + ln <= o + l for o, l in merged):
                out[key] = hexd
        return out


def _digest_ranges(digests: dict[str, str]) -> list[list[int]]:
    """The byte ranges a digest map covers, merged."""
    return _merge_ranges([[off, ln] for off, ln in
                          (_key_range(k) for k in digests)])


def compose_digests(digests: dict[str, str], size: int,
                    algorithm: str) -> str | None:
    """Fold per-range digests into one composite checksum, or ``None``
    when the segments do not tile ``[0, size)`` exactly (some bytes were
    never digested — the caller must fall back to a source re-read).
    The fold is order-and-boundary sensitive, so destination
    verification recomputes it over the same boundaries."""
    if size == 0:
        return None
    segs = sorted((_key_range(k) for k in digests), key=lambda r: r[0])
    at = 0
    for off, ln in segs:
        if off != at:
            return None
        at = off + ln
    if at != size:
        return None
    outer = hasher(algorithm)
    for off, ln in segs:
        hexd = digests[_range_key(off, ln)]
        outer.update(f"{off}:{ln}:{hexd}\n".encode())
    return COMPOSITE_PREFIX + outer.hexdigest()


class _RangedDigestChannel(AppChannel):
    """Read-only AppChannel that streams a file once and folds it into a
    :class:`RangeDigester` over explicit boundaries — destination-side
    §7 verification of a composite checksum (one dst read, no source
    re-read)."""

    def __init__(self, digester: RangeDigester, size: int, blocksize: int):
        self._dig = digester
        self._size = size
        self._bs = blocksize
        self._next = 0
        self._lock = threading.Lock()

    def set_size(self, size: int) -> None:
        self._size = min(self._size, size)

    def write(self, offset: int, data: bytes) -> None:
        with self._lock:
            self._dig.push(offset, data)

    def read(self, offset: int, length: int) -> bytes:
        raise NotImplementedError("digest channel is read-only")

    def get_concurrency(self) -> int:
        return 1

    def get_blocksize(self) -> int:
        return self._bs

    def get_read_range(self) -> ByteRange | None:
        with self._lock:
            if self._next >= self._size:
                return None
            length = min(self._bs, self._size - self._next)
            rng = ByteRange(self._next, length)
            self._next += length
            return rng

    def bytes_written(self, offset: int, length: int) -> None:
        pass


# --------------------------------------------------------------------------
# per-file data pipe (the GridFTP data channel between two DTNs)
# --------------------------------------------------------------------------
class _FilePipe:
    """Joins src-connector Send and dst-connector Recv for one file.

    The send side claims outstanding byte ranges (``parallelism`` in
    flight), pays transmission on the DTN<->DTN link, and queues blocks;
    the recv side consumes blocks (possibly out of order — storage
    writes are positional) and acknowledges via ``bytes_written``.

    ``single_consumer=True`` (the batch path) relaxes the recv-side
    drain condition: with exactly one consumer stream per file there is
    no sibling stream that could requeue a partial block, so the
    consumer may exit as soon as the sender is done and the ready queue
    is empty — it acknowledges storage durability *after* the bulk PUT,
    which would otherwise deadlock on the outstanding-block count.
    """

    def __init__(self, size: int, holes: list[ByteRange], link: Link,
                 options: TransferOptions, on_written, checksum_alg: str | None,
                 single_consumer: bool = False, abort=None,
                 digester: RangeDigester | None = None):
        self.size = size
        self.link = link
        self.opt = options
        self.on_written = on_written
        #: optional () -> Exception | None checked between block claims;
        #: a pause/cancel request stops the stream at block granularity
        self.abort = abort
        self._claims: deque[ByteRange] = deque(holes)
        self._ready: dict[int, bytes] = {}
        self._ready_order: deque[int] = deque()
        self._outstanding = 0   # blocks consumed but not yet durable
        self._claimed = 0       # blocks claimed but not yet pushed
        self._send_done = False
        self._single_consumer = single_consumer
        self._error: Exception | None = None
        self._cv = threading.Condition()
        # incremental source checksum (folds in claim order, §7)
        self._hash = hasher(checksum_alg) if checksum_alg else None
        self._fold_at = holes[0].offset if holes else 0
        self._fold_pending: dict[int, bytes] = {}
        #: optional per-segment digester riding the same block stream
        #: (checksum fold across pauses/handoffs)
        self.digester = digester
        self.send_channel = _SendSide(self)
        self.recv_channel = _RecvSide(self)

    # ---- send side ----
    def claim(self) -> ByteRange | None:
        with self._cv:
            if self._error is not None:
                return None
            if self.abort is not None and self._claims:
                err = self.abort()
                if err is not None:
                    # stop handing out ranges; already-written ranges
                    # stay durable and marker-checkpointed, so a resume
                    # re-opens only the holes
                    self._error = err
                    self._send_done = True
                    self._cv.notify_all()
                    return None
            while self._claims:
                rng = self._claims[0]
                take = min(self.opt.blocksize, rng.length)
                if take == rng.length:
                    self._claims.popleft()
                else:
                    self._claims[0] = ByteRange(rng.offset + take,
                                                rng.length - take)
                self._claimed += 1
                return ByteRange(rng.offset, take)
            self._send_done = True
            self._cv.notify_all()
            return None

    def push(self, offset: int, data: bytes) -> None:
        # data-channel transmission happens OUTSIDE the lock; GridFTP's
        # ``parallelism`` TCP streams are modeled as a rate multiplier
        # (paper §2.2 / §6: parallel streams + out-of-order blocks)
        self.link.transmit(len(data), streams=self.opt.parallelism)
        with self._cv:
            self._claimed = max(0, self._claimed - 1)
            self._ready[offset] = data
            self._ready_order.append(offset)
            if self._hash is not None:
                self._fold_pending[offset] = data
                while self._fold_at in self._fold_pending:
                    chunk = self._fold_pending.pop(self._fold_at)
                    self._hash.update(chunk)
                    self._fold_at += len(chunk)
            if self.digester is not None:
                self.digester.push(offset, data)
            self._cv.notify_all()

    def fail(self, err: Exception) -> None:
        with self._cv:
            if self._error is None:
                self._error = err
            self._send_done = True
            self._cv.notify_all()

    def send_complete(self) -> None:
        """Sender signalled completion (``finished(None)``).  Covers
        connectors that stop early — e.g. a file that shrank below its
        planned size — without ever draining the claim queue; any claim
        still unpushed at this point is abandoned, and the recv side
        must not wait for it."""
        with self._cv:
            self._send_done = True
            self._claimed = 0
            self._cv.notify_all()

    # ---- recv side ----
    def next_block_range(self) -> ByteRange | None:
        with self._cv:
            while True:
                if self._error is None and self.abort is not None:
                    # pause/cancel must also stop the receive side: the
                    # sender has no backpressure, so once every range is
                    # claimed the claim-side abort gate can never fire
                    # again and an in-flight file would run to completion
                    # despite the request.  Written ranges stay durable
                    # and checkpointed; undelivered blocks are re-sent as
                    # holes on resume.
                    err = self.abort()
                    if err is not None:
                        self._error = err
                        self._send_done = True
                        self._cv.notify_all()
                if self._error is not None:
                    raise self._error
                if self._ready_order:
                    off = self._ready_order.popleft()
                    return ByteRange(off, len(self._ready[off]))
                if (self._send_done and not self._ready
                        and self._claimed == 0
                        and (self._single_consumer
                             or self._outstanding == 0)):
                    return None
                self._cv.wait(timeout=10.0)

    def take(self, offset: int, length: int) -> bytes:
        with self._cv:
            data = self._ready.pop(offset)
            if length < len(data):  # partial consume: requeue remainder
                self._ready[offset + length] = data[length:]
                self._ready_order.appendleft(offset + length)
                data = data[:length]
            # outstanding counts blocks between consumption and the
            # storage-durability ack (written), so a claim the sender
            # abandoned can never wedge the drain condition
            self._outstanding += 1
            return data

    def written(self, offset: int, length: int) -> None:
        with self._cv:
            self._outstanding -= 1
            self._cv.notify_all()
        self.on_written(offset, length)

    def source_checksum(self) -> str | None:
        return self._hash.hexdigest() if self._hash is not None else None


class _SendSide(AppChannel):
    def __init__(self, pipe: _FilePipe):
        self.pipe = pipe

    def set_size(self, size: int) -> None:
        pass  # pipe already knows the stat size

    def write(self, offset: int, data: bytes) -> None:
        self.pipe.push(offset, data)

    def read(self, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def get_concurrency(self) -> int:
        # stream parallelism is modeled at the link level (push);
        # one claimer keeps modeled time deterministic
        return 1

    def get_blocksize(self) -> int:
        return self.pipe.opt.blocksize

    def get_read_range(self) -> ByteRange | None:
        return self.pipe.claim()

    def bytes_written(self, offset: int, length: int) -> None:
        pass

    def finished(self, error: Exception | None = None) -> None:
        if error is not None:
            self.pipe.fail(error)
        else:
            self.pipe.send_complete()


class _RecvSide(AppChannel):
    def __init__(self, pipe: _FilePipe):
        self.pipe = pipe

    def write(self, offset: int, data: bytes) -> None:
        raise NotImplementedError

    def read(self, offset: int, length: int) -> bytes:
        return self.pipe.take(offset, length)

    def get_concurrency(self) -> int:
        return 1  # see _SendSide.get_concurrency

    def get_blocksize(self) -> int:
        return self.pipe.opt.blocksize

    def get_read_range(self) -> ByteRange | None:
        return self.pipe.next_block_range()

    def bytes_written(self, offset: int, length: int) -> None:
        self.pipe.written(offset, length)

    def finished(self, error: Exception | None = None) -> None:
        if error is not None:
            # a storage-write failure must wake every blocked stream,
            # stop the send side claiming more ranges, and surface the
            # error to the retry loop
            self.pipe.fail(error)


class _BatchEntry:
    """One file's slot in a coalesced batch."""

    __slots__ = ("spath", "dpath", "size", "st", "holes", "full",
                 "tracker", "pipe", "lock", "prior_done", "digester")

    def __init__(self, spath: str, dpath: str, size: int, st: dict,
                 holes: list[ByteRange]):
        self.spath = spath
        self.dpath = dpath
        self.size = size
        self.st = st
        self.holes = holes
        self.full = holes == [ByteRange(0, size)] or size == 0
        self.prior_done = [list(r) for r in st.get("done", [])]
        self.tracker = IntervalTracker(st.get("done", []))
        self.pipe: _FilePipe | None = None
        self.digester: RangeDigester | None = None
        self.lock = threading.Lock()


# --------------------------------------------------------------------------
# the service
# --------------------------------------------------------------------------
def _location(connector: Connector) -> str:
    return getattr(connector, "location", None) or _infer_location(connector)


def _infer_location(connector: Connector) -> str:
    placement = getattr(connector, "placement", None)
    if placement == "cloud":
        storage = getattr(connector, "storage", None)
        provider = storage.profile.provider if storage is not None else "cloud"
        return f"cloud:{provider}"
    return "site"


class TransferService:
    """The per-task transfer engine (expansion, pipes, retries, markers).

    Queueing and worker ownership live one layer up in
    :class:`~repro_torch.core.manager.TransferManager`; a bare ``submit`` here
    is just the degenerate case — it lazily creates a private manager and
    hands the task over, so a single task and a 10k-task fleet run the
    same code path."""

    #: worker budget of the implicit manager behind bare ``submit`` calls
    DEFAULT_WORKERS = 8

    def __init__(self, credential_store: CredentialStore | None = None,
                 marker_root: str | None = None, clock: Clock | None = None,
                 data_link_factory=None, health=None, catalog=None,
                 tracer=None):
        self.creds = credential_store or CredentialStore()
        #: observability plane: span collector every run's charging
        #: sites report to.  Defaults to the shared disabled tracer so a
        #: bare service pays (almost) nothing; the TransferManager
        #: installs a live one
        self.tracer = tracer or NULL_TRACER
        self.markers = MarkerStore(marker_root or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "repro-markers"))
        self.clock = clock or DEFAULT_CLOCK
        #: optional shared :class:`~repro_torch.core.health.EndpointHealth`
        #: registry; when set, every attempt is gated by the endpoint
        #: circuit breakers + retry budgets and reports its outcome back
        self.health = health
        #: optional shared :class:`~repro_torch.catalog.ReplicaCatalog`; when
        #: set (and integrity is on — the fold is the content address),
        #: finished files are published at durable-commit time and new
        #: files are satisfied by verified near-destination replica
        #: reads instead of source reads whenever a fresh entry exists
        self.catalog = catalog
        self._link_factory = data_link_factory or self._default_link
        self._tasks: dict[str, TransferTask] = {}
        self._manager = None
        self._manager_lock = threading.Lock()

    # DTN<->DTN data channel selection (Figs. 4/5 topology)
    def _default_link(self, src: Connector, dst: Connector) -> Link:
        if _location(src) == _location(dst):
            return loopback(self.clock)
        from ..connectors.cloud import wan_link  # local import, no cycle
        return wan_link(self.clock)

    def default_manager(self):
        """The implicit one-service manager behind bare ``submit``."""
        with self._manager_lock:
            if self._manager is None:
                from .manager import TransferManager  # no import cycle
                # no session pool: bare submit keeps the historical
                # start/destroy-per-task scope, since nothing ever
                # calls shutdown on the implicit manager (pooled
                # sessions would leak their batch worker pools)
                self._manager = TransferManager(
                    service=self, max_workers=self.DEFAULT_WORKERS,
                    per_endpoint_cap=None, share_sessions=False)
            return self._manager

    def make_task(self, src: Endpoint, dst: Endpoint,
                  task_id: str | None = None) -> TransferTask:
        """Create + register the control-channel handle for one task."""
        if task_id is None:
            # route digest for debuggability + random uniquifier so
            # resubmitting the same src->dst never collides with (or
            # silently inherits the restart markers of) an earlier task
            basis = f"{src.resolved_id()}:{src.path}->{dst.resolved_id()}:{dst.path}"
            task_id = (hashlib.sha1(basis.encode()).hexdigest()[:12]
                       + "-" + os.urandom(4).hex())
        task = TransferTask(task_id, clock=self.clock)
        self._tasks[task_id] = task
        return task

    def submit(self, src: Endpoint, dst: Endpoint,
               options: TransferOptions | None = None,
               task_id: str | None = None, sync: bool = False) -> TransferTask:
        """Submit a transfer.  Pass ``task_id`` explicitly to make the
        task resumable after a kill (restart markers are keyed by it);
        the default id is unique per submission, so resubmitting the
        same route starts fresh instead of colliding with — or silently
        inheriting the markers of — an earlier task."""
        return self.default_manager().submit(src, dst, options,
                                             task_id=task_id, sync=sync)

    def get(self, task_id: str) -> TransferTask:
        return self._tasks[task_id]

    # ---- execution -------------------------------------------------------
    @contextmanager
    def _own_sessions(self, src: Endpoint, dst: Endpoint):
        """Default session scope: start/destroy per run.  A manager with
        a session pool substitutes shared long-lived sessions instead."""
        s_src = src.connector.start(self.creds.lookup(src.resolved_id()))
        try:
            s_dst = dst.connector.start(self.creds.lookup(dst.resolved_id()))
            try:
                yield s_src, s_dst
            finally:
                dst.connector.destroy(s_dst)
        finally:
            src.connector.destroy(s_src)

    def _run(self, task: TransferTask, src: Endpoint, dst: Endpoint,
             opt: TransferOptions, session_scope=None) -> None:
        """Execute (or re-execute, after a pause) one task.  Progress
        counters are recomputed from restart markers each run, so a
        resumed task's stats stay consistent instead of double-counting
        the bytes that landed before the pause."""
        t_start = time.monotonic()  # lint: disable=R001(wall_seconds stat is real elapsed time by design — model time lives in model_seconds)
        task._idle.clear()
        task.status = TransferTask.ACTIVE
        with task._lock:
            st = task.stats
            st.bytes_total = st.bytes_done = 0
            st.files_total = st.files_done = st.files_failed = 0
        task.files = []
        scope = session_scope or self._own_sessions
        try:
            # all model time this run charges — control exchanges, link
            # transmission, API admission, retry backoff, injected
            # latency — is attributed to this task, across every thread
            # the run fans out into (see clock.charge_to /
            # bind_charge_owner); the tracer binding rides the same
            # thread-local slot so spans attach to this task everywhere
            with charge_to(task.task_id), \
                    self.tracer.bind(task.trace_id
                                     or f"trace-{task.task_id}",
                                     task.task_id), \
                    ExitStack() as stack:
                # third-party coordination / endpoint activation (§5.4)
                with self.tracer.span("startup", "startup"):
                    self.clock.sleep(opt.startup_cost)
                with self.tracer.span("session-acquire", "session"):
                    s_src, s_dst = stack.enter_context(scope(src, dst))
                self._execute(task, src, dst, s_src, s_dst, opt)
        except Exception as e:
            task.log(f"FATAL {type(e).__name__}: {e}")
            task.stats.wall_seconds += time.monotonic() - t_start  # lint: disable=R001(wall_seconds stat is real elapsed time by design)
            task._finish(TransferTask.FAILED)
            return
        task.stats.wall_seconds += time.monotonic() - t_start  # lint: disable=R001(wall_seconds stat is real elapsed time by design)
        if task._cancel_req.is_set():
            self.markers.clear(task.task_id)
            task.log("cancelled")
            task._finish(TransferTask.CANCELLED)
            return
        if task._pause_req.is_set():
            incomplete = (task.stats.files_done + task.stats.files_failed
                          < task.stats.files_total)
            if incomplete:
                # checkpointed through MarkerStore by the interrupt path;
                # not done — the manager re-dispatches on resume
                task.log("paused")
                task.status = TransferTask.PAUSED
                task._idle.set()
                return
            # the pause lost the race with completion: nothing to resume
            task._pause_req.clear()
        ok = task.stats.files_failed == 0
        if ok:
            self.markers.clear(task.task_id)
        task._finish(TransferTask.SUCCEEDED if ok else TransferTask.FAILED)

    def _expand(self, src: Endpoint, dst: Endpoint, s_src: Session):
        """Directory expansion + per-file (src, dst, size, mtime) plan
        (§2.2).  The mtime rides along so resumes can detect a source
        that changed under journaled progress."""
        root = src.path
        info = src.connector.stat(s_src, root)
        plan = []
        if info.is_dir:
            for fi in iter_files(src.connector, s_src, root):
                rel = fi.name[len(root):].lstrip("/") if fi.name.startswith(root) \
                    else os.path.basename(fi.name)
                dpath = dst.path.rstrip("/") + "/" + rel
                plan.append((fi.name, dpath, fi.size, fi.mtime))
        else:
            dpath = dst.path
            if dpath.endswith("/"):
                dpath += os.path.basename(root)
            plan.append((root, dpath, info.size, info.mtime))
        return plan

    def _guard_src_sig(self, task: TransferTask, fstate: dict, sp: str,
                       size: int, mtime: float, st: dict | None) -> dict:
        """Journaled partial progress (hole maps, per-range digests) is
        only trustworthy while the source file is the one it was
        computed from.  Stamp a (size, mtime) signature into the marker
        state and, when a resume finds it changed, discard the traveled
        progress so the file is re-sent whole — the §7 source re-read
        this fold replaced would have caught the swap, so the fold must
        too.  Files already marked complete keep the usual semantics (a
        source modified after its transfer is staleness, not
        corruption)."""
        sig = [size, round(float(mtime), 6)]
        if st is None:
            st = fstate.setdefault(sp, {"done": [], "complete": False})
        if not st.get("complete") \
                and st.get("src_sig") is not None and st["src_sig"] != sig \
                and (st.get("done") or st.get("digests")):
            task.log(f"source changed under {sp}; discarding resume state")
            st["done"] = []
            st.pop("checksum", None)
            st.pop("digests", None)
            self.markers.append(task.task_id, sp,
                                {"done": [], "complete": False,
                                 "reset_digests": True, "src_sig": sig})
        st["src_sig"] = sig
        return st

    def _execute(self, task: TransferTask, src: Endpoint, dst: Endpoint,
                 s_src: Session, s_dst: Session, opt: TransferOptions) -> None:
        plan = self._expand(src, dst, s_src)
        state = self.markers.load(task.task_id)
        fstate = state["files"]
        task.stats.files_total = len(plan)
        task.stats.bytes_total = sum(sz for _, _, sz, _ in plan)
        link = self._link_factory(src.connector, dst.connector)

        pending: list[tuple[str, str, int]] = []
        for sp, dp, sz, mtime in plan:
            st = fstate.get(sp)
            if opt.integrity:
                # the expansion already statted every file: zero-cost
                # spot to invalidate resume state for changed sources
                st = self._guard_src_sig(task, fstate, sp, sz, mtime, st)
            if st and st.get("complete"):
                task.stats.files_done += 1
                done_bytes = sz
                task.stats.bytes_done += done_bytes
                task.files.append(FileResult(sp, dp, sz, ok=True,
                                             checksum=st.get("checksum")))
                continue
            if st:
                task.stats.bytes_done += sum(ln for _, ln in st.get("done", []))
            pending.append((sp, dp, sz))

        # replica-aware routing: a file with a fresh catalog entry at
        # the destination endpoint is kept on the per-file path (where
        # the replica read lives) even when it is batch-sized — a bulk
        # source exchange would move exactly the bytes the catalog says
        # need not move.  peek(), not lookup(): routing is not serving.
        cat_hits: set[str] = set()
        if self.catalog is not None and opt.integrity:
            src_id, dst_id = src.resolved_id(), dst.resolved_id()
            for sp, dp, sz in pending:
                stp = fstate.get(sp) or {}
                if sz > 0 and not stp.get("done") \
                        and stp.get("src_sig") is not None \
                        and self.catalog.peek(src_id, sp, stp["src_sig"],
                                              dst_id) is not None:
                    cat_hits.add(sp)

        # coalesce the small-file tail into pipelined batches (§5.3.2);
        # a lone small file gains nothing from the bulk path
        small: list[tuple[str, str, int]] = []
        large: list[tuple[str, str, int]] = []
        for item in pending:
            if item[0] in cat_hits:
                large.append(item)
            elif opt.coalesce_threshold and item[2] < opt.coalesce_threshold:
                small.append(item)
            else:
                large.append(item)
        if len(small) < 2:
            large = pending
            small = []
        work: deque = deque()
        for i in range(0, len(small), max(1, opt.max_batch_files)):
            work.append(("batch", small[i:i + max(1, opt.max_batch_files)]))
        for item in large:
            work.append(("file", item))

        qlock = threading.Lock()
        active = [0]
        stop = threading.Event()

        def next_item():
            if task.interrupted():
                return None  # pause/cancel: stop claiming work items
            with qlock:
                if not work:
                    return None
                return work.popleft()

        def worker(worker_idx: int) -> None:
            while not stop.is_set():
                if opt.auto_tune and worker_idx >= task_target[0]:
                    with qlock:
                        drained = not work
                    # nothing left to ramp into — or a pause/cancel froze
                    # the queue, which would otherwise spin this worker
                    # (and wedge the join) forever
                    if drained or task.interrupted():
                        return
                    time.sleep(0.002)  # lint: disable=R001(ramped-down worker parks on real time — charging the model clock would bill idle workers to the task)
                    continue
                item = next_item()
                if item is None:
                    return
                with qlock:
                    active[0] += 1
                try:
                    if item[0] == "file":
                        self._transfer_file(task, src, dst, s_src, s_dst, opt,
                                            link, fstate, state, *item[1])
                    else:
                        self._transfer_batch(task, src, dst, s_src, s_dst, opt,
                                             link, fstate, state, item[1])
                finally:
                    with qlock:
                        active[0] -= 1

        n_workers = opt.max_concurrency if opt.auto_tune else opt.concurrency
        n_workers = max(1, min(n_workers, max(1, len(work))))
        task_target = [opt.concurrency]
        tuner = None
        if opt.auto_tune:
            tuner = threading.Thread(  # lint: disable=R002(the tuner only reads stats and never touches the clock — binding would misattribute nothing, there is nothing to charge)
                target=self._tune, args=(task, task_target, opt, stop), daemon=True)
            tuner.start()
        # per-task worker threads inherit the run's charge owner
        threads = [threading.Thread(target=bind_charge_owner(worker),
                                    args=(i,), daemon=True)
                   for i in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop.set()
        if tuner is not None:
            tuner.join(timeout=1.0)
        task.stats.effective_concurrency = float(task_target[0])

    #: model seconds of task progress between controller evaluations
    TUNE_WINDOW = 0.15

    def _tune(self, task: TransferTask, target: list[int],
              opt: TransferOptions, stop: threading.Event) -> None:
        """§8 best practice automated: raise concurrency while marginal
        throughput gain is positive ('we increased concurrency until we
        see negative benefit').

        Evaluations are paced by the task's own model-time progress, not
        a wall-clock period: a fixed wall settle starves the controller
        on fast machines (sleep-debt batching compresses the whole
        transfer under one settle) and over-polls on slow ones.  The
        gain signal itself is wall-clock rate when the clock has a
        positive scale — overlapped real sleeps are what concurrency
        improves under the scaled clock — and model rate in pure
        accounting mode, where virtual time sums across streams.
        """
        best_rate = 0.0
        last_t = 0.0
        last_b = 0
        last_w = time.monotonic()  # lint: disable=R001(tuner gain signal is wall rate under a scaled clock by design — see docstring)
        while not stop.wait(0.002):
            with task._lock:
                if not task._rate_samples:
                    continue
                t, b = task._rate_samples[-1]
            if t - last_t < self.TUNE_WINDOW:
                continue
            now_w = time.monotonic()  # lint: disable=R001(tuner gain signal is wall rate under a scaled clock by design — see docstring)
            dt = (now_w - last_w) if self.clock.scale > 0 else (t - last_t)
            rate = (b - last_b) / max(dt, 1e-9)
            last_t, last_b, last_w = t, b, now_w
            if rate > best_rate * 1.05 and target[0] < opt.max_concurrency:
                best_rate = max(best_rate, rate)
                target[0] = min(opt.max_concurrency, target[0] * 2)
                task.log(f"auto-tune: concurrency -> {target[0]}")
            elif rate < best_rate * 0.7 and target[0] > 1:
                target[0] = max(1, target[0] // 2)
                task.log(f"auto-tune: backing off -> {target[0]}")

    # ---- a coalesced batch of small files ----------------------------------
    def _transfer_batch(self, task: TransferTask, src: Endpoint, dst: Endpoint,
                        s_src: Session, s_dst: Session, opt: TransferOptions,
                        link: Link, fstate: dict, state: dict,
                        files: list[tuple[str, str, int]]) -> None:
        """Move a batch of small files through ONE pipelined control
        exchange and one ``_FilePipe`` pool via the Connector bulk API.
        Per-file failures are contained: the failed file falls back to
        the per-file retry path; its batch-mates are unaffected."""
        if self.health is not None:
            denied = self.health.denied(src.resolved_id(), dst.resolved_id())
            if denied:
                # a breaker on either end is open: don't launch a bulk
                # exchange that would fail wholesale — route every file
                # through the per-file path, whose admit() gate holds
                # each attempt to the breaker/budget discipline
                task.log(f"batch: breaker open on {', '.join(denied)}; "
                         f"routing {len(files)} file(s) per-file")
                for sp, dp, size in files:
                    task._note_batch_fallback()
                    self._transfer_file(task, src, dst, s_src, s_dst, opt,
                                        link, fstate, state, sp, dp, size)
                return
        # one pipelined control-channel exchange for the whole batch
        with self.tracer.span("batch-pipeline", "overhead",
                              files=len(files)):
            self.clock.sleep(opt.file_pipeline_cost)
        alg = opt.checksum_algorithm if opt.integrity else None

        entries: list[_BatchEntry] = []
        fallback: list[tuple[str, str, int]] = []
        for sp, dp, size in files:
            st = fstate.setdefault(sp, {"done": [], "complete": False})
            holes = _holes(size, st.get("done", []))
            if not holes and size > 0:
                # bytes already present from a prior run; only the
                # finalize/verify step remains -> per-file path
                fallback.append((sp, dp, size))
                continue
            entries.append(_BatchEntry(sp, dp, size, st, holes))

        for e in entries:
            def on_written(offset: int, length: int, e: _BatchEntry = e) -> None:
                task._bytes_tick(length)
                flush = False
                with e.lock:
                    e.tracker.add(offset, length)
                    if (offset // (16 * MB)) != ((offset + length) // (16 * MB)):
                        e.st["done"] = e.tracker.ranges()
                        flush = True
                if flush:  # opportunistic journal record, not per block
                    self.markers.append(task.task_id, e.spath,
                                        {"done": e.st["done"]})

            if alg and e.size > 0:
                e.digester = RangeDigester.for_holes(e.holes, alg,
                                                     opt.digest_segment)
            # whole-file fold only where it can complete (full
            # single-run entry); resumed entries rely on the digesters
            e.pipe = _FilePipe(e.size, e.holes, link, opt, on_written,
                               alg if e.full else None,
                               single_consumer=True,
                               abort=task.interrupt_exc,
                               digester=e.digester)

        if entries:
            by_src = {e.spath: e for e in entries}
            by_dst = {e.dpath: e for e in entries}

            def send_factory(path: str):
                e = by_src.get(path)
                return e.pipe.send_channel if e is not None else None

            def recv_factory(path: str):
                e = by_dst.get(path)
                return e.pipe.recv_channel if e is not None else None

            def do_send() -> None:
                try:
                    with self.tracer.span("batch-send", "wire",
                                          files=len(entries)):
                        src.connector.send_batch(
                            s_src, [e.spath for e in entries], send_factory)
                except Exception as exc:  # batch-level failure
                    for e in entries:
                        e.pipe.fail(exc)

            sender = threading.Thread(target=bind_charge_owner(do_send),
                                      daemon=True)
            sender.start()
            try:
                with self.tracer.span("batch-recv", "wire",
                                      files=len(entries)):
                    dst.connector.recv_batch(
                        s_dst, [e.dpath for e in entries], recv_factory)
            except Exception as exc:  # batch-level failure
                for e in entries:
                    e.pipe.fail(exc)
            sender.join()

        # one batch-level exception fails every pipe with the SAME error
        # object; count it once, not once per entry, so faults_retried
        # stays 1:1 with the faults that actually occurred
        counted_errs: set[int] = set()
        for e in entries:
            e.st["done"] = e.tracker.ranges()
            self._fold_digests(e.st, e.prior_done, e.tracker, e.digester,
                               e.size)
            err = e.pipe._error
            complete = e.size == 0 or e.tracker.covered >= e.size
            if isinstance(err, TaskInterrupted):
                # pause/cancel reached this file mid-stream: checkpoint
                # the partial ranges (and their digests) and leave it
                # pending (neither done nor failed) for the resume
                self.markers.append(task.task_id, e.spath,
                                    self._checkpoint_record(e.st))
                continue
            if err is not None or not complete:
                if isinstance(err, TransientError) \
                        and id(err) not in counted_errs:
                    counted_errs.add(id(err))
                    task._note_fault(err)
                    if self.health is not None:
                        # ticket-free outcome report: the batch path has
                        # no per-attempt admit(), but its faults must
                        # still feed the endpoint EWMAs
                        self.health.record_failure(src.resolved_id(),
                                                   dst.resolved_id(),
                                                   error=err)
                task._note_batch_fallback()
                task.log(f"batch: {e.spath} fell back to per-file path "
                         f"({type(err).__name__ if err else 'incomplete'})")
                fallback.append((e.spath, e.dpath, e.size))
                continue
            try:
                checksum = e.pipe.source_checksum()
                if opt.integrity and not e.full:
                    # resumed/holey file: the streaming hash missed the
                    # prior bytes — fold the journaled digests (§7
                    # semantics without a source re-read), else recompute
                    checksum = self._source_checksum_resumed(
                        src, s_src, opt, e.st, e.spath, e.size)
                if opt.integrity and self._should_verify(e.spath, opt):
                    if not self._verify(dst, s_dst, e.dpath, checksum, opt,
                                        digests=e.st.get("digests")):
                        task.stats.integrity_failures += 1
                        task.log(f"integrity mismatch on {e.dpath}; re-sending")
                        # un-credit the bytes being thrown away, then full
                        # per-file re-send with its own integrity budget
                        task._bytes_tick(-e.tracker.covered)
                        e.st["done"] = []
                        e.st["complete"] = False
                        e.st.pop("digests", None)
                        self.markers.append(task.task_id, e.spath,
                                            {"done": [],
                                             "reset_digests": True})
                        task._note_batch_fallback()
                        fallback.append((e.spath, e.dpath, e.size))
                        continue
                e.st["complete"] = True
                e.st["checksum"] = checksum
                self.markers.append(task.task_id, e.spath,
                                    {"done": e.st["done"], "complete": True,
                                     "checksum": checksum})
                self._publish_replica(src, dst, e.st, e.spath, e.dpath,
                                      e.size, checksum)
            except Exception as exc:
                # no finalize error may escape the worker thread (that
                # would silently drop the remaining work items) — the
                # per-file path classifies and records it instead
                if isinstance(exc, TransientError):
                    task._note_fault(exc)
                task._note_batch_fallback()
                task.log(f"batch: finalize error on {e.dpath} "
                         f"({type(exc).__name__}); per-file fallback")
                e.st["complete"] = False
                fallback.append((e.spath, e.dpath, e.size))
                continue
            task.stats.files_done += 1
            task.files.append(FileResult(e.spath, e.dpath, e.size, attempts=1,
                                         checksum=checksum, ok=True))
            if self.health is not None:
                self.health.record_success(src.resolved_id(),
                                           dst.resolved_id())

        for sp, dp, size in fallback:
            self._transfer_file(task, src, dst, s_src, s_dst, opt,
                                link, fstate, state, sp, dp, size)

    # ---- one file ----------------------------------------------------------
    def _transfer_file(self, task: TransferTask, src: Endpoint, dst: Endpoint,
                      s_src: Session, s_dst: Session, opt: TransferOptions,
                      link: Link, fstate: dict, state: dict,
                      spath: str, dpath: str, size: int) -> None:
        result = FileResult(spath, dpath, size)
        st = fstate.setdefault(spath, {"done": [], "complete": False})
        if self.catalog is not None and opt.integrity:
            try:
                if self._try_replica(task, src, dst, s_dst, opt, st,
                                     spath, dpath, size):
                    return
            except TaskInterrupted:
                # pause/cancel mid-replica-read: _try_replica already
                # discarded the unverified partial bytes, so the
                # checkpoint is clean and the resume re-decides
                self.markers.append(task.task_id, spath,
                                    self._checkpoint_record(st))
                return
        attempts = 0
        integrity_budget = opt.max_integrity_retries
        health = self.health
        ep_ids = (src.resolved_id(), dst.resolved_id())
        #: endpoint(s) the previous failure was attributed to — whose
        #: shared retry budget the next attempt must charge
        blame: tuple[str, ...] | None = None
        #: model-clock deadline bounding a run of consecutive fast-fail
        #: denials; ``attempts`` counts only admitted endpoint attempts.
        #: ``last_progress`` tracks the health registry's transition
        #: count so the deadline restarts while breakers keep cycling.
        patience_until: float | None = None
        last_progress = -1
        while True:
            if task.interrupted():
                # pause/cancel between attempts: checkpoint progress and
                # leave the file pending for the resume
                self.markers.append(task.task_id, spath,
                                    self._checkpoint_record(st))
                return
            ticket = None
            try:
                try:
                    if health is not None:
                        # circuit breakers + shared retry budget gate the
                        # attempt BEFORE any storage op: an open breaker
                        # or a dry budget denies here (a fast-fail
                        # EndpointUnavailable) instead of letting the
                        # fleet keep hammering a sick endpoint
                        ticket = health.admit(*ep_ids,
                                              retrying=attempts > 0,
                                              blame=blame)
                        if ticket.probe:
                            task._note_probe()
                    attempts += 1
                    result.attempts = attempts
                    patience_until = None
                    # pipelined per-file command exchange on the control channel
                    with self.tracer.span("pipeline", "overhead",
                                          path=spath, attempt=attempts):
                        self.clock.sleep(opt.file_pipeline_cost)
                    checksum = self._move_one(task, src, dst, s_src, s_dst,
                                              opt, link, st, spath, dpath,
                                              size)
                    if opt.integrity and self._should_verify(spath, opt):
                        ok = self._verify(dst, s_dst, dpath, checksum, opt,
                                          digests=st.get("digests"))
                        if not ok:
                            task.stats.integrity_failures += 1
                            task.log(f"integrity mismatch on {dpath}; "
                                     f"re-sending")
                            # un-credit previously-ticked bytes so bytes_done
                            # can't exceed bytes_total after the re-send
                            task._bytes_tick(
                                -sum(ln for _, ln in st.get("done", [])))
                            st["done"] = []  # full re-send
                            st["complete"] = False
                            # the thrown-away bytes' digests must not let a
                            # later resume skip re-sending them — reset the
                            # journaled map, not just the in-memory one
                            st.pop("digests", None)
                            self.markers.append(task.task_id, spath,
                                                {"done": [],
                                                 "reset_digests": True})
                            if integrity_budget <= 0:
                                raise IntegrityError(dpath)
                            integrity_budget -= 1
                            continue
                    if health is not None:
                        health.settle(ticket)  # success -> endpoint EWMAs
                    result.checksum = checksum
                    result.ok = True
                    st["complete"] = True
                    st["checksum"] = checksum
                    self.markers.append(task.task_id, spath,
                                        {"done": st["done"], "complete": True,
                                         "checksum": checksum})
                    self._publish_replica(src, dst, st, spath, dpath, size,
                                          checksum)
                    task.stats.files_done += 1
                    task.files.append(result)
                    return
                finally:
                    if health is not None:
                        # backstop for attempts exiting unsettled
                        # (interrupt, permanent error, integrity
                        # re-send): free any probe slot without judging
                        # the outcome, so the breaker can probe again
                        health.release(ticket)
            except TaskInterrupted:
                # mid-stream pause/cancel: _move_one already folded the
                # landed ranges (and their segment digests) into ``st``
                # — checkpoint and leave the file pending
                self.markers.append(task.task_id, spath,
                                    self._checkpoint_record(st))
                return
            except TransientError as e:
                if health is not None:
                    health.settle(ticket, e)  # failure -> blamed breaker
                task._note_fault(e)
                if isinstance(e, EndpointUnavailable):
                    # fast-fail: no storage op happened, so the denial
                    # does not burn an attempt out of ``max_retries``.
                    # At REPRO_TIME_SCALE=0 model sleeps are free in
                    # real time, so a count-based bound here would race
                    # the probe thread's scheduling; instead bound the
                    # consecutive-denial wait on the model clock — and
                    # restart it whenever the health registry records a
                    # breaker transition (probes cycling = recovery in
                    # progress; a dead endpoint with a dry budget goes
                    # quiet and lets the deadline expire).
                    now = self.clock.virtual_elapsed
                    progress = (len(health.transitions)
                                if health is not None else -1)
                    if patience_until is None or progress != last_progress:
                        last_progress = progress
                        patience_until = now + opt.unavailable_patience
                    if now >= patience_until:
                        result.error = f"endpoint unavailable: {e}"
                        break
                    # wait out the breaker/budget hint, never
                    # exponential backoff (and keep the previous blame:
                    # the denial is a symptom of the already-blamed
                    # endpoint).  Yield the GIL for real: at time
                    # scale 0 the model sleep below is free, and a
                    # crowd of denied waiters would otherwise starve
                    # the one thread holding the half-open probe slot.
                    time.sleep(0)  # lint: disable=R001(zero-second GIL yield — no time passes on any clock, wall or model)
                    backoff = getattr(e, "retry_after", 0.0)
                elif attempts > opt.max_retries:
                    result.error = f"retries exhausted: {e}"
                    break
                else:
                    ep = getattr(e, "endpoint_id", "")
                    blame = (ep,) if ep in ep_ids else None
                    # deterministic de-synchronization: hash-seeded
                    # jitter spreads same-fault batch-mates across
                    # [0.5x, 1.5x) of the exponential term, so retries
                    # don't re-converge on the endpoint in lockstep
                    jitter = 0.5 + _retry_jitter(task.task_id, spath,
                                                 attempts)
                    backoff = max(getattr(e, "retry_after", 0.0),
                                  opt.retry_backoff * (2 ** (attempts - 1))
                                  * jitter)
                task.log(f"transient fault on {spath} "
                         f"({type(e).__name__}); retry in {backoff:.2f}s")
                with self.tracer.span("backoff", "backoff", path=spath,
                                      attempt=attempts,
                                      kind=type(e).__name__):
                    self.clock.sleep(backoff)
            except IntegrityError as e:
                result.error = f"integrity retries exhausted: {e}"
                break
            except Exception as e:
                result.error = f"{type(e).__name__}: {e}"
                break
        task.stats.files_failed += 1
        task.files.append(result)
        task.log(f"FAILED {spath}: {result.error}")

    # ---- replica catalog (content-addressed dedupe) ------------------------
    def _publish_replica(self, src: Endpoint, dst: Endpoint, st: dict,
                         spath: str, dpath: str, size: int,
                         checksum: str | None) -> None:
        """Index a durably-committed file in the replica catalog.  The
        §7 fold already produced the content address (``checksum``) and
        the expansion stat stamped the source signature — publishing is
        a dict insert, nearly free on the hot path."""
        if self.catalog is None or not checksum or size <= 0:
            return
        sig = st.get("src_sig")
        if sig is None:
            return  # integrity off: no signature to validate against
        digests = st.get("digests") \
            if checksum.startswith(COMPOSITE_PREFIX) else None
        self.catalog.publish(content=checksum, size=size, src_sig=sig,
                             src_endpoint=src.resolved_id(), src_path=spath,
                             endpoint_id=dst.resolved_id(), path=dpath,
                             digests=digests)

    def _try_replica(self, task: TransferTask, src: Endpoint, dst: Endpoint,
                     s_dst: Session, opt: TransferOptions, st: dict,
                     spath: str, dpath: str, size: int) -> bool:
        """Satisfy one file from a fresh near-destination replica: a
        local (dst-endpoint) read of the cataloged copy instead of a
        source read, with the §7 fold re-verifying the streamed bytes
        against the entry's content address AND the usual re-read
        verification at the destination.  Returns True when the file
        was completed this way; any validation failure invalidates the
        entry, discards the unverified bytes, and returns False so the
        normal transfer path moves the real bytes — a bad replica costs
        a wasted local read, never a wrong byte."""
        sig = st.get("src_sig")
        if sig is None or size <= 0 or st.get("complete") or st.get("done"):
            return False
        entry = self.catalog.lookup(src.resolved_id(), spath, sig,
                                    dst.resolved_id())
        if entry is None or entry.size != size:
            return False
        tracker = IntervalTracker()
        try:
            if entry.path == dpath:
                # the destination already holds the bytes (an identical
                # resubmission): verify in place, move nothing
                if not self._verify(dst, s_dst, dpath, entry.content, opt,
                                    digests=entry.digests or None):
                    raise IntegrityError(dpath)
                task._bytes_tick(size)  # accounted done, nothing moved
            else:
                self._replica_stream(task, dst, s_dst, opt, entry, dpath,
                                     size, tracker)
                if self._should_verify(spath, opt) \
                        and not self._verify(dst, s_dst, dpath, entry.content,
                                             opt,
                                             digests=entry.digests or None):
                    raise IntegrityError(dpath)
        except TaskInterrupted:
            # discard the unverified partial bytes before the caller
            # checkpoints: a resume must re-send (or re-replicate) them
            task._bytes_tick(-tracker.covered)
            st["done"] = []
            st.pop("digests", None)
            raise
        except Exception as exc:
            self.catalog.invalidate(entry)
            task._note_replica_fallback()
            task._bytes_tick(-tracker.covered)
            st["done"] = []
            st.pop("digests", None)
            self.markers.append(task.task_id, spath,
                                {"done": [], "reset_digests": True})
            task.log(f"replica read of {entry.path} for {dpath} failed "
                     f"({type(exc).__name__}); falling back to transfer")
            return False
        st["done"] = [[0, size]]
        st["complete"] = True
        st["checksum"] = entry.content
        self.markers.append(task.task_id, spath,
                            {"done": st["done"], "complete": True,
                             "checksum": entry.content})
        task._note_replica(size)
        task.stats.files_done += 1
        task.files.append(FileResult(spath, dpath, size, attempts=1,
                                     checksum=entry.content, ok=True))
        task.log(f"replica hit: {dpath} served from {entry.path} "
                 f"({size} bytes not moved from source)")
        # the new copy is itself a replica — index it so the next
        # fan-out member can read whichever copy is least-recently-used
        self.catalog.publish(content=entry.content, size=size, src_sig=sig,
                             src_endpoint=src.resolved_id(), src_path=spath,
                             endpoint_id=dst.resolved_id(), path=dpath,
                             digests=entry.digests or None)
        return True

    def _replica_stream(self, task: TransferTask, dst: Endpoint,
                        s_dst: Session, opt: TransferOptions, entry,
                        dpath: str, size: int,
                        tracker: IntervalTracker) -> None:
        """Stream ``entry.path`` -> ``dpath`` within the destination
        endpoint (loopback data channel) and fold the bytes read; a
        fold that does not reproduce ``entry.content`` exactly raises.
        A composite content address is re-folded over the entry's own
        segment boundaries; a plain one through the whole-file hash."""
        link = self._link_factory(dst.connector, dst.connector)
        composite = entry.content.startswith(COMPOSITE_PREFIX)
        digester = None
        if composite:
            segs = sorted((_key_range(k) for k in entry.digests),
                          key=lambda r: r[0])
            digester = RangeDigester([ByteRange(o, ln) for o, ln in segs],
                                     opt.checksum_algorithm)

        def on_written(offset: int, length: int) -> None:
            task._bytes_tick(length)
            tracker.add(offset, length)

        pipe = _FilePipe(size, [ByteRange(0, size)], link, opt, on_written,
                         None if composite else opt.checksum_algorithm,
                         abort=task.interrupt_exc, digester=digester)
        send_err: list[Exception] = []

        def do_send() -> None:
            try:
                with self.tracer.span("replica-read", "replica",
                                      path=entry.path):
                    dst.connector.send(s_dst, entry.path, pipe.send_channel)
            except Exception as e:
                send_err.append(e)
                pipe.fail(e)

        sender = threading.Thread(target=bind_charge_owner(do_send),
                                  daemon=True)
        sender.start()
        recv_err: Exception | None = None
        try:
            with self.tracer.span("replica-write", "replica", path=dpath):
                dst.connector.recv(s_dst, dpath, pipe.recv_channel)
        except Exception as e:
            recv_err = e
        sender.join()
        if send_err:
            raise send_err[0]
        if recv_err is not None:
            raise recv_err
        if tracker.covered < size:
            raise TruncatedStream(
                f"replica {entry.path}: {tracker.covered} of {size} bytes")
        if composite:
            streamed = compose_digests(digester.digests, size,
                                       opt.checksum_algorithm)
        else:
            streamed = pipe.source_checksum()
        if streamed != entry.content:
            raise IntegrityError(
                f"replica {entry.path} does not match its content address")

    def _should_verify(self, path: str, opt: TransferOptions) -> bool:
        if opt.verify_sampling >= 1.0:
            return True
        h = int(hashlib.sha1(path.encode()).hexdigest()[:8], 16) / 0xFFFFFFFF
        return h < opt.verify_sampling

    @staticmethod
    def _fold_digests(st: dict, prior_done, tracker: IntervalTracker,
                      digester: RangeDigester | None, size: int) -> None:
        """Harvest this run's durable segment digests into ``st``.  When
        the file is still incomplete (pause / fault / handoff ahead),
        clamp the resumable "done" ranges to digest-backed coverage:
        prior progress plus this run's *digested* segments.  Bytes that
        landed but whose segment digest never finalized are re-sent on
        resume — bounded by one ``digest_segment`` per hole — so the
        composite checksum can always account for every skipped byte."""
        if digester is None:
            return
        fresh = digester.completed(tracker.ranges())
        if fresh:
            st.setdefault("digests", {}).update(fresh)
        if size > 0 and tracker.covered < size:
            st["done"] = _merge_ranges(
                [list(r) for r in prior_done]
                + [[off, ln] for off, ln in
                   (_key_range(k) for k in fresh)])

    @staticmethod
    def _checkpoint_record(st: dict) -> dict:
        """Marker-journal record for an interrupted file: the resumable
        ranges, the per-range digests that back them, and the source
        signature they are only valid against."""
        rec = {"done": st.get("done", [])}
        if st.get("digests"):
            rec["digests"] = st["digests"]
        if st.get("src_sig") is not None:
            rec["src_sig"] = st["src_sig"]
        return rec

    def _source_checksum_resumed(self, src, s_src, opt, st: dict,
                                 spath: str, size: int) -> str:
        """§7 source checksum for a file completed across several runs:
        fold the journaled per-range digests when they tile the file
        (no source re-read); otherwise fall back to re-reading the
        source (pre-digest markers, or a kill that lost the tail)."""
        comp = compose_digests(st.get("digests", {}), size,
                               opt.checksum_algorithm)
        if comp is not None:
            return comp  # pure fold, no storage op — nothing to trace
        with self.tracer.span("source-checksum", "integrity", path=spath):
            return src.connector.checksum(s_src, spath,
                                          opt.checksum_algorithm)

    def _move_one(self, task, src, dst, s_src, s_dst, opt, link,
                  st: dict, spath: str, dpath: str,
                  size: int) -> str | None:
        holes = _holes(size, st.get("done", []))
        if not holes and size > 0:
            checksum = st.get("checksum")
            if checksum is None and opt.integrity:
                # bytes are all present but never checksummed (e.g. a
                # verify step that errored out mid-task, or a handoff
                # that landed between streaming and verification):
                # fold the traveled digests, else recompute — or
                # _verify(None) would silently skip verification
                checksum = self._source_checksum_resumed(
                    src, s_src, opt, st, spath, size)
            return checksum
        if size == 0:
            holes = []

        prior_done = [list(r) for r in st.get("done", [])]
        full = len(holes) == 1 and holes[0].offset == 0 \
            and holes[0].length == size
        digester = None
        if opt.integrity and size > 0:
            # segment digests guard against interruption; the classic
            # whole-file fold below is only fed on a full single-run
            # transfer (a holey resume could never complete it anyway).
            # A full run that finishes uninterrupted does hash twice —
            # deliberate: its recorded checksum stays a plain whole-file
            # digest, comparable to server-side checksums and to the
            # paper's §7 semantics, while the segment digests are the
            # insurance premium against a pause/handoff mid-run
            digester = RangeDigester.for_holes(
                holes, opt.checksum_algorithm, opt.digest_segment)
        tracker = IntervalTracker(st.get("done", []))
        marker_lock = threading.Lock()

        def on_written(offset: int, length: int) -> None:
            task._bytes_tick(length)
            flush = False
            with marker_lock:
                tracker.add(offset, length)
                if (offset // (16 * MB)) != ((offset + length) // (16 * MB)):
                    st["done"] = tracker.ranges()
                    flush = True
            # restart markers are journaled opportunistically (not per
            # block, and never as a whole-state rewrite)
            if flush:
                self.markers.append(task.task_id, spath, {"done": st["done"]})

        pipe = _FilePipe(size, holes, link, opt, on_written,
                         opt.checksum_algorithm
                         if opt.integrity and full else None,
                         abort=task.interrupt_exc, digester=digester)

        send_err: list[Exception] = []

        def do_send() -> None:
            try:
                # the sender thread pays link transmission (pipe.push):
                # the wire span lives here, bound to this task's trace
                # through bind_charge_owner
                with self.tracer.span("send", "wire", path=spath):
                    src.connector.send(s_src, spath, pipe.send_channel)
            except Exception as e:
                send_err.append(e)
                pipe.fail(e)

        sender = threading.Thread(target=bind_charge_owner(do_send),
                                  daemon=True)
        sender.start()
        recv_err: Exception | None = None
        try:
            with self.tracer.span("recv", "wire", path=dpath):
                dst.connector.recv(s_dst, dpath, pipe.recv_channel)
        except Exception as e:
            recv_err = e
        sender.join()
        st["done"] = tracker.ranges()
        self._fold_digests(st, prior_done, tracker, digester, size)
        if send_err:
            # health-plane attribution: a read-side fault is the source
            # endpoint's to answer for (unless the connector already
            # stamped a culprit)
            _blame_endpoint(send_err[0], src.resolved_id())
            raise send_err[0]
        if recv_err is not None:
            _blame_endpoint(recv_err, dst.resolved_id())
            raise recv_err
        if size > 0 and tracker.covered < size:
            # The stream ended short of plan.  Distinguish a source that
            # shrank since expansion (stat now reports no more than what
            # landed: accept what exists) from a cut stream — truncated
            # write, dropped connection — where the source still holds
            # the missing bytes and the hole must be re-claimed.  Only a
            # *permanent* stat failure means the source is gone; a
            # transient one must propagate to the retry loop, or a short
            # file would be silently accepted as complete.
            try:
                now_size = src.connector.stat(s_src, spath).size
            except PermanentError:
                now_size = tracker.covered  # source gone: keep what landed
            if now_size > tracker.covered:
                err = TruncatedStream(
                    f"{dpath}: {tracker.covered} of {size} bytes landed")
                # a cut stream is observed at the write side
                _blame_endpoint(err, dst.resolved_id())
                raise err
        if opt.integrity and not full:
            # resumed/holey transfer: the streaming hash never saw the
            # whole file — fold the journaled per-range digests (§7
            # semantics without a source re-read), else recompute
            return self._source_checksum_resumed(src, s_src, opt, st,
                                                 spath, size)
        return pipe.source_checksum()

    def _verify(self, dst: Endpoint, s_dst: Session, dpath: str,
                src_checksum: str | None, opt: TransferOptions,
                digests: dict | None = None) -> bool:
        """§7 strong integrity: re-read the file at the destination and
        compare checksums.  A composite source checksum (folded from
        per-range digests across resumes/handoffs) is verified by
        folding the destination over the same boundaries — still one
        full dst read, never a source re-read."""
        if src_checksum is None:
            return True
        with self.tracer.span("verify", "integrity", path=dpath):
            if src_checksum.startswith(COMPOSITE_PREFIX):
                return self._verify_composite(dst, s_dst, dpath,
                                              src_checksum, digests or {},
                                              opt)
            dst_sum = dst.connector.checksum(s_dst, dpath,
                                             opt.checksum_algorithm)
            return dst_sum == src_checksum

    def _verify_composite(self, dst: Endpoint, s_dst: Session, dpath: str,
                          src_checksum: str, digests: dict,
                          opt: TransferOptions) -> bool:
        segs = sorted((_key_range(k) for k in digests), key=lambda r: r[0])
        if not segs:
            return False
        size = segs[-1][0] + segs[-1][1]
        if dst.connector.stat(s_dst, dpath).size != size:
            return False  # a plain checksum would catch the length skew
        dig = RangeDigester([ByteRange(off, ln) for off, ln in segs],
                            opt.checksum_algorithm)
        dst.connector.send(s_dst, dpath,
                           _RangedDigestChannel(dig, size, opt.blocksize))
        return compose_digests(dig.digests, size,
                               opt.checksum_algorithm) == src_checksum
