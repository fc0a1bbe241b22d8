"""Deterministic failure-scenario harness for the transfer service.

A copy of ``repro/sim/scenarios.py``: the port imports nothing of ``repro``.

A scenario is ``(source tree, connector route, fault schedule, transfer
options)``.  :class:`ScenarioRunner` materializes the tree at the source,
wraps either end of the route in a
:class:`~repro_torch.connectors.faultproxy.FaultProxyConnector`, runs the
managed :class:`~repro_torch.core.transfer.TransferService`, and verifies the
end-state invariants that make a transfer fabric trustworthy under
chaos:

* the task always *finishes* (never wedges), within a wall-clock bound;
* on success the destination tree is byte-exact, every file result is
  ``ok``, ``bytes_done == bytes_total``, and the restart-marker journal
  is cleared;
* on failure every failed file carries an error, and every file the
  task *did* mark ok is still byte-exact at the destination;
* with an empty schedule no faults are retried (the fabric doesn't
  invent failures).

Determinism: trees are generated from a seeded RNG and schedules make
hash-based decisions (see :mod:`repro_torch.core.faults`), so the same seed
replays the same fault sequence into the same ``TaskStats`` — that is
what makes a chaos failure reproducible enough to debug.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import Callable

from ..catalog import ReplicaCatalog
from ..connectors import (MemoryConnector, ObjectStoreConnector,
                          PosixConnector, make_cloud)
from ..connectors.faultproxy import FaultProxyConnector
from ..core import ConnectorError, Credential
from ..core.clock import Clock, wall_now, wall_sleep
from ..core.faults import FaultSchedule
from ..core.health import EndpointHealth, HealthConfig
from ..core.manager import RouteCandidate, TransferManager
from ..core.transfer import (CredentialStore, Endpoint, TransferOptions,
                             TransferService)
from ..fed import FederatedCoordinator, TransferSpec

KB = 1024
MB = 1024 * 1024

#: every generated tree lives under this source root and lands under "out"
SRC_ROOT = "data"
DST_ROOT = "out"


# --------------------------------------------------------------------------
# canonical source trees
# --------------------------------------------------------------------------
def _tree_many_small(rng: random.Random):
    files = {f"{SRC_ROOT}/sub{i % 4}/f{i:03d}.bin":
             rng.randbytes(rng.randint(1, 8 * KB)) for i in range(24)}
    return files, []


def _tree_few_large(rng: random.Random):
    files = {f"{SRC_ROOT}/big{i}.bin":
             rng.randbytes(rng.randint(1 * MB, 2 * MB + 4097))
             for i in range(3)}
    return files, []


def _tree_mixed(rng: random.Random):
    sizes = [0, 1, 137, 4 * KB, 64 * KB, 300 * KB, 3 * MB // 2]
    files = {}
    for i in range(14):
        d = rng.choice(["", "a/", "a/b/"])
        files[f"{SRC_ROOT}/{d}m{i:02d}.bin"] = rng.randbytes(rng.choice(sizes))
    return files, [f"{SRC_ROOT}/hollow"]


def _tree_deep(rng: random.Random):
    files = {}
    for i in range(8):
        depth = rng.randint(1, 5)
        d = "/".join(f"lvl{j}" for j in range(depth))
        files[f"{SRC_ROOT}/{d}/deep{i}.bin"] = \
            rng.randbytes(rng.randint(1, 16 * KB))
    return files, [f"{SRC_ROOT}/lvl0/empty", f"{SRC_ROOT}/void"]


def _tree_zero_byte(rng: random.Random):
    files = {f"{SRC_ROOT}/z{i}.bin": b"" for i in range(4)}
    files.update({f"{SRC_ROOT}/s{i}.bin":
                  rng.randbytes(rng.randint(1, 2 * KB)) for i in range(4)})
    return files, []


def _tree_unicode(rng: random.Random):
    names = [f"{SRC_ROOT}/ünïcødé/файл-1.bin",
             f"{SRC_ROOT}/数据/ファイル 2.bin",
             f"{SRC_ROOT}/emoji-✨/naïve 3.bin",
             f"{SRC_ROOT}/ünïcødé/plain.bin"]
    return {n: rng.randbytes(rng.randint(1, 8 * KB)) for n in names}, []


TREES: dict[str, Callable] = {
    "many-small": _tree_many_small,
    "few-large": _tree_few_large,
    "mixed": _tree_mixed,
    "deep": _tree_deep,
    "zero-byte": _tree_zero_byte,
    "unicode": _tree_unicode,
}

#: connector routes; "cloud" is the emulated object store behind the
#: Connector (paper §4) — posix / memory / conn coverage
ROUTES = ("posix->memory", "memory->posix", "posix->cloud",
          "cloud->memory", "cloud->cloud", "posix->posix")


def canonical_tree(kind: str, seed: int = 0):
    """(files, empty_dirs) for one canonical tree, deterministic in
    ``seed``.  ``files`` maps ``data/...`` paths to payload bytes.
    (String seeding is deterministic across processes, unlike hashing a
    tuple under PYTHONHASHSEED randomization.)"""
    return TREES[kind](random.Random(f"{kind}|{seed}"))


# --------------------------------------------------------------------------
# results + invariants
# --------------------------------------------------------------------------
@dataclass
class ScenarioResult:
    task: object
    schedule: FaultSchedule | None
    expected: dict[str, bytes]          # rel path -> bytes
    dest: dict[str, bytes]              # rel path -> bytes (as landed)
    violations: list[str] = field(default_factory=list)
    route: str = ""
    tree: str = ""

    @property
    def ok(self) -> bool:
        return not self.violations

    def fingerprint(self) -> dict:
        """Thread-order-independent digest of the run, for comparing
        same-seed replays (wall time deliberately excluded)."""
        st = self.task.stats
        return {
            "status": self.task.status,
            "files_total": st.files_total,
            "files_done": st.files_done,
            "files_failed": st.files_failed,
            "bytes_total": st.bytes_total,
            "bytes_done": st.bytes_done,
            "faults_retried": st.faults_retried,
            "integrity_failures": st.integrity_failures,
            "batch_fallbacks": st.batch_fallbacks,
            "retries_by_kind": dict(sorted(st.retries_by_kind.items())),
            "events": tuple(self.schedule.sorted_events())
            if self.schedule is not None else (),
        }


def check_invariants(task, expected: dict[str, bytes],
                     dest: dict[str, bytes], schedule: FaultSchedule | None,
                     markers_after: dict, finished: bool,
                     integrity: bool) -> list[str]:
    """End-state invariants every chaos run must satisfy.  Returns a
    list of human-readable violations (empty = all held)."""
    v: list[str] = []
    if not finished:
        v.append("wedged: task did not finish within the timeout")
        return v
    st = task.stats
    if st.files_done + st.files_failed != st.files_total:
        v.append(f"accounting: done {st.files_done} + failed "
                 f"{st.files_failed} != total {st.files_total}")
    if not 0 <= st.bytes_done <= st.bytes_total:
        v.append(f"accounting: bytes_done {st.bytes_done} outside "
                 f"[0, {st.bytes_total}]")
    if schedule is not None and not schedule.rules and st.faults_retried:
        v.append(f"phantom faults: {st.faults_retried} retries with an "
                 f"empty schedule")
    if task.status == task.SUCCEEDED:
        if st.files_failed:
            v.append("succeeded with failed files")
        if st.bytes_done != st.bytes_total:
            v.append(f"succeeded with bytes_done {st.bytes_done} != "
                     f"bytes_total {st.bytes_total}")
        if dest != expected:
            missing = sorted(set(expected) - set(dest))[:3]
            extra = sorted(set(dest) - set(expected))[:3]
            diff = sorted(k for k in set(dest) & set(expected)
                          if dest[k] != expected[k])[:3]
            v.append(f"dest tree not byte-exact (missing={missing} "
                     f"extra={extra} differing={diff})")
        if markers_after != {"files": {}}:
            v.append(f"markers not cleared after success: {markers_after}")
        for fr in task.files:
            if not fr.ok:
                v.append(f"succeeded but file result not ok: {fr.src}")
            elif integrity and fr.checksum is None:
                v.append(f"integrity on but no checksum recorded: {fr.src}")
    else:
        for fr in task.files:
            if not fr.ok and not fr.error:
                v.append(f"failed file without recorded error: {fr.src}")
            if fr.ok:
                rel = fr.dst[len(DST_ROOT) + 1:] if fr.dst.startswith(
                    DST_ROOT + "/") else fr.dst
                if dest.get(rel) != expected.get(rel):
                    v.append(f"file marked ok but not byte-exact: {fr.src}")
    return v


# --------------------------------------------------------------------------
# federation instrumentation
# --------------------------------------------------------------------------
class _MeteredRecvChannel:
    """AppChannel wrapper that reports every byte a connector pulls from
    the application (i.e. bytes about to be written to storage)."""

    def __init__(self, inner, on_read):
        self._inner = inner
        self._on_read = on_read

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def read(self, offset: int, length: int) -> bytes:
        data = self._inner.read(offset, length)
        self._on_read(len(data))
        return data


class _InstrumentedDst:
    """Transparent wrapper around a destination connector that counts
    bytes written to storage per path — the evidence behind the "every
    byte written exactly once, even across a handoff" invariant."""

    def __init__(self, inner):
        self.inner = inner
        self._lock = threading.Lock()
        self.bytes_by_path: dict[str, int] = {}

    def __getattr__(self, item):
        # stat/listdir/send/start/... all forward to the inner connector
        return getattr(self.inner, item)

    def written(self, prefix: str = "") -> int:
        with self._lock:
            return sum(n for p, n in self.bytes_by_path.items()
                       if p.startswith(prefix))

    def _on_read(self, path: str, n: int) -> None:
        with self._lock:
            self.bytes_by_path[path] = self.bytes_by_path.get(path, 0) + n

    def _meter(self, path: str, channel):
        return _MeteredRecvChannel(
            channel, lambda n, p=path: self._on_read(p, n))

    def recv(self, session, path, channel):
        self.inner.recv(session, path, self._meter(path, channel))

    def recv_batch(self, session, paths, channel_factory):
        def factory(path):
            ch = channel_factory(path)
            return None if ch is None else self._meter(path, ch)

        self.inner.recv_batch(session, paths, factory)


class _HeldWriteChannel:
    """Send-side AppChannel wrapper gating each block before it enters
    the pipe."""

    def __init__(self, inner, gate):
        self._inner = inner
        self._gate = gate

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def write(self, offset: int, data: bytes) -> None:
        self._gate(len(data))
        self._inner.write(offset, data)


class _HoldSrc:
    """Wrapper around a *source* connector that, once ``after_bytes``
    cumulative bytes have streamed under the watched prefixes, blocks
    every further send-side block until :meth:`release`.

    This is the deterministic "mid-flight" hook for federation tests:
    blocking on the send side (before the block enters the pipe) means
    the held task still has unclaimed byte ranges when the control
    plane pauses it — the pause lands before release, so the resulting
    checkpoint is guaranteed to carry real partial progress AND real
    holes.  The crossing block itself is let through, so at least
    ``after_bytes`` of durable, marker-checkpointed progress exists to
    travel with a handoff.
    """

    def __init__(self, inner):
        self.inner = inner
        self._lock = threading.Lock()
        self._prefixes: tuple[str, ...] = ()
        self._after = 0
        self._total = 0
        self.engaged = threading.Event()
        self.released = threading.Event()
        self.released.set()

    def __getattr__(self, item):
        return getattr(self.inner, item)

    def arm_hold(self, prefixes, after_bytes: int) -> None:
        self._prefixes = tuple(prefixes)
        self._after = after_bytes
        self._total = 0
        self.engaged.clear()
        self.released.clear()

    def release(self) -> None:
        self.released.set()

    def _gate(self, path: str, n: int) -> None:
        hold = False
        with self._lock:
            if self._after and any(path.startswith(p)
                                   for p in self._prefixes):
                # threshold checked BEFORE adding: the crossing block
                # passes, everything after it blocks
                hold = self._total >= self._after
                self._total += n
        if hold and not self.released.is_set():
            self.engaged.set()
            self.released.wait(timeout=60.0)

    def _held(self, path: str, channel):
        return _HeldWriteChannel(channel,
                                 lambda n, p=path: self._gate(p, n))

    def send(self, session, path, channel):
        self.inner.send(session, path, self._held(path, channel))

    def send_batch(self, session, paths, channel_factory):
        def factory(path):
            ch = channel_factory(path)
            return None if ch is None else self._held(path, ch)

        self.inner.send_batch(session, paths, factory)


class _MeteredSendChannel:
    """Send-side AppChannel wrapper counting every byte a source
    connector pushes into the pipe."""

    def __init__(self, inner, on_write):
        self._inner = inner
        self._on_write = on_write

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def write(self, offset: int, data: bytes) -> None:
        self._on_write(len(data))
        self._inner.write(offset, data)


class _MeteredSrc:
    """Transparent wrapper around a *source* connector that counts
    bytes streamed out per path — the evidence behind the fan-out
    dedupe invariant: N identical submissions must read the source
    ~once, with the other N-1 satisfied by catalog replica reads (which
    stream from the destination connector and so never show up here)."""

    def __init__(self, inner):
        self.inner = inner
        self._lock = threading.Lock()
        self.bytes_by_path: dict[str, int] = {}

    def __getattr__(self, item):
        return getattr(self.inner, item)

    def sent(self, prefix: str = "") -> int:
        with self._lock:
            return sum(n for p, n in self.bytes_by_path.items()
                       if p.startswith(prefix))

    def _on_write(self, path: str, n: int) -> None:
        with self._lock:
            self.bytes_by_path[path] = self.bytes_by_path.get(path, 0) + n

    def _meter(self, path: str, channel):
        return _MeteredSendChannel(
            channel, lambda n, p=path: self._on_write(p, n))

    def send(self, session, path, channel):
        self.inner.send(session, path, self._meter(path, channel))

    def send_batch(self, session, paths, channel_factory):
        def factory(path):
            ch = channel_factory(path)
            return None if ch is None else self._meter(path, ch)

        self.inner.send_batch(session, paths, factory)


class _FlakyDigest:
    """Site-manager proxy whose ``digest()`` raises while ``down`` is
    set — the heartbeat-miss injection for flapping-site scenarios.
    Every other call forwards to the real manager, so the site's data
    plane keeps working while its control channel looks dead (exactly
    the partition the heartbeat monitor must not over-react to)."""

    def __init__(self, inner):
        self.inner = inner
        self.down = threading.Event()

    def __getattr__(self, item):
        return getattr(self.inner, item)

    def digest(self):
        if self.down.is_set():
            raise ConnectorError("site unreachable: digest poll failed")
        return self.inner.digest()


# --------------------------------------------------------------------------
# the runner
# --------------------------------------------------------------------------
class ScenarioRunner:
    """Builds a route, seeds a tree, runs the service under a schedule,
    and checks invariants.  Each ``run`` gets a fresh subdirectory of
    ``base_dir`` (posix roots + restart markers), so runs are isolated
    and a seeded run replays exactly."""

    def __init__(self, base_dir: str, clock: Clock | None = None):
        self.base_dir = base_dir
        self.clock = clock or Clock()
        self._n = 0
        self._lock = threading.Lock()

    # ---- route construction -------------------------------------------
    def _make_end(self, kind: str, run_dir: str, sub: str, provider: str):
        """One side of a route: (connector, seed_fn, read_fn)."""
        if kind == "posix":
            root = os.path.join(run_dir, sub)
            conn = PosixConnector(root)

            def seed(files, empty_dirs):
                for name, payload in files.items():
                    p = os.path.join(root, name)
                    os.makedirs(os.path.dirname(p), exist_ok=True)
                    with open(p, "wb") as f:
                        f.write(payload)
                for d in empty_dirs:
                    os.makedirs(os.path.join(root, d), exist_ok=True)

            def read():
                out = {}
                base = os.path.join(root, DST_ROOT)
                for dirpath, _, filenames in os.walk(base):
                    for fn in filenames:
                        p = os.path.join(dirpath, fn)
                        rel = os.path.relpath(p, base).replace(os.sep, "/")
                        with open(p, "rb") as f:
                            out[rel] = f.read()
                return out

            return conn, seed, read

        if kind == "memory":
            conn = MemoryConnector(clock=self.clock)

            def seed(files, empty_dirs):
                for name, payload in files.items():
                    conn.store.put(name, payload)

            def read():
                pfx = DST_ROOT + "/"
                return {k[len(pfx):]: conn.store.get(k)
                        for k in conn.store.keys() if k.startswith(pfx)}

            return conn, seed, read

        if kind == "cloud":
            storage = make_cloud(provider, clock=self.clock)
            placement = "cloud" if provider == "gcs" else "local"
            conn = ObjectStoreConnector(storage, placement=placement,
                                        clock=self.clock)

            def seed(files, empty_dirs):
                for name, payload in files.items():
                    storage.blobs.put(name, payload)

            def read():
                pfx = DST_ROOT + "/"
                return {k[len(pfx):]: storage.blobs.get(k)
                        for k in storage.blobs.keys() if k.startswith(pfx)}

            return conn, seed, read

        raise ValueError(f"unknown route end {kind!r}")

    # ---- one scenario ---------------------------------------------------
    def run(self, tree="mixed", route: str = "posix->memory",
            schedule: FaultSchedule | None = None,
            options: TransferOptions | None = None, proxy: str = "dst",
            seed: int = 0, timeout: float = 120.0,
            strict: bool = False) -> ScenarioResult:
        """Run one scenario.  ``tree`` is a canonical-tree name or a
        literal ``{data/...: bytes}`` mapping; ``proxy`` picks which
        route end(s) get the fault proxy: "src" | "dst" | "both" |
        "none".  ``strict=True`` raises AssertionError on any invariant
        violation."""
        with self._lock:
            self._n += 1
            run_dir = os.path.join(self.base_dir, f"run{self._n:03d}")
        os.makedirs(run_dir, exist_ok=True)

        if isinstance(tree, str):
            files, empty_dirs = canonical_tree(tree, seed)
        else:
            files, empty_dirs, tree = dict(tree), [], "<literal>"
        src_kind, dst_kind = route.split("->")
        src_conn, seed_src, _ = self._make_end(src_kind, run_dir, "srcfs",
                                               provider="s3")
        dst_conn, _, read_dst = self._make_end(
            dst_kind, run_dir, "dstfs",
            provider="gcs" if src_kind == "cloud" else "s3")
        seed_src(files, empty_dirs)

        if schedule is not None and schedule.clock is None:
            schedule.clock = self.clock
        if schedule is not None and proxy in ("src", "both"):
            src_conn = FaultProxyConnector(src_conn, schedule)
        if schedule is not None and proxy in ("dst", "both"):
            dst_conn = FaultProxyConnector(dst_conn, schedule)

        creds = CredentialStore()
        for ep_id, conn in (("src-ep", src_conn), ("dst-ep", dst_conn)):
            creds.register(ep_id, Credential(
                conn.credential_scheme or "local-user", {"token": "t"}))
        service = TransferService(
            credential_store=creds,
            marker_root=os.path.join(run_dir, "markers"), clock=self.clock)

        options = options or TransferOptions(
            startup_cost=0.0, retry_backoff=0.01, concurrency=2)
        task = service.submit(Endpoint(src_conn, SRC_ROOT, "src-ep"),
                              Endpoint(dst_conn, DST_ROOT, "dst-ep"),
                              options, task_id=f"chaos-{self._n:03d}")
        finished = task.wait(timeout=timeout)

        expected = {name[len(SRC_ROOT) + 1:]: payload
                    for name, payload in files.items()}
        dest = read_dst() if finished else {}
        markers_after = service.markers.load(task.task_id) if finished \
            else {"files": {"unfinished": True}}
        violations = check_invariants(task, expected, dest, schedule,
                                      markers_after, finished,
                                      options.integrity)
        result = ScenarioResult(task=task, schedule=schedule,
                                expected=expected, dest=dest,
                                violations=violations, route=route, tree=tree)
        if strict and violations:
            raise AssertionError(
                f"scenario {tree} over {route} violated invariants:\n  "
                + "\n  ".join(violations)
                + f"\n  last events: {task.events[-5:]}")
        return result

    # ---- a fleet of tasks under one manager ------------------------------
    def run_multi(self, n_tasks: int = 4, tenants=("alice", "bob"),
                  trees=("mixed", "many-small"),
                  route: str = "posix->memory",
                  schedule: FaultSchedule | None = None,
                  options: TransferOptions | None = None,
                  proxy: str = "dst", max_workers: int = 4,
                  per_endpoint_cap: int | None = 2,
                  pause_resume=(), seed: int = 0,
                  timeout: float = 240.0,
                  advisor=None, refit_every: int = 4,
                  strict: bool = False) -> "MultiScenarioResult":
        """Run ``n_tasks`` concurrent transfers through ONE
        :class:`TransferManager` sharing one route's endpoints.

        Task ``i`` belongs to ``tenants[i % len(tenants)]``, moves
        canonical tree ``trees[i % len(trees)]`` seeded from
        ``seed + i`` under ``data/t{i}``, and lands under ``out/t{i}``
        — so per-endpoint caps, tenant fairness, and session sharing
        are all exercised on live shared state.  ``pause_resume`` names
        task indexes to pause (best-effort mid-flight; deterministic
        while queued) and then resume before the final wait.  Per-task
        end-state invariants are checked exactly as in :meth:`run`,
        plus manager-level ones: worker budget and per-endpoint caps
        never exceeded, and the whole fleet finishes.

        With ``advisor`` given, every submission is routed through its
        first route (per-task workload hints from the generated trees)
        and the manager's online refit loop runs every ``refit_every``
        completions.  One more invariant then applies: once at least one
        refit fired, the median prediction error of post-refit tasks
        must be *smaller* than the seed model's — charge-accounted
        observations under multi-tenant chaos traffic must converge the
        model, not corrupt it."""
        with self._lock:
            self._n += 1
            run_dir = os.path.join(self.base_dir, f"multi{self._n:03d}")
        os.makedirs(run_dir, exist_ok=True)

        src_kind, dst_kind = route.split("->")
        src_conn, seed_src, _ = self._make_end(src_kind, run_dir, "srcfs",
                                               provider="s3")
        dst_conn, _, read_dst = self._make_end(
            dst_kind, run_dir, "dstfs",
            provider="gcs" if src_kind == "cloud" else "s3")

        per_task_files: list[dict[str, bytes]] = []
        all_files: dict[str, bytes] = {}
        all_empty: list[str] = []
        for i in range(n_tasks):
            files, empty_dirs = canonical_tree(trees[i % len(trees)],
                                               seed + i)
            remapped = {f"{SRC_ROOT}/t{i}/" + name[len(SRC_ROOT) + 1:]: data
                        for name, data in files.items()}
            per_task_files.append(remapped)
            all_files.update(remapped)
            all_empty.extend(f"{SRC_ROOT}/t{i}/" + d[len(SRC_ROOT) + 1:]
                             for d in empty_dirs)
        seed_src(all_files, all_empty)

        if schedule is not None and schedule.clock is None:
            schedule.clock = self.clock
        if schedule is not None and proxy in ("src", "both"):
            src_conn = FaultProxyConnector(src_conn, schedule)
        if schedule is not None and proxy in ("dst", "both"):
            dst_conn = FaultProxyConnector(dst_conn, schedule)

        creds = CredentialStore()
        for tenant in tenants:
            creds.register(f"src-{tenant}", Credential(
                src_conn.credential_scheme or "local-user",
                {"identity": tenant}))
            creds.register(f"dst-{tenant}", Credential(
                dst_conn.credential_scheme or "local-user",
                {"identity": tenant}))
        manager = TransferManager(
            max_workers=max_workers, per_endpoint_cap=per_endpoint_cap,
            credential_store=creds, advisor=advisor,
            refit_every=refit_every,
            marker_root=os.path.join(run_dir, "markers"), clock=self.clock)

        options = options or TransferOptions(
            startup_cost=0.0, retry_backoff=0.01, concurrency=2)
        tasks = []
        for i in range(n_tasks):
            tenant = tenants[i % len(tenants)]
            src_ep = Endpoint(src_conn, f"{SRC_ROOT}/t{i}", f"src-{tenant}")
            dst_ep = Endpoint(dst_conn, f"{DST_ROOT}/t{i}", f"dst-{tenant}")
            if advisor is not None:
                tasks.append(manager.submit(
                    candidates=[RouteCandidate(advisor.routes[0].name,
                                               src_ep, dst_ep)],
                    options=options, task_id=f"multi-{self._n:03d}-t{i}",
                    n_files=len(per_task_files[i]),
                    nbytes=sum(len(d) for d in per_task_files[i].values())))
            else:
                tasks.append(manager.submit(
                    src_ep, dst_ep, options,
                    task_id=f"multi-{self._n:03d}-t{i}"))

        for i in pause_resume:
            manager.pause(tasks[i].task_id)
        for i in pause_resume:
            tasks[i].wait_idle(timeout)
        for i in pause_resume:
            manager.resume(tasks[i].task_id)

        finished = manager.wait_all(timeout=timeout)
        dest_all = read_dst() if finished else {}

        results: list[ScenarioResult] = []
        violations: list[str] = []
        for i, task in enumerate(tasks):
            # keys keep the t{i}/ prefix: check_invariants resolves a
            # FileResult.dst relative to DST_ROOT, so per-task keys must
            # be "t{i}/rel" or the ok-but-not-byte-exact check could
            # never find (and thus never fail) a file
            pfx = f"t{i}/"
            expected = {name[len(SRC_ROOT) + 1:]: data
                        for name, data in per_task_files[i].items()}
            dest = {k: v for k, v in dest_all.items() if k.startswith(pfx)}
            markers_after = manager.service.markers.load(task.task_id) \
                if finished else {"files": {"unfinished": True}}
            task_done = finished and task._done.is_set()
            v = check_invariants(task, expected, dest, schedule,
                                 markers_after, task_done, options.integrity)
            results.append(ScenarioResult(
                task=task, schedule=schedule, expected=expected, dest=dest,
                violations=v, route=route, tree=trees[i % len(trees)]))
            violations.extend(f"task {i}: {x}" for x in v)

        m = manager.metrics
        if m.peak_active > max_workers:
            violations.append(f"worker budget exceeded: peak_active "
                              f"{m.peak_active} > {max_workers}")
        if per_endpoint_cap is not None:
            for ep_id, peak in m.peak_by_endpoint.items():
                if peak > per_endpoint_cap:
                    violations.append(f"endpoint cap exceeded on {ep_id}: "
                                      f"{peak} > {per_endpoint_cap}")
        if advisor is not None and m.refits:
            # refit convergence: once the online loop has fired, tasks
            # predicted by a refit model must beat the seed model
            pre = manager.prediction_error(generation=0)
            post = manager.prediction_error(min_generation=1)
            if pre is not None and post is not None and post >= pre:
                violations.append(
                    f"refit did not converge: median prediction error "
                    f"{post:.3f} after refit >= {pre:.3f} before")
        manager.shutdown(wait=False)
        result = MultiScenarioResult(results=results, manager=manager,
                                     violations=violations)
        if strict and violations:
            raise AssertionError(
                f"multi-task scenario over {route} violated invariants:\n  "
                + "\n  ".join(violations))
        return result

    # ---- a federation of sites with a mid-flight site failure ------------
    def run_federated(self, n_sites: int = 2, n_tasks: int = 4,
                      tenants=("alice", "bob"),
                      trees=("few-large", "many-small", "mixed"),
                      placement: str = "owner",
                      schedule: FaultSchedule | None = None,
                      options: TransferOptions | None = None,
                      fail_site: bool = True, victim: int = 1,
                      max_workers: int = 3, hold_after: int = 4096,
                      seed: int = 0, timeout: float = 240.0,
                      strict: bool = False) -> "FederatedScenarioResult":
        """Run ``n_tasks`` transfers through a
        :class:`~repro_torch.fed.FederatedCoordinator` over ``n_sites`` site
        control planes, then kill one site mid-flight and assert the
        federation contract end-to-end.

        Topology: site ``i`` owns source endpoint ``src-s{i}`` (its own
        seeded connector); a single destination endpoint ``dst-ep`` —
        owned by site 0, reachable by all — collects every task's tree
        under ``out/t{j}``.  Task ``j`` sources from site
        ``j % n_sites``, so the owner placement policy must scatter the
        fleet across sites.  Every submission goes through the
        ``TransferSpec`` JSON wire form (serializability is part of
        what's under test).  A byte-threshold hold on the victim site's
        destination paths guarantees at least one of its tasks is
        genuinely mid-flight when :meth:`FederatedCoordinator.fail_site`
        fires; the fault ``schedule`` (if any) proxies the *source*
        side only, so the destination write-once invariant stays exact.

        Invariants, on top of the per-task :func:`check_invariants`:

        * every submission was initially placed at its source's owner;
        * the failed site hands off at least one task with traveled
          partial progress, and every handed-off task completes on its
          new site with the originating tenant (and origin site) still
          attributed — including charge-accounted model seconds;
        * with integrity off, every byte lands exactly once fleet-wide
          (``written == bytes_total`` per task): a handoff re-sends
          only the holes;
        * the coordinator never accrues model time (third-party
          semantics via the charge clock);
        * per-site worker budgets hold.
        """
        with self._lock:
            self._n += 1
            run_dir = os.path.join(self.base_dir, f"fed{self._n:03d}")
        os.makedirs(run_dir, exist_ok=True)
        n_sites = max(2, n_sites) if fail_site else max(1, n_sites)
        victim_site = f"s{victim % n_sites}"

        # one seeded source connector per site; one shared destination
        src_inners = [MemoryConnector(clock=self.clock) for _ in range(n_sites)]
        per_task_files: list[dict[str, bytes]] = []
        specs: list[TransferSpec] = []
        for j in range(n_tasks):
            files, _empty = canonical_tree(trees[j % len(trees)], seed + j)
            remapped = {f"{SRC_ROOT}/t{j}/" + name[len(SRC_ROOT) + 1:]: data
                        for name, data in files.items()}
            per_task_files.append(remapped)
            store = src_inners[j % n_sites].store
            for name, data in remapped.items():
                store.put(name, data)

        if schedule is not None and schedule.clock is None:
            schedule.clock = self.clock
        src_conns = [FaultProxyConnector(c, schedule)
                     if schedule is not None else c for c in src_inners]
        hold = None
        if fail_site:
            # gate the victim's SOURCE streams: once the threshold
            # crosses, its tasks stop making progress until the kill
            # has landed its pause requests — so the checkpoint that
            # travels is guaranteed mid-flight (progress AND holes)
            hold = _HoldSrc(src_conns[victim % n_sites])
            src_conns[victim % n_sites] = hold
            hold.arm_hold([SRC_ROOT + "/"], hold_after)
        dst_inner = MemoryConnector(clock=self.clock)
        dst_conn = _InstrumentedDst(dst_inner)

        endpoints = {f"src-s{i}": src_conns[i] for i in range(n_sites)}
        endpoints["dst-ep"] = dst_conn
        coord = FederatedCoordinator(placement=placement)
        for i in range(n_sites):
            creds = CredentialStore()
            for tenant in tenants:
                creds.register(f"src-s{i}", Credential(
                    "local-user", {"identity": tenant}))
            owns = {f"src-s{i}"} | ({"dst-ep"} if i == 0 else set())
            manager = TransferManager(
                max_workers=max_workers, per_endpoint_cap=None,
                credential_store=creds,
                marker_root=os.path.join(run_dir, f"site{i}", "markers"),
                clock=self.clock, site_id=f"s{i}")
            coord.register_site(f"s{i}", manager, endpoints, owns=owns)

        options = options or TransferOptions(
            startup_cost=0.0, retry_backoff=0.01, concurrency=2)
        victim_ids: list[str] = []
        for j in range(n_tasks):
            spec = TransferSpec.new(
                f"fed-{self._n:03d}-t{j}",
                f"src-s{j % n_sites}", f"{SRC_ROOT}/t{j}",
                "dst-ep", f"{DST_ROOT}/t{j}",
                tenant=tenants[j % len(tenants)], options=options,
                n_files=len(per_task_files[j]),
                nbytes=sum(len(d) for d in per_task_files[j].values()))
            specs.append(spec)
            if j % n_sites == victim % n_sites:
                victim_ids.append(spec.task_id)
        # the wire form IS the submission: serializability under test
        for spec in specs:
            coord.submit(spec.to_json())

        violations: list[str] = []
        moved: list[tuple[str, str]] = []
        if fail_site:
            if not hold.engaged.wait(timeout=min(60.0, timeout)):
                violations.append("hold never engaged: the victim site "
                                  "had no mid-flight task to kill")
                hold.release()
            else:
                victim_tasks = [coord.task(tid) for tid in victim_ids]
                # the crossing block _HoldSrc let through is still in
                # flight on the receive side, and a pause stops the
                # receiver at block granularity — killing the site
                # before that block lands durable would checkpoint zero
                # progress.  Wait for its write (fast: the dst is not
                # gated) before pulling the plug.  Harness kill window:
                # real threads may wedge, so the bound is wall time via
                # the sanctioned clock helpers.
                t_end = wall_now() + min(60.0, timeout)
                while wall_now() < t_end:
                    if any(t.stats.bytes_done > 0 for t in victim_tasks):
                        break
                    wall_sleep(0.002)
                fail_err: list[Exception] = []

                def do_fail():
                    try:
                        moved.extend(coord.fail_site(victim_site,
                                                     timeout=timeout))
                    except Exception as e:  # surfaced as a violation
                        fail_err.append(e)

                failer = threading.Thread(target=do_fail, daemon=True)
                failer.start()
                # release the held stream only once every victim task has
                # its pause landed (or finished): the site's checkpoint
                # is guaranteed to happen while the task was mid-flight
                t_end = wall_now() + min(60.0, timeout)
                while wall_now() < t_end:
                    if all(t._done.is_set() or t._pause_req.is_set()
                           or t.status == t.PAUSED for t in victim_tasks):
                        break
                    wall_sleep(0.005)
                hold.release()
                failer.join(timeout)
                if failer.is_alive():
                    violations.append("fail_site wedged: failover did "
                                      "not complete within the timeout")
                for e in fail_err:
                    violations.append(f"fail_site raised: "
                                      f"{type(e).__name__}: {e}")

        finished = coord.wait_all(timeout=timeout)
        dest_all = {}
        if finished:
            pfx = DST_ROOT + "/"
            dest_all = {k[len(pfx):]: dst_inner.store.get(k)
                        for k in dst_inner.store.keys()
                        if k.startswith(pfx)}

        results: list[ScenarioResult] = []
        for j, spec in enumerate(specs):
            task = coord.task(spec.task_id)
            site_id = coord.site_of(spec.task_id)
            mgr = coord.sites()[site_id].manager
            pfx = f"t{j}/"
            expected = {name[len(SRC_ROOT) + 1:]: data
                        for name, data in per_task_files[j].items()}
            dest = {k: v for k, v in dest_all.items() if k.startswith(pfx)}
            task_done = finished and task._done.is_set()
            markers_after = mgr.service.markers.load(spec.task_id) \
                if task_done else {"files": {"unfinished": True}}
            v = check_invariants(task, expected, dest, schedule,
                                 markers_after, task_done,
                                 options.integrity)
            results.append(ScenarioResult(
                task=task, schedule=schedule, expected=expected, dest=dest,
                violations=v, route=f"fed:{site_id}",
                tree=trees[j % len(trees)]))
            violations.extend(f"task {j}: {x}" for x in v)

        # federation-level invariants --------------------------------------
        if placement == "owner":
            first_place = {}
            for tid, sid, reason in coord.metrics.placement_log:
                if reason == "submit" and tid not in first_place:
                    first_place[tid] = sid
            for j, spec in enumerate(specs):
                owner = f"s{j % n_sites}"
                if first_place.get(spec.task_id) != owner:
                    violations.append(
                        f"task {j}: placed at "
                        f"{first_place.get(spec.task_id)!r}, but "
                        f"{owner!r} owns its source endpoint")
        if fail_site and hold.engaged.is_set():
            if not moved:
                violations.append("site failure moved no tasks (all "
                                  "finished before the kill?)")
            if not any(coord.last_spec(tid) is not None
                       and coord.last_spec(tid).done_bytes() > 0
                       for tid, _ in moved):
                violations.append("no handed-off task carried partial "
                                  "progress (hole map did not travel)")
            for tid, new_site in moved:
                task = coord.task(tid)
                if task.status != task.SUCCEEDED:
                    violations.append(f"handed-off {tid} ended "
                                      f"{task.status} on {new_site}")
                if task.stats.site != new_site:
                    violations.append(f"{tid}: stats.site "
                                      f"{task.stats.site!r} != adopting "
                                      f"site {new_site!r}")
                if task.stats.origin_site != victim_site:
                    violations.append(f"{tid}: origin_site "
                                      f"{task.stats.origin_site!r} lost "
                                      f"across the handoff")
        for j, spec in enumerate(specs):
            task = coord.task(spec.task_id)
            want = tenants[j % len(tenants)]
            if task.stats.tenant != want:
                violations.append(f"task {j}: tenant attribution "
                                  f"{task.stats.tenant!r} != {want!r}")
            if task.status == task.SUCCEEDED \
                    and task.stats.bytes_total > 0 \
                    and task.stats.actual_model_seconds <= 0:
                violations.append(f"task {j}: no model seconds charged "
                                  f"to it (attribution broken)")
            if not options.integrity and finished:
                written = dst_conn.written(f"{DST_ROOT}/t{j}/")
                if task.status == task.SUCCEEDED \
                        and written != task.stats.bytes_total:
                    violations.append(
                        f"task {j}: {written} bytes written at dst for "
                        f"{task.stats.bytes_total} byte tree — a handoff "
                        f"must re-send only the holes")
        try:
            coord.assert_third_party()
        except AssertionError as e:
            violations.append(str(e))
        for site_id, handle in coord.sites().items():
            peak = handle.manager.metrics.peak_active
            if peak > max_workers:
                violations.append(f"site {site_id}: worker budget "
                                  f"exceeded ({peak} > {max_workers})")
        if not finished:
            violations.append("wedged: the federation did not finish "
                              "within the timeout")

        coord.shutdown(wait=False)
        result = FederatedScenarioResult(
            results=results, coordinator=coord, moved=moved,
            violations=violations)
        if strict and violations:
            raise AssertionError(
                "federated scenario violated invariants:\n  "
                + "\n  ".join(violations))
        return result

    # ---- fan-out dedupe through the replica catalog ----------------------
    def run_fanout(self, n_fanout: int = 4, tree="many-small",
                   chaos: str = "none",
                   options: TransferOptions | None = None,
                   byte_budget: int | None = None, max_workers: int = 4,
                   seed: int = 0, timeout: float = 240.0,
                   strict: bool = False) -> "FanoutScenarioResult":
        """Submit the SAME source tree ``n_fanout`` times (distinct
        destination prefixes) through one manager sharing a
        :class:`~repro_torch.catalog.ReplicaCatalog`, and assert the dedupe
        contract: the first task moves the tree, the other N-1 are
        satisfied by verified replica reads at the destination — bytes
        leaving the *source* stay ~1x the tree, and write-once
        destination accounting still holds.

        ``chaos`` injects a catalog betrayal between the first transfer
        and the fan-out, and the invariant flips to "fall back to a
        real transfer, never serve wrong bytes":

        * ``"evict"`` — every entry is evicted before the fan-out: all
          lookups must miss and every file is source-read again;
        * ``"stale"`` — every source file is rewritten (mtime forced
          forward): traveled signatures mismatch, entries are
          invalidated, and the fan-out lands the NEW bytes;
        * ``"corrupt"`` — the landed replica bytes are flipped in
          place: the replica read's checksum fold must catch it,
          invalidate the entry, and fall back.

        Integrity must stay on (the default here): the catalog only
        trusts §7-folded content keys.
        """
        if chaos not in ("none", "evict", "stale", "corrupt"):
            raise ValueError(f"unknown fanout chaos {chaos!r}")
        with self._lock:
            self._n += 1
            run_dir = os.path.join(self.base_dir, f"fanout{self._n:03d}")
        os.makedirs(run_dir, exist_ok=True)

        if isinstance(tree, str):
            files, empty_dirs = canonical_tree(tree, seed)
        else:
            files, empty_dirs, tree = dict(tree), [], "<literal>"
        # posix source: stat signatures (size, mtime) are live, so the
        # stale mutation below is visible to the catalog's freshness
        # check.  memory destination: replica bytes are reachable for
        # the corrupt mutation.
        src_root = os.path.join(run_dir, "srcfs")
        for name, payload in files.items():
            p = os.path.join(src_root, name)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "wb") as f:
                f.write(payload)
        for d in empty_dirs:
            os.makedirs(os.path.join(src_root, d), exist_ok=True)
        src_conn = _MeteredSrc(PosixConnector(src_root))
        dst_inner = MemoryConnector(clock=self.clock)
        dst_conn = _InstrumentedDst(dst_inner)

        creds = CredentialStore()
        for ep_id, conn in (("src-ep", src_conn), ("dst-ep", dst_conn)):
            creds.register(ep_id, Credential(
                conn.credential_scheme or "local-user", {"token": "t"}))
        catalog = ReplicaCatalog(byte_budget=byte_budget)
        manager = TransferManager(
            max_workers=max_workers, per_endpoint_cap=None,
            credential_store=creds, catalog=catalog,
            marker_root=os.path.join(run_dir, "markers"), clock=self.clock)
        options = options or TransferOptions(
            integrity=True, startup_cost=0.0, retry_backoff=0.01,
            concurrency=2)

        def submit(k: int):
            return manager.submit(
                Endpoint(src_conn, SRC_ROOT, "src-ep"),
                Endpoint(dst_conn, f"{DST_ROOT}/t{k}", "dst-ep"),
                options, task_id=f"fanout-{self._n:03d}-t{k}")

        def read_dst(k: int) -> dict[str, bytes]:
            pfx = f"{DST_ROOT}/t{k}/"
            return {key[len(pfx):]: dst_inner.store.get(key)
                    for key in dst_inner.store.keys()
                    if key.startswith(pfx)}

        expected = {name[len(SRC_ROOT) + 1:]: payload
                    for name, payload in files.items()}
        results: list[ScenarioResult] = []
        violations: list[str] = []

        # --- the one real transfer, checked BEFORE any chaos mutates
        # the source or its landed bytes
        tasks = [submit(0)]
        finished0 = tasks[0].wait(timeout=timeout)
        dest0 = read_dst(0) if finished0 else {}
        markers0 = manager.service.markers.load(tasks[0].task_id) \
            if finished0 else {"files": {"unfinished": True}}
        v0 = check_invariants(tasks[0], expected, dest0, None, markers0,
                              finished0, options.integrity)
        results.append(ScenarioResult(
            task=tasks[0], schedule=None, expected=expected, dest=dest0,
            violations=v0, route="posix->memory", tree=tree))
        violations.extend(f"task 0: {x}" for x in v0)

        # zero-byte files are never cataloged (no content to replicate)
        n_cat = sum(1 for payload in files.values() if payload)

        # --- chaos injection between first transfer and fan-out
        if chaos == "evict":
            for e in catalog.entries():
                catalog.invalidate(e, reason="evicted")
            if catalog.entries():
                violations.append("evict chaos left catalog entries behind")
        elif chaos == "stale":
            for name, payload in list(files.items()):
                p = os.path.join(src_root, name)
                mutated = bytes(b ^ 0xFF for b in payload)
                with open(p, "wb") as f:
                    f.write(mutated)
                st = os.stat(p)
                os.utime(p, (st.st_atime + 100, st.st_mtime + 100))
                files[name] = mutated
            # the fan-out must land the NEW bytes, never the cataloged old
            expected = {name[len(SRC_ROOT) + 1:]: payload
                        for name, payload in files.items()}
        elif chaos == "corrupt":
            pfx = f"{DST_ROOT}/t0/"
            for key in list(dst_inner.store.keys()):
                if key.startswith(pfx):
                    data = dst_inner.store.get(key)
                    if data:
                        dst_inner.store.put(
                            key, bytes([data[0] ^ 0xFF]) + data[1:])

        # --- the fan-out
        for k in range(1, n_fanout):
            tasks.append(submit(k))
        finished = manager.wait_all(timeout=timeout)
        for k, task in enumerate(tasks[1:], start=1):
            dest = read_dst(k) if finished else {}
            markers_after = manager.service.markers.load(task.task_id) \
                if finished else {"files": {"unfinished": True}}
            task_done = finished and task._done.is_set()
            v = check_invariants(task, expected, dest, None, markers_after,
                                 task_done, options.integrity)
            results.append(ScenarioResult(
                task=task, schedule=None, expected=expected, dest=dest,
                violations=v, route="posix->memory", tree=tree))
            violations.extend(f"task {k}: {x}" for x in v)

        source_bytes = src_conn.sent(SRC_ROOT)
        tree_bytes = sum(len(payload) for payload in files.values())
        fan = tasks[1:]
        hits = sum(t.stats.replica_hits for t in fan)
        fallbacks = sum(t.stats.replica_fallbacks for t in fan)
        if finished:
            if chaos == "none":
                if source_bytes > int(1.05 * tree_bytes):
                    violations.append(
                        f"fan-out of {n_fanout} moved {source_bytes} source "
                        f"bytes for a {tree_bytes} byte tree — dedupe must "
                        f"collapse N submissions to ~1 real transfer")
                want = (n_fanout - 1) * n_cat
                if hits != want:
                    violations.append(f"expected {want} replica hits "
                                      f"across the fan-out, saw {hits}")
                for k, task in enumerate(tasks):
                    written = dst_conn.written(f"{DST_ROOT}/t{k}/")
                    if written != task.stats.bytes_total:
                        violations.append(
                            f"task {k}: {written} bytes written for a "
                            f"{task.stats.bytes_total} byte tree — a "
                            f"replica read must write each byte once")
            elif chaos == "evict" and source_bytes < 2 * tree_bytes:
                violations.append(
                    f"catalog was emptied but the source streamed only "
                    f"{source_bytes} of >= {2 * tree_bytes} bytes — "
                    f"evicted entries must fall back to real transfers")
            elif chaos == "stale":
                if catalog.stale_invalidations < n_cat:
                    violations.append(
                        f"only {catalog.stale_invalidations} of {n_cat} "
                        f"stale entries were invalidated")
                if source_bytes < 2 * tree_bytes:
                    violations.append(
                        f"source streamed {source_bytes} < "
                        f"{2 * tree_bytes} bytes after mutation — stale "
                        f"replicas must never be served")
            elif chaos == "corrupt":
                if catalog.corrupt_invalidations < n_cat:
                    violations.append(
                        f"only {catalog.corrupt_invalidations} of {n_cat} "
                        f"corrupted entries were invalidated")
                if fallbacks < n_cat:
                    violations.append(
                        f"only {fallbacks} replica fallbacks for {n_cat} "
                        f"corrupted replicas — the fold must catch every "
                        f"corrupt read and fall back")
        manager.shutdown(wait=False)
        result = FanoutScenarioResult(
            chaos=chaos, results=results, manager=manager, catalog=catalog,
            source_bytes=source_bytes, tree_bytes=tree_bytes,
            replica_hits=hits, replica_fallbacks=fallbacks,
            violations=violations)
        if strict and violations:
            raise AssertionError(
                f"fan-out scenario (chaos={chaos}) violated invariants:"
                "\n  " + "\n  ".join(violations))
        return result

    # ---- degraded-mode scenarios (health plane) --------------------------
    def run_degraded(self, mode: str = "brownout",
                     n_tasks: int | None = None,
                     health: HealthConfig | None = None, storm: int = 6,
                     miss_threshold: int = 3, victim: int = 1,
                     seed: int = 0, timeout: float = 240.0,
                     strict: bool = False) -> "DegradedScenarioResult":
        """Run the fleet against *degrading* (not just failing) storage
        and assert the health plane's contract.  Three modes:

        * ``"brownout"`` — the destination endpoint fails every recv for
          a bounded global storm, then recovers.  The breaker must open
          on the error burst, hold the fleet off with fast-fail
          :class:`~repro_torch.core.EndpointUnavailable` denials, probe
          half-open, re-open while the storm lasts, close on the first
          probe that succeeds — and every task must still finish
          byte-exact.  Both ``"EndpointUnavailable"`` and
          ``"HalfOpenProbe"`` must appear in the fleet's
          ``retries_by_kind`` (the taxonomy is observable).
        * ``"death"`` — the destination endpoint is permanently dead.
          A 20-task fleet through one :class:`TransferManager` must
          finish (FAILED, never wedged) with total storage attempts
          bounded by the shared retry budget — O(budget), not
          O(n_tasks * max_retries): no retry storm.
        * ``"flapping-site"`` — a federation site's digest channel flaps
          below ``miss_threshold`` consecutive misses (no failover may
          fire), then goes permanently dark: the heartbeat monitor in
          :meth:`~repro_torch.fed.FederatedCoordinator.beat` must auto-invoke
          the failover path (the caller never calls ``fail_site``),
          re-homed tasks must finish byte-exact with write-once
          destination bytes, and the coordinator must stay zero-charge.
        """
        with self._lock:
            self._n += 1
            run_dir = os.path.join(self.base_dir, f"deg{self._n:03d}")
        os.makedirs(run_dir, exist_ok=True)

        if mode == "brownout":
            return self._degraded_endpoint(
                run_dir, mode, n_tasks or 4, health, storm, seed, timeout,
                strict)
        if mode == "death":
            return self._degraded_endpoint(
                run_dir, mode, n_tasks or 20, health, storm, seed, timeout,
                strict)
        if mode == "flapping-site":
            return self._degraded_federation(
                run_dir, n_tasks or 4, miss_threshold, victim, seed,
                timeout, strict)
        raise ValueError(f"unknown degraded mode {mode!r}")

    def _degraded_endpoint(self, run_dir: str, mode: str, n: int,
                           health: HealthConfig | None, storm: int,
                           seed: int, timeout: float,
                           strict: bool) -> "DegradedScenarioResult":
        """Brownout / permanent-death of the destination endpoint."""
        if mode == "brownout":
            cfg = health or HealthConfig(
                error_threshold=0.5, ewma_alpha=0.6, min_samples=2,
                cooldown=0.15, probe_successes=1,
                retry_budget_rate=2.0, retry_budget_capacity=12.0)
            schedule = FaultSchedule(seed=seed).brownout(storm, op="recv*")
            #: real (admitted) attempts only — fast-fail denials are
            #: bounded by ``unavailable_patience`` on the model clock,
            #: not by this count
            max_retries = 12
            files_per_task = 2
            #: unbounded: a brownout ends by construction (the storm is
            #: a finite ``times=storm``), and this scenario's invariant
            #: is that NO task gives up — give-up behavior is the death
            #: mode's test.  At time-scale 0 the waiter crowd's denial
            #: sleeps advance the shared model clock arbitrarily fast
            #: relative to thread scheduling, so any finite patience
            #: here would be a scheduling race.
            patience = float("inf")
        else:
            cfg = health or HealthConfig(
                error_threshold=0.5, ewma_alpha=0.4, min_samples=3,
                cooldown=0.05, probe_successes=1,
                retry_budget_rate=0.0, retry_budget_capacity=4.0)
            schedule = FaultSchedule(seed=seed).dead_endpoint(op="recv*")
            max_retries = 6
            files_per_task = 1
            #: a dead endpoint never recovers: give up on fast-fail
            #: denials after a short model-clock wait so the fleet
            #: drains FAILED instead of waiting out a long patience
            patience = 2.0
        schedule.clock = self.clock

        src_inner = MemoryConnector(clock=self.clock)
        per_task_files: list[dict[str, bytes]] = []
        for i in range(n):
            rng = random.Random(f"degraded|{seed}|{i}")
            files = {f"{SRC_ROOT}/t{i}/f{k}.bin":
                     rng.randbytes(rng.randint(1 * KB, 2 * KB))
                     for k in range(files_per_task)}
            per_task_files.append(files)
            for name, data in files.items():
                src_inner.store.put(name, data)
        dst_inner = MemoryConnector(clock=self.clock)
        dst_conn = FaultProxyConnector(dst_inner, schedule)

        creds = CredentialStore()
        for ep_id in ("src-ep", "dst-ep"):
            creds.register(ep_id, Credential("local-user", {"token": "t"}))
        hp = EndpointHealth(cfg, clock=self.clock)
        # batching off: the per-file path's admit() gate is the budget
        # enforcement under test
        options = TransferOptions(
            startup_cost=0.0, retry_backoff=0.01, concurrency=2,
            max_retries=max_retries, coalesce_threshold=0,
            unavailable_patience=patience)

        per_endpoint_cap = 2
        manager = None
        if mode == "death":
            # the fleet goes through ONE control plane: dispatch must
            # defer around the open breaker and never wedge
            options.concurrency = 1
            manager = TransferManager(
                max_workers=4, per_endpoint_cap=per_endpoint_cap,
                credential_store=creds,
                marker_root=os.path.join(run_dir, "markers"),
                clock=self.clock, health=hp)
            submit = manager.submit
            service = manager.service
        else:
            service = TransferService(
                credential_store=creds,
                marker_root=os.path.join(run_dir, "markers"),
                clock=self.clock, health=hp)
            submit = service.submit

        tasks = []
        for i in range(n):
            tasks.append(submit(
                Endpoint(src_inner, f"{SRC_ROOT}/t{i}", "src-ep"),
                Endpoint(dst_conn, f"{DST_ROOT}/t{i}", "dst-ep"),
                options, task_id=f"deg-{mode}-t{i}"))
        if manager is not None:
            finished = manager.wait_all(timeout=timeout)
        else:
            finished = all(t.wait(timeout=timeout) for t in tasks)

        pfx = DST_ROOT + "/"
        dest_all = {k[len(pfx):]: dst_inner.store.get(k)
                    for k in dst_inner.store.keys() if k.startswith(pfx)}

        results: list[ScenarioResult] = []
        violations: list[str] = []
        for i, task in enumerate(tasks):
            tp = f"t{i}/"
            expected = {name[len(SRC_ROOT) + 1:]: data
                        for name, data in per_task_files[i].items()}
            dest = {k: v for k, v in dest_all.items() if k.startswith(tp)}
            task_done = task._done.is_set()
            markers_after = service.markers.load(task.task_id) \
                if task_done else {"files": {"unfinished": True}}
            v = check_invariants(task, expected, dest, schedule,
                                 markers_after, task_done, options.integrity)
            results.append(ScenarioResult(
                task=task, schedule=schedule, expected=expected, dest=dest,
                violations=v, route=f"degraded:{mode}", tree="degraded"))
            violations.extend(f"task {i}: {x}" for x in v)

        if not finished:
            violations.append(f"wedged: the {mode} fleet did not finish "
                              f"within the timeout")
        agg: dict[str, int] = {}
        for t in tasks:
            for k, c in t.stats.retries_by_kind.items():
                agg[k] = agg.get(k, 0) + c
        names = hp.transition_names("dst-ep")
        attempts = schedule.count("transient")

        if mode == "brownout":
            for i, t in enumerate(tasks):
                if t.status != t.SUCCEEDED:
                    violations.append(
                        f"task {i} ended {t.status} — a brownout (bounded "
                        f"storm) must not fail the fleet")
            if not names or names[0] != "closed->open":
                violations.append(
                    f"breaker never opened on the error burst: {names}")
            elif names[-1] != "half-open->closed":
                violations.append(
                    f"breaker did not close after recovery: {names}")
            if not agg.get("EndpointUnavailable"):
                violations.append("no EndpointUnavailable fast-fail was "
                                  "recorded: the fleet hammered the sick "
                                  "endpoint through the open breaker")
            if not agg.get("HalfOpenProbe"):
                violations.append("no half-open probe was recorded: the "
                                  "breaker cannot have closed legally")
        else:  # death
            for i, t in enumerate(tasks):
                if t.status == t.SUCCEEDED and t.stats.bytes_total > 0:
                    violations.append(
                        f"task {i} SUCCEEDED against a dead endpoint")
            # O(budget) bound: pre-open evidence window + concurrent
            # in-flight attempts + budget-funded probes + slack — NOT
            # O(n_tasks * max_retries)
            bound = (cfg.min_samples + per_endpoint_cap
                     + int(cfg.retry_budget_capacity) + 2)
            if attempts > bound:
                violations.append(
                    f"retry storm: {attempts} storage attempts against "
                    f"the dead endpoint, budget bound is {bound}")
            if attempts >= n * (max_retries + 1):
                violations.append(
                    f"unbounded retries: {attempts} >= "
                    f"n_tasks*max_retries = {n * (max_retries + 1)}")
            if not names or names[0] != "closed->open":
                violations.append(
                    f"breaker never opened on the dead endpoint: {names}")
            if not agg.get("EndpointUnavailable"):
                violations.append("no fast-fail denials recorded against "
                                  "the dead endpoint")
        if manager is not None:
            manager.shutdown(wait=False)

        result = DegradedScenarioResult(
            mode=mode, results=results, health=hp, schedule=schedule,
            transitions=names, attempts=attempts, retries_by_kind=agg,
            violations=violations)
        if strict and violations:
            raise AssertionError(
                f"degraded scenario ({mode}) violated invariants:\n  "
                + "\n  ".join(violations))
        return result

    def _degraded_federation(self, run_dir: str, n_tasks: int,
                             miss_threshold: int, victim: int, seed: int,
                             timeout: float,
                             strict: bool) -> "DegradedScenarioResult":
        """Flapping then permanently-dark federation site: heartbeat
        misses below threshold must NOT fail the site; sustained misses
        must auto-trigger failover with no caller ``fail_site``."""
        n_sites = 2
        victim_site = f"s{victim % n_sites}"

        src_inners = [MemoryConnector(clock=self.clock) for _ in range(n_sites)]
        per_task_files: list[dict[str, bytes]] = []
        specs: list[TransferSpec] = []
        for j in range(n_tasks):
            rng = random.Random(f"degraded-fed|{seed}|{j}")
            files = {f"{SRC_ROOT}/t{j}/f{k}.bin":
                     rng.randbytes(rng.randint(4 * KB, 8 * KB))
                     for k in range(3)}
            per_task_files.append(files)
            store = src_inners[j % n_sites].store
            for name, data in files.items():
                store.put(name, data)

        src_conns: list = list(src_inners)
        # gate the victim's source streams so at least one of its tasks
        # is genuinely mid-flight when the site goes dark (same idiom as
        # run_federated)
        hold = _HoldSrc(src_conns[victim % n_sites])
        src_conns[victim % n_sites] = hold
        hold.arm_hold([SRC_ROOT + "/"], 2048)
        dst_inner = MemoryConnector(clock=self.clock)
        dst_conn = _InstrumentedDst(dst_inner)

        endpoints = {f"src-s{i}": src_conns[i] for i in range(n_sites)}
        endpoints["dst-ep"] = dst_conn
        coord = FederatedCoordinator(placement="owner",
                                     miss_threshold=miss_threshold)
        flaky: _FlakyDigest | None = None
        for i in range(n_sites):
            creds = CredentialStore()
            creds.register(f"src-s{i}", Credential(
                "local-user", {"identity": "alice"}))
            manager = TransferManager(
                max_workers=3, per_endpoint_cap=None,
                credential_store=creds,
                marker_root=os.path.join(run_dir, f"site{i}", "markers"),
                clock=self.clock, site_id=f"s{i}")
            handle = manager
            if i == victim % n_sites:
                flaky = _FlakyDigest(manager)
                handle = flaky
            coord.register_site(f"s{i}", handle, endpoints,
                                owns={f"src-s{i}"}
                                | ({"dst-ep"} if i == 0 else set()))

        options = TransferOptions(
            startup_cost=0.0, retry_backoff=0.01, concurrency=2)
        victim_ids: list[str] = []
        for j in range(n_tasks):
            spec = TransferSpec.new(
                f"deg-fed-t{j}",
                f"src-s{j % n_sites}", f"{SRC_ROOT}/t{j}",
                "dst-ep", f"{DST_ROOT}/t{j}",
                tenant="alice", options=options,
                n_files=len(per_task_files[j]),
                nbytes=sum(len(d) for d in per_task_files[j].values()))
            specs.append(spec)
            if j % n_sites == victim % n_sites:
                victim_ids.append(spec.task_id)
            coord.submit(spec.to_json())

        violations: list[str] = []
        if not hold.engaged.wait(timeout=min(60.0, timeout)):
            violations.append("hold never engaged: the victim site had "
                              "no mid-flight task to strand")
            hold.release()

        # phase 1: flap BELOW the threshold — no failover may fire
        flaky.down.set()
        for _ in range(miss_threshold - 1):
            coord.beat(timeout=timeout)
        flaky.down.clear()
        coord.beat(timeout=timeout)  # recovery beat resets the misses
        vh = coord.sites()[victim_site]
        if coord.metrics.auto_failovers or not vh.alive:
            violations.append(
                "flapping below miss_threshold triggered a failover: "
                "the monitor has no hysteresis")
        if vh.missed_beats != 0:
            violations.append(
                f"recovered heartbeat did not reset the miss counter "
                f"({vh.missed_beats} != 0)")

        # phase 2: permanently dark — beat() must auto-fail the site.
        # The releaser frees the held streams only once every victim
        # task has its pause landed (or finished), so the traveled
        # checkpoint is guaranteed mid-flight.
        flaky.down.set()
        victim_tasks = [coord.task(tid) for tid in victim_ids]

        def do_release():
            t_end = wall_now() + min(60.0, timeout)
            while wall_now() < t_end:
                if all(t._done.is_set() or t._pause_req.is_set()
                       or t.status == t.PAUSED for t in victim_tasks):
                    break
                wall_sleep(0.005)
            hold.release()

        releaser = threading.Thread(target=do_release, daemon=True)
        releaser.start()
        t0 = self.clock.virtual_elapsed
        failed_sites: list[str] = []
        for _ in range(miss_threshold + 2):
            failed_sites = coord.beat(timeout=timeout)
            if failed_sites:
                break
        failover_model_s = self.clock.virtual_elapsed - t0
        releaser.join(timeout=min(60.0, timeout))

        finished = coord.wait_all(timeout=timeout)
        pfx = DST_ROOT + "/"
        dest_all = {k[len(pfx):]: dst_inner.store.get(k)
                    for k in dst_inner.store.keys()
                    if k.startswith(pfx)} if finished else {}

        moved = [(tid, sid) for tid, sid, reason
                 in coord.metrics.placement_log if reason == "failover"]
        results: list[ScenarioResult] = []
        for j, spec in enumerate(specs):
            task = coord.task(spec.task_id)
            site_id = coord.site_of(spec.task_id)
            mgr = coord.sites()[site_id].manager
            tp = f"t{j}/"
            expected = {name[len(SRC_ROOT) + 1:]: data
                        for name, data in per_task_files[j].items()}
            dest = {k: v for k, v in dest_all.items() if k.startswith(tp)}
            task_done = finished and task._done.is_set()
            markers_after = mgr.service.markers.load(spec.task_id) \
                if task_done else {"files": {"unfinished": True}}
            v = check_invariants(task, expected, dest, None,
                                 markers_after, task_done,
                                 options.integrity)
            results.append(ScenarioResult(
                task=task, schedule=None, expected=expected, dest=dest,
                violations=v, route=f"fed:{site_id}", tree="degraded"))
            violations.extend(f"task {j}: {x}" for x in v)

        if not finished:
            violations.append("wedged: the federation did not finish "
                              "within the timeout")
        if failed_sites != [victim_site]:
            violations.append(
                f"heartbeat monitor failed over {failed_sites!r}, "
                f"expected [{victim_site!r}]")
        if coord.metrics.auto_failovers != 1:
            violations.append(
                f"auto_failovers = {coord.metrics.auto_failovers}, "
                f"expected exactly 1 (heartbeat-driven)")
        if coord.sites()[victim_site].alive:
            violations.append("victim site still alive after sustained "
                              "heartbeat loss")
        if hold.engaged.is_set() and not moved:
            violations.append("auto-failover re-homed no tasks (all "
                              "finished before the site went dark?)")
        if coord.metrics.stranded:
            violations.append(
                f"auto-failover stranded {coord.metrics.stranded!r}")
        for j, spec in enumerate(specs):
            task = coord.task(spec.task_id)
            if task.status != task.SUCCEEDED:
                violations.append(f"task {j} ended {task.status} after "
                                  f"auto-failover")
            elif finished and not options.integrity:
                written = dst_conn.written(f"{DST_ROOT}/t{j}/")
                if written != task.stats.bytes_total:
                    violations.append(
                        f"task {j}: {written} bytes written for a "
                        f"{task.stats.bytes_total} byte tree — failover "
                        f"must re-send only the holes")
        try:
            coord.assert_third_party()
        except AssertionError as e:
            violations.append(str(e))

        coord.shutdown(wait=False)
        result = DegradedScenarioResult(
            mode="flapping-site", results=results, health=None,
            schedule=None, coordinator=coord, moved=moved,
            failover_model_seconds=failover_model_s,
            violations=violations)
        if strict and violations:
            raise AssertionError(
                "degraded scenario (flapping-site) violated invariants:"
                "\n  " + "\n  ".join(violations))
        return result


@dataclass
class MultiScenarioResult:
    """Outcome of :meth:`ScenarioRunner.run_multi`."""

    results: list[ScenarioResult]
    manager: TransferManager
    violations: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def tasks(self):
        return [r.task for r in self.results]


@dataclass
class FederatedScenarioResult:
    """Outcome of :meth:`ScenarioRunner.run_federated`."""

    results: list[ScenarioResult]
    coordinator: FederatedCoordinator
    #: (task_id, new_site_id) for every task the site failure re-homed
    moved: list = field(default_factory=list)
    violations: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def tasks(self):
        return [r.task for r in self.results]


@dataclass
class FanoutScenarioResult:
    """Outcome of :meth:`ScenarioRunner.run_fanout`."""

    chaos: str
    results: list[ScenarioResult]
    manager: TransferManager
    catalog: ReplicaCatalog
    #: bytes that actually left the source (send-side meter) vs the
    #: tree's size — the fan-out dedupe ratio
    source_bytes: int = 0
    tree_bytes: int = 0
    replica_hits: int = 0
    replica_fallbacks: int = 0
    violations: list[str] = field(default_factory=list)

    @property
    def moved_ratio(self) -> float:
        """source bytes moved per tree byte: ~1.0 means the fan-out
        collapsed to one real transfer."""
        return self.source_bytes / self.tree_bytes if self.tree_bytes \
            else 0.0

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def tasks(self):
        return [r.task for r in self.results]


@dataclass
class DegradedScenarioResult:
    """Outcome of :meth:`ScenarioRunner.run_degraded`."""

    mode: str
    results: list[ScenarioResult]
    #: the shared health registry (endpoint modes; None for fed mode)
    health: EndpointHealth | None
    schedule: FaultSchedule | None
    coordinator: FederatedCoordinator | None = None
    #: (task_id, new_site_id) re-homed by the heartbeat-driven failover
    moved: list = field(default_factory=list)
    #: breaker transition names for the sick endpoint, in order
    transitions: list = field(default_factory=list)
    #: storage-level fault firings against the sick endpoint (the
    #: number the shared retry budget bounds)
    attempts: int = 0
    #: fleet-aggregated ``TaskStats.retries_by_kind``
    retries_by_kind: dict = field(default_factory=dict)
    #: model seconds from the first dark beat to the automatic failover
    failover_model_seconds: float = 0.0
    violations: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def tasks(self):
        return [r.task for r in self.results]
