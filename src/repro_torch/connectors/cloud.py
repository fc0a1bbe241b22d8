"""Emulated cloud object stores + their Connectors (paper §4-§6).

A copy of ``repro/connectors/cloud.py``: the port imports nothing of ``repro``.

Each provider (AWS-S3, Wasabi, Google-Cloud, Google-Drive, Box, Ceph) is
emulated as a :class:`CloudStorage` service:
a blob namespace fronted by a native API whose calls cost request
round-trips, payload transmission on a network link, API-processing
latency, and call-quota tokens (Drive/Box throttle, paper §4).  All
constants are *model seconds* scaled by ``REPRO_TIME_SCALE``
(see ``repro_torch.core.clock``).

Two access paths exist, matching the paper's experiment design:

* :class:`NativeClient` — the two-party baseline ("boto3"), running at
  the science institution, calling the native API over the WAN.
* :class:`ObjectStoreConnector` — the Connector, deployed either
  ``placement="local"`` (institution DTN, native API over WAN — Fig. 4)
  or ``placement="cloud"`` (VM next to the storage, native API over LAN,
  GridFTP handles the WAN hop — Fig. 5).
"""

from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass, field, replace

from ..core.clock import (Clock, DEFAULT_CLOCK, Link, TokenBucket,
                          bind_charge_owner)
from ..core.connector import AppChannel, Connector, Credential, Session, StatInfo
from ..core.errors import AuthError, FaultInjected, NotFound, RateLimitError
from ..core.faults import FaultSchedule
from .memory import BlobDict

MB = 1024 * 1024


@dataclass(frozen=True)
class StorageProfile:
    """Per-provider native-API characteristics (model units)."""

    provider: str
    api_latency: float          # service-side processing per call (s)
    put_calls: int              # control round-trips per object PUT
    get_calls: int              # control round-trips per object GET
    quota_rate: float           # API calls per second (token bucket)
    quota_burst: float
    intra_bw: float             # service-internal per-object-stream cap (B/s)
    native_put_streams: int = 1  # native SDK internal parallelism (multipart)
    native_get_streams: int = 1
    credential_scheme: str = "s3-keypair"
    consistency_delay: float = 0.0  # eventual visibility of fresh objects


#: §4's six providers.  Constants chosen so the *relative* behaviour
#: matches the paper's measurements (Figs. 6-17): S3-family APIs are
#: fast w/ generous quotas; Drive/Box have high per-call latency and
#: tight call quotas; Ceph is institution-grade (low latency).
PROFILES: dict[str, StorageProfile] = {
    "s3": StorageProfile("s3", api_latency=0.020, put_calls=2, get_calls=1,
                         quota_rate=1000, quota_burst=2000, intra_bw=300 * MB,
                         native_put_streams=4, native_get_streams=2),
    "wasabi": StorageProfile("wasabi", api_latency=0.035, put_calls=2, get_calls=1,
                             quota_rate=500, quota_burst=1000, intra_bw=220 * MB,
                             native_put_streams=2, native_get_streams=2),
    "gcs": StorageProfile("gcs", api_latency=0.025, put_calls=2, get_calls=1,
                          quota_rate=1000, quota_burst=2000, intra_bw=280 * MB,
                          native_put_streams=2, native_get_streams=2,
                          credential_scheme="oauth2-token"),
    "drive": StorageProfile("drive", api_latency=0.180, put_calls=3, get_calls=2,
                            quota_rate=10, quota_burst=25, intra_bw=25 * MB,
                            credential_scheme="oauth2-token",
                            consistency_delay=0.5),
    "box": StorageProfile("box", api_latency=0.140, put_calls=3, get_calls=2,
                          quota_rate=16, quota_burst=32, intra_bw=30 * MB,
                          credential_scheme="oauth2-token",
                          consistency_delay=0.5),
    "ceph": StorageProfile("ceph", api_latency=0.004, put_calls=2, get_calls=1,
                           quota_rate=5000, quota_burst=10000, intra_bw=400 * MB),
}


def wan_link(clock: Clock | None = None) -> Link:
    """Institution <-> cloud WAN (iperf-calibrated vs paper §6: ~4-7
    Gbps aggregate, single TCP stream ~40 MB/s)."""
    return Link("wan", rtt=0.030, per_stream_bw=40 * MB, aggregate_bw=600 * MB,
                clock=clock or DEFAULT_CLOCK)


def lan_link(clock: Clock | None = None) -> Link:
    """In-cloud VM <-> storage frontend."""
    return Link("lan", rtt=0.001, per_stream_bw=300 * MB, aggregate_bw=2500 * MB,
                clock=clock or DEFAULT_CLOCK)


class CloudStorage:
    """The provider-side service: blobs + native API semantics."""

    def __init__(self, profile: StorageProfile, clock: Clock | None = None,
                 fault_plan=None, faults: FaultSchedule | None = None):
        self.profile = profile
        self.clock = clock or DEFAULT_CLOCK
        # model-clock mtimes: the (size, mtime) stat signature stays
        # deterministic across same-seed runs (see BlobDict._stamp)
        self.blobs = BlobDict(clock=self.clock)
        self.quota = TokenBucket(profile.quota_rate, profile.quota_burst, self.clock)
        #: shared fault-injection plan, replayed at API admission with
        #: op names "put"/"put_part"/"get"/"stat"/"list"/"delete"/
        #: "complete"/"checksum"/"copy" and the object key as the path
        self.faults = faults or FaultSchedule()
        if self.faults.clock is None:
            self.faults.clock = self.clock
        self._fault_plan = None
        if fault_plan is not None:
            self.fault_plan = fault_plan  # deprecation warning via setter
        self._op_index = 0
        self._fresh: dict[str, float] = {}  # key -> visible-at (virtual s)
        self._lock = threading.Lock()

    @property
    def fault_plan(self):
        """Deprecated ad-hoc hook ``callable(op, index) -> bool(fail?)``;
        use ``faults=FaultSchedule(...)`` instead."""
        return self._fault_plan

    @fault_plan.setter
    def fault_plan(self, fn) -> None:
        if fn is not None:
            warnings.warn(
                "CloudStorage.fault_plan is deprecated; compose a "
                "repro.core.faults.FaultSchedule and pass it as "
                "CloudStorage(faults=...) (or wrap any connector in "
                "FaultProxyConnector)", DeprecationWarning, stacklevel=2)
        self._fault_plan = fn

    # -- plumbing ---------------------------------------------------------
    def _admit(self, op: str, calls: int, link: Link,
               pipeline: "ApiPipeline | None" = None, key: str = "") -> None:
        with self._lock:
            self._op_index += 1
            idx = self._op_index
        if self._fault_plan is not None and self._fault_plan(op, idx):
            raise FaultInjected(f"{self.profile.provider}:{op}#{idx}")
        self.faults.check(op, key)
        wait = self.quota.try_acquire(calls)
        if wait > 0:
            raise RateLimitError(
                f"{self.profile.provider} API quota exceeded", retry_after=wait)
        if pipeline is not None:
            pipeline.charge(calls)
        else:
            link.round_trip(calls)
            self.clock.sleep(self.profile.api_latency * calls)

    def _mark_fresh(self, key: str) -> None:
        if self.profile.consistency_delay > 0:
            with self._lock:
                self._fresh[key] = (self.clock.virtual_elapsed
                                    + self.profile.consistency_delay)

    def _visible(self, key: str) -> bool:
        if self.profile.consistency_delay <= 0:
            return True
        with self._lock:
            t = self._fresh.get(key)
            if t is None or self.clock.virtual_elapsed >= t:
                self._fresh.pop(key, None)
                return True
            return False

    def _payload(self, link: Link, nbytes: int, streams: int) -> None:
        # Payload pays the slower of the network hop and the service's
        # internal media bandwidth.
        if nbytes <= 0:
            return
        link.transmit(nbytes, streams=streams)
        self.clock.sleep(nbytes / self.profile.intra_bw)

    # -- native API (boto3-ish) --------------------------------------------
    def api_put(self, key: str, data: bytes, link: Link, streams: int = 1,
                pipeline: "ApiPipeline | None" = None) -> None:
        self._admit("put", self.profile.put_calls, link, pipeline, key)
        self._payload(link, len(data), streams)
        self.blobs.put(key, data)
        self._mark_fresh(key)

    def api_put_range(self, key: str, offset: int, data: bytes, link: Link,
                      streams: int = 1,
                      pipeline: "ApiPipeline | None" = None) -> None:
        """One part of a multipart upload (1 call per part)."""
        self._admit("put_part", 1, link, pipeline, key)
        self._payload(link, len(data), streams)
        self.blobs.put_range(key, offset, data)
        self._mark_fresh(key)

    def api_complete_multipart(self, key: str, link: Link,
                               pipeline: "ApiPipeline | None" = None) -> None:
        self._admit("complete", 1, link, pipeline, key)

    def api_get(self, key: str, link: Link, offset: int = 0,
                length: int | None = None, streams: int = 1,
                pipeline: "ApiPipeline | None" = None) -> bytes:
        self._admit("get", self.profile.get_calls, link, pipeline, key)
        if not self.blobs.exists(key):
            raise NotFound(key)
        size = self.blobs.size(key)
        if length is None:
            length = size - offset
        data = self.blobs.get_range(key, offset, min(length, max(0, size - offset)))
        self._payload(link, len(data), streams)
        return data

    def api_stat(self, key: str, link: Link,
                 pipeline: "ApiPipeline | None" = None) -> StatInfo:
        self._admit("stat", 1, link, pipeline, key)
        if self.blobs.exists(key) and self._visible(key):
            return StatInfo(name=key, size=self.blobs.size(key),
                            mtime=self.blobs.mtime(key))
        objs, dirs = self.blobs.list_prefix(key)
        if objs or dirs or key == "":
            return StatInfo(name=key, size=0, mtime=0.0, is_dir=True)
        raise NotFound(key)

    def api_list(self, prefix: str, link: Link) -> tuple[list[str], list[str]]:
        self._admit("list", 1, link, key=prefix)
        objs, dirs = self.blobs.list_prefix(prefix)
        return [k for k in objs if self._visible(k)], dirs

    def api_delete(self, key: str, link: Link) -> None:
        self._admit("delete", 1, link, key=key)
        self.blobs.delete(key)

    def api_checksum(self, key: str, link: Link, algorithm: str) -> str:
        """Server-side checksum (beyond-paper optimization; real stores
        expose ETag/x-goog-hash/GetObjectAttributes).  Costs one control
        round-trip + a service-internal read — NO egress re-read, which
        is the §7/§8.2 integrity tax this eliminates."""
        self._admit("checksum", 1, link, key=key)
        data = self.blobs.get(key)
        self.clock.sleep(len(data) / self.profile.intra_bw)
        from ..core.integrity import hasher
        h = hasher(algorithm)
        h.update(data)
        return h.hexdigest()


class ApiPipeline:
    """A persistent connection keeping up to ``depth`` requests in
    flight against the provider frontend (HTTP pipelining — the same
    amortization GridFTP command pipelining gives the control channel,
    paper §5.3.2 / §8).  Round-trip latency and service-side processing
    overlap across the in-flight window, so each admitted call costs
    ~1/depth of the serial price.  Quota accounting is **not**
    amortized: providers meter API calls, not connections, so
    RateLimitError still fires exactly as it would per-call."""

    def __init__(self, storage: CloudStorage, link: Link, depth: int = 8):
        self.storage = storage
        self.link = link
        self.depth = max(1, depth)

    def charge(self, calls: int) -> None:
        self.storage.clock.sleep(
            (self.link.rtt + self.storage.profile.api_latency * calls)
            / self.depth)


def make_cloud(provider: str, clock: Clock | None = None,
               faults: FaultSchedule | None = None, **overrides) -> CloudStorage:
    prof = PROFILES[provider]
    if overrides:
        prof = replace(prof, **overrides)
    return CloudStorage(prof, clock=clock, faults=faults)


class ObjectStoreConnector(Connector):
    """Connector over a :class:`CloudStorage` native API (paper §4).

    ``placement="local"``: runs on an institution DTN; every API call
    crosses the WAN (Fig. 4).  ``placement="cloud"``: runs on a VM next
    to the storage; API calls are LAN-local and the WAN hop is handled
    by the GridFTP data channel (Fig. 5).
    """

    def __init__(self, storage: CloudStorage, placement: str = "local",
                 clock: Clock | None = None, part_size: int = 8 * MB,
                 server_checksum: bool = False, pipeline_depth: int = 8):
        self.storage = storage
        self.placement = placement
        self.clock = clock or storage.clock
        self.part_size = part_size
        self.server_checksum = server_checksum
        self.pipeline_depth = max(1, pipeline_depth)
        self.name = f"{storage.profile.provider}-conn-{placement}"
        self.credential_scheme = storage.profile.credential_scheme
        self.access_link = (lan_link(self.clock) if placement == "cloud"
                            else wan_link(self.clock))

    def checksum(self, session: Session, path: str, algorithm: str) -> str:
        if self.server_checksum:
            session.check()
            return self.storage.api_checksum(self._key(path),
                                             self.access_link, algorithm)
        return super().checksum(session, path, algorithm)

    # -- auth (paper Fig. 3) ----------------------------------------------
    def set_credential(self, session: Session, credential: Credential | None) -> None:
        if credential is None or credential.scheme != self.credential_scheme:
            raise AuthError(
                f"{self.name} requires credential scheme "
                f"{self.credential_scheme!r}, got "
                f"{credential.scheme if credential else None!r}")
        session.credential = credential

    @staticmethod
    def _key(path: str) -> str:
        return path.strip("/")

    # -- metadata ----------------------------------------------------------
    def stat(self, session: Session, path: str) -> StatInfo:
        session.check()
        return self.storage.api_stat(self._key(path), self.access_link)

    def listdir(self, session: Session, path: str):
        session.check()
        objs, dirs = self.storage.api_list(self._key(path), self.access_link)
        out = [StatInfo(name=k, size=self.storage.blobs.size(k),
                        mtime=self.storage.blobs.mtime(k)) for k in objs]
        out += [StatInfo(name=d, size=0, mtime=0.0, is_dir=True) for d in dirs]
        return out

    def command(self, session: Session, op: str, path: str, **kw) -> None:
        session.check()
        key = self._key(path)
        if op == "mkdir":
            return
        if op == "delete":
            self.storage.api_delete(key, self.access_link)
        elif op == "rename":
            to = self._key(kw["to"])
            if self.storage.blobs.exists(key):
                data = self.storage.api_get(key, self.access_link)
                self.storage.api_put(to, data, self.access_link)
                self.storage.api_delete(key, self.access_link)
                return
            # prefix rename = server-side copy per object (no data move
            # through the connector; one API call each)
            objs = [k for k in self.storage.blobs.keys()
                    if k.startswith(key + "/")]
            if not objs:
                raise NotFound(path)
            for k in objs:
                self._admit_copy(k)
                self.storage.blobs.put(to + k[len(key):],
                                       self.storage.blobs.get(k))
                self.storage.blobs.delete(k)
        else:
            raise NotFound(op)

    def _admit_copy(self, key: str) -> None:
        """Server-side COPY: control-plane cost only."""
        self.storage._admit("copy", 1, self.access_link, key=key)

    # -- data ----------------------------------------------------------------
    def send(self, session: Session, path: str, channel: AppChannel) -> None:
        session.check()
        key = self._key(path)
        size = self.storage.api_stat(key, self.access_link).size
        if hasattr(channel, "set_size"):
            channel.set_size(size)
        err: list[Exception] = []

        def worker() -> None:
            try:
                while not err:
                    rng = channel.get_read_range()
                    if rng is None or rng.offset >= size:
                        return
                    length = min(rng.length, size - rng.offset)
                    data = self.storage.api_get(key, self.access_link,
                                                offset=rng.offset, length=length)
                    channel.write(rng.offset, data)
            except Exception as e:
                err.append(e)

        self._pool(channel, worker)
        channel.finished(err[0] if err else None)
        if err:
            raise err[0]

    def recv(self, session: Session, path: str, channel: AppChannel) -> None:
        session.check()
        key = self._key(path)
        err: list[Exception] = []
        wrote = [False]

        def worker() -> None:
            try:
                while not err:
                    rng = channel.get_read_range()
                    if rng is None:
                        return
                    done = 0
                    while done < rng.length:
                        step = min(self.part_size, rng.length - done)
                        data = channel.read(rng.offset + done, step)
                        if not data:
                            return
                        # parts may land out of order -> multipart semantics
                        self.storage.api_put_range(key, rng.offset + done,
                                                   data, self.access_link)
                        wrote[0] = True
                        channel.bytes_written(rng.offset + done, len(data))
                        done += len(data)
            except Exception as e:
                err.append(e)
                try:  # wake sibling streams blocked on the channel
                    channel.finished(e)
                except Exception:
                    pass

        self._pool(channel, worker)
        if wrote[0] and not err:
            self.storage.api_complete_multipart(key, self.access_link)
        elif not err and not self.storage.blobs.exists(key):
            # nothing claimed = zero-byte target: a real store would
            # still create the (empty) object
            self.storage.api_put(key, b"", self.access_link)
        channel.finished(err[0] if err else None)
        if err:
            raise err[0]

    def _pool(self, channel: AppChannel, worker) -> None:
        cc = max(1, channel.get_concurrency())
        worker = bind_charge_owner(worker)
        threads = [threading.Thread(target=worker, daemon=True) for _ in range(cc)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    # -- bulk data plane ----------------------------------------------------
    def _batch_pipeline(self, n_files: int) -> ApiPipeline:
        # a pipeline can't be deeper than the requests actually in it
        return ApiPipeline(self.storage, self.access_link,
                           depth=min(self.pipeline_depth, max(1, n_files)))

    def send_batch(self, session: Session, paths, channel_factory) -> None:
        """Native batch Send: per-object stat + GET issued through one
        request pipeline (amortized admission), files spread over the
        session's shared worker pool."""
        session.check()
        paths = list(paths)
        pipeline = self._batch_pipeline(len(paths))

        def one(path: str, channel: AppChannel) -> None:
            try:
                key = self._key(path)
                size = self.storage.api_stat(key, self.access_link,
                                             pipeline=pipeline).size
                if hasattr(channel, "set_size"):
                    channel.set_size(size)
                while True:
                    rng = channel.get_read_range()
                    if rng is None or rng.offset >= size:
                        break
                    length = min(rng.length, size - rng.offset)
                    data = self.storage.api_get(key, self.access_link,
                                                offset=rng.offset, length=length,
                                                pipeline=pipeline)
                    channel.write(rng.offset, data)
                channel.finished(None)
            except Exception as e:
                channel.finished(e)

        self._dispatch_batch(session, paths, channel_factory, one,
                             pool_size=self.pipeline_depth)

    def recv_batch(self, session: Session, paths, channel_factory) -> None:
        """Native batch Recv: grouped small objects go up as pipelined
        single-shot PUTs (no per-object multipart complete); holey
        restarts fall back to pipelined part uploads."""
        session.check()
        paths = list(paths)
        pipeline = self._batch_pipeline(len(paths))

        def one(path: str, channel: AppChannel) -> None:
            try:
                key = self._key(path)
                parts: list[tuple[int, bytes]] = []
                while True:
                    rng = channel.get_read_range()
                    if rng is None:
                        break
                    done = 0
                    while done < rng.length:
                        step = min(self.part_size, rng.length - done)
                        data = channel.read(rng.offset + done, step)
                        if not data:
                            break
                        parts.append((rng.offset + done, data))
                        done += len(data)
                if not parts:  # nothing claimed: zero-byte target — still
                    # create the (empty) object, matching per-file recv
                    if not self.storage.blobs.exists(key):
                        self.storage.api_put(key, b"", self.access_link,
                                             pipeline=pipeline)
                    channel.finished(None)
                    return
                parts.sort()
                # single-shot PUT only for a complete fresh object: a
                # resumed upload may be filling a *prefix* hole, and a
                # whole-object PUT would truncate the tail already in
                # storage — those must go through ranged part uploads
                contiguous = parts[0][0] == 0 and all(
                    a + len(d) == b for (a, d), (b, _) in zip(parts, parts[1:]))
                if contiguous and not self.storage.blobs.exists(key):
                    self.storage.api_put(key, b"".join(d for _, d in parts),
                                         self.access_link, pipeline=pipeline)
                else:
                    for off, data in parts:
                        self.storage.api_put_range(key, off, data,
                                                   self.access_link,
                                                   pipeline=pipeline)
                    self.storage.api_complete_multipart(key, self.access_link,
                                                        pipeline=pipeline)
                for off, data in parts:
                    channel.bytes_written(off, len(data))
                channel.finished(None)
            except Exception as e:
                channel.finished(e)

        self._dispatch_batch(session, paths, channel_factory, one,
                             pool_size=self.pipeline_depth)


class NativeClient:
    """Two-party baseline: the user's own machine driving the provider
    SDK over the WAN (boto3/gsutil/Box SDK in the paper §5-§6)."""

    def __init__(self, storage: CloudStorage, clock: Clock | None = None,
                 startup_cost: float = 0.15):
        self.storage = storage
        self.clock = clock or storage.clock
        self.link = wan_link(self.clock)
        self.startup_cost = startup_cost  # login/session setup (paper §5.4)

    def login(self) -> None:
        self.clock.sleep(self.startup_cost)

    def upload_file(self, local_path: str, key: str) -> None:
        with open(local_path, "rb") as f:
            data = f.read()
        self.storage.api_put(key, data, self.link,
                             streams=self.storage.profile.native_put_streams)

    def upload_bytes(self, data: bytes, key: str) -> None:
        self.storage.api_put(key, data, self.link,
                             streams=self.storage.profile.native_put_streams)

    def download_bytes(self, key: str) -> bytes:
        return self.storage.api_get(
            key, self.link, streams=self.storage.profile.native_get_streams)

    def download_file(self, key: str, local_path: str) -> None:
        data = self.download_bytes(key)
        with open(local_path, "wb") as f:
            f.write(data)
