"""In-memory Connector — zero-latency storage for unit tests and as the
blob backend for emulated cloud stores.

A copy of ``repro/connectors/memory.py``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

import threading

from ..core.clock import Clock
from ..core.connector import AppChannel, Connector, Session, StatInfo
from ..core.errors import NotFound, PermanentError


class BlobDict:
    """Flat object namespace with '/'-separated pseudo-directories.

    Mtimes are **model-deterministic** (contract R001): stamped from
    the injected model :class:`Clock` when one is given, blended with a
    strictly-increasing per-store tick so two writes in the same model
    instant (zero-latency stores at time scale 0) still get distinct,
    ordered stamps.  Same-seed runs therefore produce identical
    ``(size, mtime)`` stat signatures — which is what keeps the replica
    catalog's staleness check (and the marker journal's ``src_sig``
    guard) reproducible instead of poisoned by wall time.
    """

    #: mtime granularity of the per-write tick (~1 microsecond of model
    #: time; fine enough to never mask a clock advance, coarse enough
    #: to survive float addition exactly over millions of writes)
    TICK = 2.0 ** -20

    def __init__(self, clock: Clock | None = None):
        self._objs: dict[str, bytearray] = {}
        self._mtime: dict[str, float] = {}
        self._clock = clock
        self._last_stamp = 0.0
        self.lock = threading.RLock()

    def _stamp(self) -> float:
        """Next mtime (caller holds the lock): model clock if injected
        (monotonic per-store counter fallback), strictly increasing."""
        base = 0.0 if self._clock is None else self._clock.virtual_elapsed
        self._last_stamp = max(base, self._last_stamp + self.TICK)
        return self._last_stamp

    def put_range(self, key: str, offset: int, data: bytes) -> None:
        with self.lock:
            buf = self._objs.setdefault(key, bytearray())
            if len(buf) < offset + len(data):
                buf.extend(b"\0" * (offset + len(data) - len(buf)))
            buf[offset : offset + len(data)] = data
            self._mtime[key] = self._stamp()

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        with self.lock:
            if key not in self._objs:
                raise NotFound(key)
            return bytes(self._objs[key][offset : offset + length])

    def put(self, key: str, data: bytes) -> None:
        with self.lock:
            self._objs[key] = bytearray(data)
            self._mtime[key] = self._stamp()

    def get(self, key: str) -> bytes:
        with self.lock:
            if key not in self._objs:
                raise NotFound(key)
            return bytes(self._objs[key])

    def delete(self, key: str) -> None:
        with self.lock:
            if key in self._objs:
                del self._objs[key]
                del self._mtime[key]
                return
            # prefix (directory) delete
            doomed = [k for k in self._objs if k.startswith(key.rstrip("/") + "/")]
            if not doomed:
                raise NotFound(key)
            for k in doomed:
                del self._objs[k]
                del self._mtime[k]

    def size(self, key: str) -> int:
        with self.lock:
            if key not in self._objs:
                raise NotFound(key)
            return len(self._objs[key])

    def mtime(self, key: str) -> float:
        with self.lock:
            return self._mtime.get(key, 0.0)

    def exists(self, key: str) -> bool:
        with self.lock:
            return key in self._objs

    def keys(self) -> list[str]:
        with self.lock:
            return sorted(self._objs)

    def list_prefix(self, prefix: str) -> tuple[list[str], list[str]]:
        """Returns (objects, common-prefixes) one level below prefix —
        S3 ListObjectsV2 delimiter semantics."""
        prefix = prefix.strip("/")
        pfx = prefix + "/" if prefix else ""
        with self.lock:
            objs, dirs = [], set()
            for k in sorted(self._objs):
                if not k.startswith(pfx):
                    continue
                rest = k[len(pfx):]
                if "/" in rest:
                    dirs.add(pfx + rest.split("/", 1)[0])
                else:
                    objs.append(k)
            return objs, sorted(dirs)


class MemoryConnector(Connector):
    name = "memory"

    def __init__(self, store: BlobDict | None = None,
                 clock: Clock | None = None):
        self.store = store or BlobDict(clock=clock)

    @staticmethod
    def _key(path: str) -> str:
        return path.strip("/")

    def stat(self, session: Session, path: str) -> StatInfo:
        session.check()
        key = self._key(path)
        if self.store.exists(key):
            return StatInfo(name=path, size=self.store.size(key),
                            mtime=self.store.mtime(key))
        objs, dirs = self.store.list_prefix(key)
        if objs or dirs or key == "":
            return StatInfo(name=path, size=0, mtime=0.0, is_dir=True)
        raise NotFound(path)

    def listdir(self, session: Session, path: str):
        session.check()
        key = self._key(path)
        objs, dirs = self.store.list_prefix(key)
        if not objs and not dirs and key and not self.store.exists(key):
            raise NotFound(path)
        out = [StatInfo(name=k, size=self.store.size(k), mtime=self.store.mtime(k))
               for k in objs]
        out += [StatInfo(name=d, size=0, mtime=0.0, is_dir=True) for d in dirs]
        return out

    def command(self, session: Session, op: str, path: str, **kw) -> None:
        session.check()
        key = self._key(path)
        if op == "mkdir":
            return  # flat namespace: directories are implicit
        if op == "delete":
            self.store.delete(key)
        elif op == "rename":
            to = self._key(kw["to"])
            if self.store.exists(key):
                self.store.put(to, self.store.get(key))
                self.store.delete(key)
                return
            # prefix (directory) rename
            moved = False
            for k in self.store.keys():
                if k.startswith(key + "/"):
                    self.store.put(to + k[len(key):], self.store.get(k))
                    self.store.delete(k)
                    moved = True
            if not moved:
                raise NotFound(path)
        else:
            raise PermanentError(f"unknown command {op!r}")

    def send(self, session: Session, path: str, channel: AppChannel) -> None:
        session.check()
        key = self._key(path)
        size = self.store.size(key)
        if hasattr(channel, "set_size"):
            channel.set_size(size)
        while True:
            rng = channel.get_read_range()
            if rng is None or rng.offset >= size:
                break
            length = min(rng.length, size - rng.offset)
            channel.write(rng.offset, self.store.get_range(key, rng.offset, length))
        channel.finished(None)

    def recv(self, session: Session, path: str, channel: AppChannel) -> None:
        session.check()
        key = self._key(path)
        # materialize the object up front (posix pre-creates the file the
        # same way) so a zero-byte transfer still produces an object
        self.store.put_range(key, 0, b"")
        bs = channel.get_blocksize()
        while True:
            rng = channel.get_read_range()
            if rng is None:
                break
            done = 0
            while done < rng.length:
                step = min(bs, rng.length - done)
                data = channel.read(rng.offset + done, step)
                if not data:
                    break
                self.store.put_range(key, rng.offset + done, data)
                channel.bytes_written(rng.offset + done, len(data))
                done += len(data)
        channel.finished(None)

    # -- bulk data plane --------------------------------------------------
    # Zero-latency storage: batching buys file-level overlap on the
    # session pool, nothing more.  Dispatch stays on self.send/self.recv
    # so subclasses that wrap the per-file path keep working.
    def _batch(self, session: Session, paths, channel_factory, op) -> None:
        session.check()

        def one(path: str, channel: AppChannel) -> None:
            try:
                op(session, path, channel)
            except Exception as e:
                channel.finished(e)

        self._dispatch_batch(session, paths, channel_factory, one)

    def send_batch(self, session: Session, paths, channel_factory) -> None:
        self._batch(session, paths, channel_factory, self.send)

    def recv_batch(self, session: Session, paths, channel_factory) -> None:
        self._batch(session, paths, channel_factory, self.recv)
