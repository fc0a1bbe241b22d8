"""The Connector abstraction (paper §3).

A copy of ``repro/core/connector.py``: the port imports nothing of ``repro``.

A Connector gives a managed data-transfer application uniform access to
one kind of storage system.  The interface reproduces the paper's
function set:

  interface functions (implemented by the Connector author):
    Start / Destroy / Stat / Command / Send / Recv / SetCredential

  helper functions (implemented by the application, handed to the
  Connector as an :class:`AppChannel`):
    read / write / get_concurrency / get_blocksize / get_read_range /
    bytes_written / finished

``Send`` reads data from the underlying storage system and writes it to
the application (download path); ``Recv`` reads from the application and
writes to storage (upload path).  The Connector author never talks to
the network — only to the AppChannel — exactly as in the paper: "This
API provides functions for reading and writing data to and from the
network.  The Connector author is not expected to know the details of
the application."

Bulk data plane (many-small-files regime, paper §5.3.2/§8)
----------------------------------------------------------
``send_batch`` / ``recv_batch`` move a *group* of files through one
call so a Connector can amortize per-file costs the per-file API cannot:
request pipelining on a persistent connection, grouped API admission,
and a reused session-level worker pool instead of a thread per file per
attempt.  The application hands over a ``channel_factory(path)`` that
returns the :class:`AppChannel` for each path (or ``None`` to skip it).
Per-file failures are *contained*: a batch implementation reports a
file's error through ``channel.finished(error)`` and keeps going, so
one bad file cannot abort its batch-mates.  The default implementation
simply falls back to per-file ``send``/``recv``, so every Connector
supports the bulk API from day one.
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Sequence

from .clock import bind_charge_owner
from .errors import SessionClosed


@dataclass(frozen=True)
class StatInfo:
    """Result of ``Stat`` (paper Fig. 2: mode/nlink/uid/gid/size/times)."""

    name: str
    size: int
    mtime: float
    is_dir: bool = False
    mode: int = 0o644
    nlink: int = 1
    uid: int = 0
    gid: int = 0
    etag: str | None = None  # object stores carry an etag / generation


@dataclass(frozen=True)
class ByteRange:
    """Half-open [offset, offset+length) byte range.

    ``get_read_range`` hands these to a Connector to support restart
    ("holey" transfers) and partial transfers (paper §3).
    """

    offset: int
    length: int

    @property
    def end(self) -> int:
        return self.offset + self.length


class AppChannel(ABC):
    """Application-side helper API handed to Send/Recv (paper §3)."""

    # -- data plane -----------------------------------------------------
    @abstractmethod
    def write(self, offset: int, data: bytes) -> None:
        """Connector -> application (used by Send). May arrive
        out-of-order across ranges; the application reassembles."""

    @abstractmethod
    def read(self, offset: int, length: int) -> bytes:
        """Application -> connector (used by Recv)."""

    # -- transfer-management hints ---------------------------------------
    @abstractmethod
    def get_concurrency(self) -> int:
        """How many outstanding reads/writes the Connector should keep in
        flight (paper: matches the number of parallel streams)."""

    @abstractmethod
    def get_blocksize(self) -> int:
        """Buffer size for each read/write exchange."""

    @abstractmethod
    def get_read_range(self) -> ByteRange | None:
        """Next byte range the application still needs, or None when the
        file is fully claimed.  Supports restart markers + holey
        transfers."""

    # -- progress / completion ------------------------------------------
    @abstractmethod
    def bytes_written(self, offset: int, length: int) -> None:
        """Connector calls this after each successful write to *storage*
        so the application can emit performance and restart markers."""

    def finished(self, error: Exception | None = None) -> None:  # optional
        """Connector signals completion of the Send/Recv operation."""


@dataclass
class Credential:
    """Opaque credential registered out-of-band (paper Fig. 3: creds go
    client -> GCS manager, never through the hosted service)."""

    scheme: str  # e.g. "local-user", "s3-keypair", "oauth2-token"
    data: dict = field(default_factory=dict)


class Session:
    """Per-access state threaded through all interface calls (paper:
    'Start ... set internal state that will be threaded through to all
    other function calls associated with this session')."""

    def __init__(self, connector: "Connector", credential: Credential | None):
        self.connector = connector
        self.credential = credential
        self.closed = False
        self.state: dict = {}
        self._lock = threading.Lock()

    def check(self) -> None:
        if self.closed:
            raise SessionClosed(f"session on {self.connector.name} is closed")

    def worker_pool(self, size: int) -> ThreadPoolExecutor:
        """Session-level worker pool reused by every batch operation on
        this session (instead of a thread per file per attempt).  Sized
        on first use; shut down by ``Connector.destroy``."""
        with self._lock:
            self.check()
            pool = self.state.get("_batch_pool")
            if pool is None:
                pool = ThreadPoolExecutor(
                    max_workers=max(1, size),
                    thread_name_prefix=f"{self.connector.name}-batch")
                self.state["_batch_pool"] = pool
            return pool

    # context-manager sugar
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.connector.destroy(self)


class Connector(ABC):
    """The pluggable storage interface (paper §3, Fig. 1).

    Implementations translate these calls into the native API of one
    storage system (POSIX syscalls, S3-style REST, Drive RPCs, ...).
    """

    #: human-readable storage-system name, e.g. "aws-s3"
    name: str = "abstract"
    #: credential scheme expected by SetCredential
    credential_scheme: str | None = None

    # -- lifecycle -------------------------------------------------------
    def start(self, credential: Credential | None = None) -> Session:
        session = Session(self, credential)
        self.set_credential(session, credential)
        self._start(session)
        return session

    def _start(self, session: Session) -> None:  # override for setup
        pass

    def destroy(self, session: Session) -> None:
        with session._lock:  # serialize against worker_pool creation
            pool = session.state.pop("_batch_pool", None)
            session.closed = True
            session.state.clear()
        if pool is not None:
            pool.shutdown(wait=True)

    def set_credential(self, session: Session, credential: Credential | None) -> None:
        """Validate/install a credential for this session.  Default
        accepts anything; cloud connectors override (paper Fig. 3)."""
        session.credential = credential

    # -- metadata --------------------------------------------------------
    @abstractmethod
    def stat(self, session: Session, path: str) -> StatInfo:
        ...

    @abstractmethod
    def listdir(self, session: Session, path: str) -> Sequence[StatInfo]:
        """Directory/prefix expansion — the transfer service uses this to
        expand recursive transfers (paper §2.2)."""

    @abstractmethod
    def command(self, session: Session, op: str, path: str, **kw) -> None:
        """Simple succeed/fail operations: mkdir, delete, rename (paper:
        'directory or object creation and permission changes')."""

    # -- data ------------------------------------------------------------
    @abstractmethod
    def send(self, session: Session, path: str, channel: AppChannel) -> None:
        """Read ``path`` from storage, write to the application."""

    @abstractmethod
    def recv(self, session: Session, path: str, channel: AppChannel) -> None:
        """Read from the application, write to storage at ``path``."""

    # -- bulk data plane --------------------------------------------------
    def send_batch(self, session: Session, paths: Sequence[str],
                   channel_factory: Callable[[str], AppChannel | None]) -> None:
        """Bulk ``send``: move every path through the data plane in one
        call.  ``channel_factory(path)`` returns the AppChannel for each
        path (``None`` skips it).  Per-file failures are contained —
        reported through ``channel.finished(error)`` — so one bad file
        never aborts the rest of the batch.  Default: per-file fallback;
        Connectors override to amortize per-file costs natively."""
        for path in paths:
            channel = channel_factory(path)
            if channel is None:
                continue
            try:
                self.send(session, path, channel)
            except Exception as e:
                channel.finished(e)

    def recv_batch(self, session: Session, paths: Sequence[str],
                   channel_factory: Callable[[str], AppChannel | None]) -> None:
        """Bulk ``recv`` — see :meth:`send_batch` for the contract."""
        for path in paths:
            channel = channel_factory(path)
            if channel is None:
                continue
            try:
                self.recv(session, path, channel)
            except Exception as e:
                channel.finished(e)

    #: worker-pool width for native batch implementations
    BATCH_POOL_SIZE = 8

    def _dispatch_batch(self, session: Session, paths: Sequence[str],
                        channel_factory, one,
                        pool_size: int | None = None) -> None:
        """Submit-and-collect loop shared by native batch paths: one
        ``one(path, channel)`` task per file on the session's pool.
        ``one`` must contain its own errors (report them through
        ``channel.finished``), so ``fut.result()`` never raises for a
        single bad file."""
        pool = session.worker_pool(pool_size or self.BATCH_POOL_SIZE)
        # the session pool is shared by every task on this session, so
        # the submitting task's charge owner is captured per work item —
        # a pool thread charges whichever task's file it is moving
        run = bind_charge_owner(one)
        futures = []
        for path in paths:
            channel = channel_factory(path)
            if channel is None:
                continue
            futures.append(pool.submit(run, path, channel))
        for fut in futures:
            fut.result()

    # -- optional capabilities -------------------------------------------
    def checksum(self, session: Session, path: str, algorithm: str) -> str:
        """Server-side checksum if the storage supports it; default reads
        through ``send`` (costing a re-read — the integrity-check cost
        the paper measures in §7)."""
        from .integrity import hasher  # local import to avoid cycle

        h = hasher(algorithm)
        sink = _ChecksumChannel(h, self.preferred_blocksize())
        self.send(session, path, sink)
        return h.hexdigest()

    def preferred_blocksize(self) -> int:
        return 1 << 20

    def supports_ranged_read(self) -> bool:
        return True

    # -- identity ----------------------------------------------------------
    def __repr__(self) -> str:  # pragma: no cover
        return f"<Connector {self.name}>"


class _ChecksumChannel(AppChannel):
    """Minimal AppChannel that folds Send output into a hash.

    Ranges are claimed sequentially; writes may still land out of order,
    so buffer and fold in order.
    """

    def __init__(self, h, blocksize: int):
        self._h = h
        self._bs = blocksize
        self._next_claim = 0
        self._fold_at = 0
        self._pending: dict[int, bytes] = {}
        self._size: int | None = None
        self._lock = threading.Lock()

    def set_size(self, size: int) -> None:
        self._size = size

    def write(self, offset: int, data: bytes) -> None:
        with self._lock:
            self._pending[offset] = data
            while self._fold_at in self._pending:
                chunk = self._pending.pop(self._fold_at)
                self._h.update(chunk)
                self._fold_at += len(chunk)

    def read(self, offset: int, length: int) -> bytes:
        raise NotImplementedError("checksum channel is read-only")

    def get_concurrency(self) -> int:
        return 1

    def get_blocksize(self) -> int:
        return self._bs

    def get_read_range(self) -> ByteRange | None:
        with self._lock:
            if self._size is not None and self._next_claim >= self._size:
                return None
            length = self._bs
            if self._size is not None:
                length = min(length, self._size - self._next_claim)
            rng = ByteRange(self._next_claim, length)
            self._next_claim += length
            return rng

    def bytes_written(self, offset: int, length: int) -> None:
        pass


def iter_files(connector: Connector, session: Session, path: str) -> Iterator[StatInfo]:
    """Recursive expansion of a directory/prefix into files, the way the
    managed service expands a folder transfer (paper §2.2)."""
    info = connector.stat(session, path)
    if not info.is_dir:
        yield info
        return
    stack: list[str] = [path]
    while stack:
        d = stack.pop()
        for child in connector.listdir(session, d):
            if child.is_dir:
                stack.append(child.name)
            else:
                yield child
