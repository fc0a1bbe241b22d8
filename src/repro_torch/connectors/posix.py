"""POSIX Connector — the paper's first and reference implementation
(Fig. 2).  A copy of ``repro/connectors/posix.py``.  Translates the Connector interface onto open/read/write/stat
against a real filesystem subtree.

Bulk path: ``send_batch``/``recv_batch`` stream each file on the
session's shared worker pool (one pool per session, threads reused
across files and attempts) instead of spawning ``concurrency`` fresh
threads per file the way the per-file path must; directory listings use
``os.scandir`` so each entry's stat comes from the directory read
itself rather than a second syscall per child."""

from __future__ import annotations

import os
import shutil
import threading

from ..core.clock import bind_charge_owner
from ..core.connector import AppChannel, ByteRange, Connector, Session, StatInfo
from ..core.errors import NotFound, PermanentError


class PosixConnector(Connector):
    name = "posix"
    credential_scheme = "local-user"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    # -- path safety -----------------------------------------------------
    def _abs(self, path: str) -> str:
        p = os.path.abspath(os.path.join(self.root, path.lstrip("/")))
        if not (p == self.root or p.startswith(self.root + os.sep)):
            raise PermanentError(f"path escapes connector root: {path}")
        return p

    def _rel(self, abspath: str) -> str:
        return os.path.relpath(abspath, self.root)

    # -- metadata --------------------------------------------------------
    def stat(self, session: Session, path: str) -> StatInfo:
        session.check()
        p = self._abs(path)
        try:
            st = os.stat(p)
        except FileNotFoundError:
            raise NotFound(path) from None
        return StatInfo(
            name=path,
            size=st.st_size,
            mtime=st.st_mtime,
            is_dir=os.path.isdir(p),
            mode=st.st_mode & 0o777,
            nlink=st.st_nlink,
            uid=st.st_uid,
            gid=st.st_gid,
        )

    def listdir(self, session: Session, path: str):
        session.check()
        p = self._abs(path)
        if not os.path.isdir(p):
            raise NotFound(path)
        out = []
        with os.scandir(p) as it:
            for entry in sorted(it, key=lambda e: e.name):
                st = entry.stat()
                out.append(
                    StatInfo(
                        name=os.path.join(path, entry.name)
                        if path not in (".", "") else entry.name,
                        size=st.st_size,
                        mtime=st.st_mtime,
                        is_dir=entry.is_dir(),
                        mode=st.st_mode & 0o777,
                    )
                )
        return out

    def command(self, session: Session, op: str, path: str, **kw) -> None:
        session.check()
        p = self._abs(path)
        if op == "mkdir":
            os.makedirs(p, exist_ok=True)
        elif op == "delete":
            if os.path.isdir(p):
                shutil.rmtree(p)
            elif os.path.exists(p):
                os.remove(p)
            else:
                raise NotFound(path)
        elif op == "rename":
            dst = self._abs(kw["to"])
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            os.replace(p, dst)
        elif op == "chmod":
            os.chmod(p, kw["mode"])
        else:
            raise PermanentError(f"unknown command {op!r}")

    # -- data ------------------------------------------------------------
    def _send_stream(self, p: str, size: int, channel: AppChannel) -> None:
        """One claim-read-write stream (one open handle per stream)."""
        with open(p, "rb") as f:
            while True:
                rng = channel.get_read_range()
                if rng is None or rng.offset >= size:
                    return
                length = min(rng.length, size - rng.offset)
                f.seek(rng.offset)
                data = f.read(length)
                channel.write(rng.offset, data)

    def _recv_stream(self, f, lock, bs: int, channel: AppChannel) -> None:
        """One claim-read-write stream into an open positional handle."""
        while True:
            rng = channel.get_read_range()
            if rng is None:
                return
            done = 0
            while done < rng.length:
                step = min(bs, rng.length - done)
                data = channel.read(rng.offset + done, step)
                if not data:
                    return
                if lock is not None:
                    with lock:
                        f.seek(rng.offset + done)
                        f.write(data)
                else:
                    f.seek(rng.offset + done)
                    f.write(data)
                channel.bytes_written(rng.offset + done, len(data))
                done += len(data)

    def send(self, session: Session, path: str, channel: AppChannel) -> None:
        session.check()
        p = self._abs(path)
        try:
            size = os.path.getsize(p)
        except OSError:
            raise NotFound(path) from None
        if hasattr(channel, "set_size"):
            channel.set_size(size)
        cc = max(1, channel.get_concurrency())
        err: list[Exception] = []

        def worker() -> None:
            try:
                self._send_stream(p, size, channel)
            except Exception as e:  # pragma: no cover - surfaced below
                err.append(e)

        threads = [threading.Thread(target=bind_charge_owner(worker),
                                    daemon=True) for _ in range(cc)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        channel.finished(err[0] if err else None)
        if err:
            raise err[0]

    def _open_recv(self, path: str):
        p = self._abs(path)
        os.makedirs(os.path.dirname(p) or self.root, exist_ok=True)
        # Pre-create / truncate once, then positional writes (supports
        # out-of-order + holey restart writes).
        with open(p, "ab"):
            pass
        return open(p, "r+b")

    def recv(self, session: Session, path: str, channel: AppChannel) -> None:
        session.check()
        bs = channel.get_blocksize()
        lock = threading.Lock()
        err: list[Exception] = []
        f = self._open_recv(path)

        def worker() -> None:
            try:
                self._recv_stream(f, lock, bs, channel)
            except Exception as e:
                err.append(e)
                try:  # wake sibling streams blocked on the channel
                    channel.finished(e)
                except Exception:
                    pass

        cc = max(1, channel.get_concurrency())
        threads = [threading.Thread(target=bind_charge_owner(worker),
                                    daemon=True) for _ in range(cc)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        f.flush()
        os.fsync(f.fileno())
        f.close()
        channel.finished(err[0] if err else None)
        if err:
            raise err[0]

    # -- bulk data plane --------------------------------------------------
    def send_batch(self, session: Session, paths, channel_factory) -> None:
        """Native batch Send: one single-stream task per file on the
        session's shared pool (threads reused across files/attempts);
        errors contained per file via ``channel.finished``."""
        session.check()

        def one(path: str, channel: AppChannel) -> None:
            try:
                p = self._abs(path)
                try:
                    size = os.path.getsize(p)
                except OSError:
                    raise NotFound(path) from None
                if hasattr(channel, "set_size"):
                    channel.set_size(size)
                self._send_stream(p, size, channel)
                channel.finished(None)
            except Exception as e:
                channel.finished(e)

        self._dispatch_batch(session, paths, channel_factory, one)

    def recv_batch(self, session: Session, paths, channel_factory) -> None:
        """Native batch Recv — single stream + private handle per file,
        no cross-stream handle lock needed."""
        session.check()

        def one(path: str, channel: AppChannel) -> None:
            try:
                f = self._open_recv(path)
                try:
                    self._recv_stream(f, None, channel.get_blocksize(), channel)
                    f.flush()
                    os.fsync(f.fileno())
                finally:
                    f.close()
                channel.finished(None)
            except Exception as e:
                channel.finished(e)

        self._dispatch_batch(session, paths, channel_factory, one)
