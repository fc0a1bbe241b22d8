"""Byte-level helpers over the Connector interface.

A copy of ``repro/ckpt/io.py``.

The checkpoint layer and data pipeline talk to storage exclusively
through Connector Send/Recv (paper §3) — these helpers adapt in-memory
buffers to the AppChannel protocol.
"""

from __future__ import annotations

import threading

from ..core.connector import AppChannel, ByteRange, Connector, Session


class BytesSource(AppChannel):
    """Feeds Recv (upload) from an in-memory buffer."""

    def __init__(self, payload: bytes, blocksize: int = 1 << 22,
                 concurrency: int = 2):
        self.payload = payload
        self.bs = blocksize
        self.cc = concurrency
        self._claim = 0
        self._lock = threading.Lock()
        self.bytes_done = 0

    def write(self, offset, data):
        raise NotImplementedError

    def read(self, offset, length):
        return self.payload[offset:offset + length]

    def get_concurrency(self):
        return self.cc

    def get_blocksize(self):
        return self.bs

    def get_read_range(self):
        with self._lock:
            if self._claim >= len(self.payload):
                return None
            ln = min(self.bs, len(self.payload) - self._claim)
            rng = ByteRange(self._claim, ln)
            self._claim += ln
            return rng

    def bytes_written(self, offset, length):
        with self._lock:
            self.bytes_done += length

    def finished(self, error=None):
        pass


class BytesSink(AppChannel):
    """Collects Send (download) output, optionally a sub-range."""

    def __init__(self, blocksize: int = 1 << 22, concurrency: int = 2,
                 offset: int = 0, length: int | None = None):
        self.bs = blocksize
        self.cc = concurrency
        self._start = offset
        self._want = length
        self._claim = offset
        self._size = None
        self._blocks: dict[int, bytes] = {}
        self._lock = threading.Lock()

    def set_size(self, size):
        self._size = size

    def _end(self):
        if self._want is None:
            return self._size if self._size is not None else float("inf")
        return self._start + self._want

    def write(self, offset, data):
        with self._lock:
            self._blocks[offset] = data

    def read(self, offset, length):
        raise NotImplementedError

    def get_concurrency(self):
        return self.cc

    def get_blocksize(self):
        return self.bs

    def get_read_range(self):
        with self._lock:
            end = self._end()
            if self._claim >= end:
                return None
            ln = int(min(self.bs, end - self._claim))
            rng = ByteRange(self._claim, ln)
            self._claim += ln
            return rng

    def bytes_written(self, offset, length):
        pass

    def finished(self, error=None):
        self.error = error

    def data(self) -> bytes:
        out = b"".join(self._blocks[o] for o in sorted(self._blocks))
        if self._want is not None:
            out = out[:self._want]
        return out


def put_bytes(connector: Connector, session: Session, path: str,
              payload: bytes, concurrency: int = 2) -> None:
    connector.recv(session, path, BytesSource(payload,
                                              concurrency=concurrency))


def get_bytes(connector: Connector, session: Session, path: str,
              offset: int = 0, length: int | None = None,
              concurrency: int = 2) -> bytes:
    sink = BytesSink(offset=offset, length=length, concurrency=concurrency)
    connector.send(session, path, sink)
    return sink.data()


def delete_path(connector: Connector, session: Session, path: str) -> None:
    connector.command(session, "delete", path)
