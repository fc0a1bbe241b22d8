"""Fault-proxy Connector: chaos injection for *any* storage backend.

A copy of ``repro/connectors/faultproxy.py``: the port imports nothing of ``repro``.

:class:`FaultProxyConnector` wraps an inner :class:`Connector` and
delegates every interface call — ``stat`` / ``listdir`` / ``command`` /
``send`` / ``recv`` / ``send_batch`` / ``recv_batch`` / ``checksum`` /
session lifecycle — after admitting it through a
:class:`~repro_torch.core.faults.FaultSchedule`.  Unlike the old ad-hoc
``CloudStorage.fault_plan`` hook (which could only fail emulated cloud
API calls), the proxy makes the same composable failure plan work
against posix, memory, cloud, or any future connector, because it
attacks the *interface*, not one implementation.

Where each fault kind lands
---------------------------
* control-plane kinds (transient / rate-limit / session-drop / latency)
  fire at op admission, plus per-block on the pseudo-ops ``read`` (data
  flowing into storage on the recv side) and ``write`` (data flowing out
  of storage on the send side), so mid-stream failures hit after real
  progress has been made and restart markers matter;
* data-plane kinds (``bit_flip``, ``truncate``) are applied to blocks a
  destination connector reads from the application — i.e. bytes about to
  be *written to storage*.  Corrupting the send side instead would also
  corrupt the service's streaming source checksum and turn the fault
  into silent, undetectable corruption; flipping the storage-bound copy
  is exactly the §7 scenario that end-to-end integrity catches.

``destroy`` is deliberately never faulted, so session teardown (worker
pools, file handles) always runs and a chaos run can't leak resources.

The proxy is transparent: unknown attributes (``location``,
``placement``, ``storage``, ``store``, ``root``, ...) forward to the
inner connector, so link selection and test helpers keep working.
"""

from __future__ import annotations

from ..core.clock import DEFAULT_CLOCK
from ..core.connector import (AppChannel, ByteRange, Connector, Credential,
                              Session, StatInfo)
from ..core.faults import FaultSchedule, StreamFaults


class _ChaosRecvChannel(AppChannel):
    """Wraps the recv-side AppChannel: per-block ``read`` admission plus
    this attempt's data directives (bit-flip / truncate)."""

    def __init__(self, inner: AppChannel, schedule: FaultSchedule,
                 path: str, stream: StreamFaults):
        self._inner = inner
        self._schedule = schedule
        self._path = path
        self._stream = stream
        self._cut = False

    def write(self, offset: int, data: bytes) -> None:
        self._inner.write(offset, data)

    def read(self, offset: int, length: int) -> bytes:
        self._schedule.check("read", self._path)
        if self._cut:
            return b""
        data = self._inner.read(offset, length)
        out = self._stream.filter(offset, data)
        if data and not out:
            # the stream was cut: stop consuming, or positional readers
            # (length-driven loops) would mis-sequence later blocks
            self._cut = True
        elif out is not data and len(out) < len(data):
            self._cut = True  # truncated mid-block: deliver tail of nothing
        return out

    def get_concurrency(self) -> int:
        return self._inner.get_concurrency()

    def get_blocksize(self) -> int:
        return self._inner.get_blocksize()

    def get_read_range(self) -> ByteRange | None:
        if self._cut:
            return None
        return self._inner.get_read_range()

    def bytes_written(self, offset: int, length: int) -> None:
        self._inner.bytes_written(offset, length)

    def finished(self, error: Exception | None = None) -> None:
        self._inner.finished(error)


class _ChaosSendChannel(AppChannel):
    """Wraps the send-side AppChannel: per-block ``write`` admission.
    No data mutation here — see the module docstring."""

    def __init__(self, inner: AppChannel, schedule: FaultSchedule, path: str):
        self._inner = inner
        self._schedule = schedule
        self._path = path

    def set_size(self, size: int) -> None:
        fn = getattr(self._inner, "set_size", None)
        if fn is not None:
            fn(size)

    def write(self, offset: int, data: bytes) -> None:
        self._schedule.check("write", self._path)
        self._inner.write(offset, data)

    def read(self, offset: int, length: int) -> bytes:
        return self._inner.read(offset, length)

    def get_concurrency(self) -> int:
        return self._inner.get_concurrency()

    def get_blocksize(self) -> int:
        return self._inner.get_blocksize()

    def get_read_range(self) -> ByteRange | None:
        return self._inner.get_read_range()

    def bytes_written(self, offset: int, length: int) -> None:
        self._inner.bytes_written(offset, length)

    def finished(self, error: Exception | None = None) -> None:
        self._inner.finished(error)


class FaultProxyConnector(Connector):
    """Wrap ``inner`` so every op replays ``schedule`` faults first.

    Sessions are the inner connector's own sessions, so wrapped and bare
    access can share state and ``Session.check`` semantics carry over.
    """

    def __init__(self, inner: Connector, schedule: FaultSchedule,
                 clock=None):
        self.inner = inner
        self.schedule = schedule
        self.name = f"chaos[{inner.name}]"
        self.credential_scheme = inner.credential_scheme
        if schedule.clock is None:
            schedule.clock = clock or getattr(inner, "clock", None) \
                or DEFAULT_CLOCK

    # -- transparency -----------------------------------------------------
    def __getattr__(self, item):
        # only consulted for attributes not found on the proxy itself:
        # location/placement/storage/store/root/... forward to the inner
        # connector so link inference and test helpers see through us
        return getattr(self.inner, item)

    # -- lifecycle --------------------------------------------------------
    def start(self, credential: Credential | None = None) -> Session:
        self.schedule.check("start", self.inner.name)
        return self.inner.start(credential)

    def destroy(self, session: Session) -> None:
        self.inner.destroy(session)  # never faulted: cleanup must run

    def set_credential(self, session: Session,
                       credential: Credential | None) -> None:
        self.inner.set_credential(session, credential)

    # -- metadata ---------------------------------------------------------
    def stat(self, session: Session, path: str) -> StatInfo:
        self.schedule.check("stat", path)
        return self.inner.stat(session, path)

    def listdir(self, session: Session, path: str):
        self.schedule.check("listdir", path)
        return self.inner.listdir(session, path)

    def command(self, session: Session, op: str, path: str, **kw) -> None:
        self.schedule.check("command", path)
        self.inner.command(session, op, path, **kw)

    # -- data -------------------------------------------------------------
    def send(self, session: Session, path: str, channel: AppChannel) -> None:
        self.schedule.check("send", path)
        self.inner.send(session, path,
                        _ChaosSendChannel(channel, self.schedule, path))

    def recv(self, session: Session, path: str, channel: AppChannel) -> None:
        self.schedule.check("recv", path)
        self.inner.recv(session, path, self._wrap_recv(path, channel))

    def _wrap_recv(self, path: str, channel: AppChannel) -> AppChannel:
        stream = self.schedule.data_plan("recv", path)
        return _ChaosRecvChannel(channel, self.schedule, path, stream)

    # -- bulk data plane --------------------------------------------------
    def send_batch(self, session: Session, paths, channel_factory) -> None:
        paths = list(paths)
        self.schedule.check("send_batch", paths[0] if paths else "")

        def factory(path: str):
            ch = channel_factory(path)
            if ch is None:
                return None
            return _ChaosSendChannel(ch, self.schedule, path)

        self.inner.send_batch(session, paths, factory)

    def recv_batch(self, session: Session, paths, channel_factory) -> None:
        paths = list(paths)
        self.schedule.check("recv_batch", paths[0] if paths else "")

        def factory(path: str):
            ch = channel_factory(path)
            if ch is None:
                return None
            return self._wrap_recv(path, ch)

        self.inner.recv_batch(session, paths, factory)

    # -- optional capabilities --------------------------------------------
    def checksum(self, session: Session, path: str, algorithm: str) -> str:
        self.schedule.check("checksum", path)
        return self.inner.checksum(session, path, algorithm)

    def preferred_blocksize(self) -> int:
        return self.inner.preferred_blocksize()

    def supports_ranged_read(self) -> bool:
        return self.inner.supports_ranged_read()

    def __repr__(self) -> str:  # pragma: no cover
        return f"<FaultProxyConnector over {self.inner!r}>"
