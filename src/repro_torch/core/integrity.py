"""End-to-end integrity checking (paper §7).

A copy of ``repro/core/integrity.py``: the port imports nothing of ``repro``.

"A client can verify transmission integrity by having a file read and a
checksum computed at the source before transmission and then reread and
a second checksum computed at the destination."

Algorithms:
  * sha256 / md5  — hashlib-backed, used for byte-stream transfers.
  * crc32c-ish    — zlib.crc32 wrapped in the same interface (fast path).
  * fletcher64    — a blocked Fletcher checksum over little-endian
    uint32 words.
  * lanesum32     — the host twin of the port's lanesum32 kernel
    (``repro_torch.kernels.checksum``), which digests each checkpoint
    leaf on the card before it leaves it; this hasher re-verifies those
    digests from the bytes in storage.
"""

from __future__ import annotations

import hashlib
import zlib


class _Crc32:
    name = "crc32"

    def __init__(self):
        self._v = 0

    def update(self, data: bytes) -> None:
        self._v = zlib.crc32(data, self._v)

    def hexdigest(self) -> str:
        return f"{self._v & 0xFFFFFFFF:08x}"


class _Fletcher64:
    """Pure-python reference of the blocked Fletcher checksum; matches
    ``repro.kernels.checksum.ref`` on little-endian uint32 words (tail
    zero-padded)."""

    name = "fletcher64"
    MOD = (1 << 32) - 1

    def __init__(self):
        self._a = 0
        self._b = 0
        self._tail = b""

    def update(self, data: bytes) -> None:
        data = self._tail + data
        n = len(data) // 4 * 4
        self._tail = data[n:]
        a, b = self._a, self._b
        for i in range(0, n, 4):
            w = int.from_bytes(data[i : i + 4], "little")
            a = (a + w) % self.MOD
            b = (b + a) % self.MOD
        self._a, self._b = a, b

    def hexdigest(self) -> str:
        a, b = self._a, self._b
        if self._tail:
            w = int.from_bytes(self._tail.ljust(4, b"\0"), "little")
            a = (a + w) % self.MOD
            b = (b + a) % self.MOD
        return f"{b:08x}{a:08x}"


class _LaneSum32:
    """Byte-stream twin of the lanesum32 kernel
    (``repro_torch.kernels.checksum``): little-endian uint32 words, a = sum w,
    b = sum (i+1)*w, both mod 2^32.  Lets the host side verify a digest
    that was computed on-device."""

    name = "lanesum32"
    MASK = 0xFFFFFFFF

    def __init__(self):
        self._a = 0
        self._b = 0
        self._i = 0  # 0-based word index
        self._tail = b""

    def _fold_words(self, data: bytes) -> None:
        import numpy as np
        w = np.frombuffer(data, dtype="<u4").astype(np.uint64)
        n = w.size
        if n == 0:
            return
        idx = (np.arange(self._i + 1, self._i + n + 1, dtype=np.uint64)
               & self.MASK)
        self._a = (self._a + int(w.sum() % (1 << 32))) & self.MASK
        self._b = (self._b + int((w * idx % (1 << 32)).sum() % (1 << 32))) \
            & self.MASK
        self._i += n

    def update(self, data: bytes) -> None:
        data = self._tail + data
        n = len(data) // 4 * 4
        self._tail = data[n:]
        self._fold_words(data[:n])

    def hexdigest(self) -> str:
        a, b, i = self._a, self._b, self._i
        if self._tail:
            w = int.from_bytes(self._tail.ljust(4, b"\0"), "little")
            a = (a + w) & self.MASK
            b = (b + ((i + 1) & self.MASK) * w) & self.MASK
        return f"{b:08x}{a:08x}"


def hasher(algorithm: str):
    if algorithm in ("sha256", "md5", "sha1"):
        return hashlib.new(algorithm)
    if algorithm == "crc32":
        return _Crc32()
    if algorithm == "fletcher64":
        return _Fletcher64()
    if algorithm == "lanesum32":
        return _LaneSum32()
    raise ValueError(f"unknown checksum algorithm: {algorithm}")


def checksum_bytes(data: bytes, algorithm: str = "sha256") -> str:
    h = hasher(algorithm)
    h.update(data)
    return h.hexdigest()
