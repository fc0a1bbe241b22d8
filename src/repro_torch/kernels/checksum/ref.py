"""Plain versions of the lanesum32 checksum.

``lanesum32_torch`` is the plain PyTorch version of the Hopper kernel: the
CPU path of ``ops.checksum_digests`` and the kernel's yardstick on the card.
``lanesum32_ref`` and ``digest_ref`` are the port's copy of the numpy oracle
``repro/kernels/checksum/ref.py`` (same results; it runs over chunks of
words, so a buffer of gigabytes needs no more than a few chunks of host
memory at a time).

The checksum reads a buffer as little-endian uint32 words ``w_i``, the tail
zero-padded to 4 bytes: ``a = Σ w_i`` and ``b = Σ (i+1)·w_i``, both mod
2^32, and the digest is ``f"{b:08x}{a:08x}"``.
"""

from __future__ import annotations

import numpy as np
import torch

MOD = 1 << 32
MASK = MOD - 1
#: words per chunk of the plain versions
CHUNK_WORDS = 1 << 24


def digest_of(a: int, b: int) -> str:
    return f"{b & MASK:08x}{a & MASK:08x}"


def _byte_words(b8: torch.Tensor) -> torch.Tensor:
    """1-D uint8 -> int64 little-endian words, the tail zero-padded."""
    pad = (-b8.numel()) % 4
    if pad:
        b8 = torch.cat([b8, b8.new_zeros(pad)])
    w = b8.reshape(-1, 4).to(torch.int64)
    return w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)


def lanesum32_torch(x: torch.Tensor) -> tuple[int, int]:
    """(a, b) of the row-major bytes of ``x`` (any dtype, any layout), on
    ``x``'s device, in int64 arithmetic masked to 32 bits."""
    b8 = x.contiguous().reshape(-1).view(torch.uint8)
    a = b = 0
    step = 4 * CHUNK_WORDS
    for start in range(0, b8.numel(), step):
        w = _byte_words(b8[start:start + step])
        i1 = torch.arange(start // 4 + 1, start // 4 + 1 + w.numel(),
                          dtype=torch.int64, device=w.device) & MASK
        # w·(i+1) mod 2^32 without overflowing int64: split i+1 at bit 16
        wi = (w * (i1 & 0xFFFF) + (((w * (i1 >> 16)) & 0xFFFF) << 16)) & MASK
        a = (a + int(w.sum())) & MASK
        b = (b + int(wi.sum())) & MASK
    return a, b


def lanesum32_ref(words) -> tuple[int, int]:
    """words: 1-D int32/uint32 array.  Returns (a, b) ints mod 2^32."""
    words = np.asarray(words).reshape(-1)
    a = b = 0
    for start in range(0, words.size, CHUNK_WORDS):
        w = words[start:start + CHUNK_WORDS].astype(np.uint64) & 0xFFFFFFFF
        idx = np.arange(start + 1, start + 1 + w.size, dtype=np.uint64) & 0xFFFFFFFF
        a = (a + int(w.sum() % MOD)) % MOD
        b = (b + int((w * idx % MOD).sum() % MOD)) % MOD
    return a, b


def digest_ref(data) -> str:
    """Byte-stream variant (little-endian words, zero-padded tail)."""
    data = bytes(data)
    pad = (-len(data)) % 4
    w = np.frombuffer(data + b"\0" * pad, dtype="<u4")
    a, b = lanesum32_ref(w)
    return digest_of(a, b)
