"""Connector-backed training data pipeline.

A copy of ``repro/data/pipeline.py`` (numpy only) over the port's
Connector and ``ckpt.io``.

Tokenized shards are fixed-record binary objects behind a Connector
(paper §3): each host session reads only its slice using ranged reads —
the ``get_read_range`` machinery — so the same code path serves POSIX
scratch, the emulated cloud stores, or anything else with a Connector.

Features needed at 1000-node scale:
* deterministic host sharding: shard s belongs to host (s mod n_hosts),
* resumable: iterator state is (epoch, shard_cursor, record_cursor) and
  round-trips through the train checkpoint,
* background prefetch (double buffering) with a bounded queue,
* straggler mitigation: hedged reads — if a shard read exceeds
  ``hedge_factor`` x the trailing-median latency, a second request
  goes out (to the replica connector when configured) and the first
  response wins (paper §2.2's retry machinery, applied to reads).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..core.connector import Connector, Credential
from ..ckpt.io import get_bytes, put_bytes

RECORD_DTYPE = np.int32


@dataclass
class DataPipelineConfig:
    seq_len: int = 1024
    batch_size: int = 8            # per-host sequences per step
    host_id: int = 0
    n_hosts: int = 1
    prefetch: int = 2
    seed: int = 0
    hedge_factor: float = 4.0
    hedge_min_samples: int = 8


class TokenShardWriter:
    """Writes fixed-length token records as shard objects."""

    def __init__(self, connector: Connector, base: str, seq_len: int,
                 records_per_shard: int = 256,
                 credential: Credential | None = None):
        self.connector = connector
        self.base = base
        self.seq_len = seq_len
        self.records_per_shard = records_per_shard
        self.credential = credential
        self._buf: list[np.ndarray] = []
        self._shard_idx = 0

    def add(self, tokens: np.ndarray) -> None:
        assert tokens.shape == (self.seq_len,), tokens.shape
        self._buf.append(tokens.astype(RECORD_DTYPE))
        if len(self._buf) >= self.records_per_shard:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        blob = np.stack(self._buf).tobytes()
        session = self.connector.start(self.credential)
        try:
            name = f"{self.base}/shard_{self._shard_idx:05d}.bin"
            put_bytes(self.connector, session, name, blob)
        finally:
            self.connector.destroy(session)
        self._shard_idx += 1
        self._buf = []


def synthetic_corpus(connector: Connector, base: str, *, vocab_size: int,
                     seq_len: int, n_records: int, seed: int = 0,
                     records_per_shard: int = 64,
                     credential: Credential | None = None) -> None:
    """Zipf-ish synthetic token corpus for the examples/benchmarks."""
    rng = np.random.default_rng(seed)
    w = TokenShardWriter(connector, base, seq_len, records_per_shard,
                         credential)
    for _ in range(n_records):
        z = rng.zipf(1.3, size=seq_len).astype(np.int64)
        w.add((z % vocab_size).astype(RECORD_DTYPE))
    w.flush()


class ShardedTokenDataset:
    """Deterministic, resumable, prefetching reader."""

    def __init__(self, connector: Connector, base: str,
                 cfg: DataPipelineConfig,
                 credential: Credential | None = None,
                 replica: Connector | None = None):
        self.connector = connector
        self.replica = replica
        self.base = base
        self.cfg = cfg
        self.credential = credential
        session = connector.start(credential)
        try:
            names = sorted(s.name for s in connector.listdir(session, base)
                           if not s.is_dir)
        finally:
            connector.destroy(session)
        # deterministic host partition
        self.shards = [n for i, n in enumerate(names)
                       if i % cfg.n_hosts == cfg.host_id]
        if not self.shards:
            raise ValueError(f"no shards for host {cfg.host_id}")
        self.record_bytes = cfg.seq_len * np.dtype(RECORD_DTYPE).itemsize
        self._state = {"epoch": 0, "shard": 0, "record": 0}
        self._latencies: list[float] = []
        self._hedges = 0

    # ---- resume ----------------------------------------------------------
    def state(self) -> dict:
        return dict(self._state)

    def restore(self, state: dict) -> None:
        self._state = dict(state)

    # ---- reading ---------------------------------------------------------
    def _read_records(self, shard: str, start: int, count: int) -> np.ndarray:
        def fetch(conn):
            session = conn.start(self.credential)
            try:
                data = get_bytes(conn, session, shard,
                                 offset=start * self.record_bytes,
                                 length=count * self.record_bytes)
            finally:
                conn.destroy(session)
            return data

        t0 = time.monotonic()  # lint: disable=R001(hedge trigger needs the real fetch latency — a wedged connector does not advance the model clock)
        use_hedge = (len(self._latencies) >= self.cfg.hedge_min_samples)
        if not use_hedge:
            data = fetch(self.connector)
        else:
            med = sorted(self._latencies)[len(self._latencies) // 2]
            deadline = med * self.cfg.hedge_factor
            result: dict = {}
            done = threading.Event()

            def primary():
                try:
                    r = fetch(self.connector)
                    result.setdefault("data", r)
                    done.set()
                except Exception as e:
                    result.setdefault("err", e)
                    done.set()

            t = threading.Thread(target=primary, daemon=True)
            t.start()
            if not done.wait(timeout=max(deadline, 0.005)):
                # straggler: hedge on the replica (or same connector)
                self._hedges += 1
                alt = self.replica or self.connector
                try:
                    r = fetch(alt)
                    result.setdefault("data", r)
                    done.set()
                except Exception:
                    done.wait()
            else:
                pass
            done.wait()
            if "data" not in result:
                raise result["err"]
            data = result["data"]
        self._latencies.append(time.monotonic() - t0)  # lint: disable=R001(hedge trigger needs the real fetch latency — a wedged connector does not advance the model clock)
        if len(self._latencies) > 256:
            del self._latencies[:128]
        arr = np.frombuffer(data, dtype=RECORD_DTYPE)
        return arr.reshape(count, self.cfg.seq_len)

    def _shard_records(self, shard: str) -> int:
        session = self.connector.start(self.credential)
        try:
            size = self.connector.stat(session, shard).size
        finally:
            self.connector.destroy(session)
        return size // self.record_bytes

    def batches(self):
        """Yields {'tokens': (B, S), 'labels': (B, S)} forever."""
        cfg = self.cfg
        while True:
            shard = self.shards[self._state["shard"]]
            n_rec = self._shard_records(shard)
            at = self._state["record"]
            while at + cfg.batch_size <= n_rec:
                recs = self._read_records(shard, at, cfg.batch_size)
                at += cfg.batch_size
                self._state["record"] = at
                tokens = recs
                labels = np.concatenate(
                    [recs[:, 1:], np.full((cfg.batch_size, 1), -1,
                                          RECORD_DTYPE)], axis=1)
                yield {"tokens": tokens, "labels": labels}
            self._state["record"] = 0
            self._state["shard"] += 1
            if self._state["shard"] >= len(self.shards):
                self._state["shard"] = 0
                self._state["epoch"] += 1

    def prefetching_batches(self):
        """Double-buffered batches via a bounded background queue."""
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for b in self.batches():
                    if stop.is_set():
                        return
                    q.put(b)
            except Exception as e:
                q.put(e)

        t = threading.Thread(target=producer, name="prefetch", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # free a producer blocked on the full queue, so that it sees stop
            with contextlib.suppress(queue.Empty):
                q.get_nowait()

    @property
    def hedged_reads(self) -> int:
        return self._hedges
