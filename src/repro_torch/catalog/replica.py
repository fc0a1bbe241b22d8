"""Content-addressed replica catalog with LRU/byte-budget eviction.

A copy of ``repro/catalog/replica.py``: the port imports nothing of ``repro``.

An entry says: the bytes whose §7 checksum is ``content`` — produced
from source file ``(src_endpoint, src_path)`` while its stat signature
was ``src_sig`` — are durably held at ``(endpoint_id, path)``.  The
data plane publishes entries at durable-commit time (the
:class:`~repro_torch.core.transfer.RangeDigester` fold already computed the
key) and consults the catalog before opening a source stream: a fresh
entry at the destination endpoint is satisfied by a local replica read
instead of a source read, with the checksum fold still verifying the
replica against ``content`` end-to-end.

Trust model — the catalog is a *hint* cache, never an authority:

* **staleness**: a lookup carries the source's current ``(size,
  mtime)`` signature; a signature mismatch invalidates every entry
  derived from that source and reports a miss (the §7 source re-read
  this shortcut replaces would have seen the new bytes, so the
  shortcut must refuse to serve the old ones);
* **corruption**: the replica read re-folds the streamed bytes and the
  caller invalidates on mismatch — a corrupt replica costs one wasted
  local read, never a wrong byte at the destination;
* **eviction**: LRU under an optional byte budget / entry cap, exact
  and deterministic (ordered by use, tie-broken by a monotonic
  counter, never wall time).

Everything is JSON-clean so entries can travel as *hints* with a
federated handoff (:class:`~repro_torch.fed.spec.TransferSpec`) and be
re-validated by the adopting site.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import asdict, dataclass, field


def source_key(src_endpoint: str, src_path: str) -> str:
    return f"{src_endpoint}|{src_path}"


def hint_bytes(sources: dict, src_endpoint: str, src_path: str) -> int:
    """Bytes a catalog source-summary holds for a source prefix — the
    placement-scoring primitive.  ``sources`` maps ``source_key`` ->
    bytes (the shape :meth:`ReplicaCatalog.source_summary` exports and
    the federation digest exchange carries).  Matches the exact path
    and anything under it (directory submissions expand to per-file
    entries)."""
    exact = source_key(src_endpoint, src_path)
    prefix = source_key(src_endpoint, src_path.rstrip("/")) + "/"
    return sum(n for k, n in sources.items()
               if k == exact or k.startswith(prefix))


@dataclass
class ReplicaEntry:
    """One cataloged replica: content identity, provenance, location."""

    #: §7 checksum of the bytes — plain hex or an ``r:`` composite
    #: folded from per-range digests
    content: str
    size: int
    #: source stat signature ``[size, mtime]`` the entry is valid
    #: against (same shape the marker journal stamps as ``src_sig``)
    src_sig: list
    src_endpoint: str
    src_path: str
    #: where the replica lives
    endpoint_id: str
    path: str
    site: str = ""
    #: per-range digests backing an ``r:`` composite ``content`` — the
    #: boundaries a replica read must re-fold over to verify
    digests: dict = field(default_factory=dict)

    def key(self) -> tuple[str, str, str]:
        return (self.content, self.endpoint_id, self.path)

    def src_key(self) -> str:
        return source_key(self.src_endpoint, self.src_path)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ReplicaEntry":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


class ReplicaCatalog:
    """Thread-safe content-addressed replica index.

    ``byte_budget``/``max_entries`` bound the catalog; eviction is
    exact LRU (publishes and serving lookups refresh recency, peeks and
    placement scoring do not).  All counters are monotonic and the
    ``generation`` bumps on every mutation, so a federation digest can
    etag the catalog the same way the manager etags its queue state.
    """

    def __init__(self, byte_budget: int | None = None,
                 max_entries: int | None = None, site: str = ""):
        self.byte_budget = byte_budget
        self.max_entries = max_entries
        self.site = site
        self._lock = threading.Lock()
        #: entry.key() -> ReplicaEntry, least-recently-used first
        self._entries: OrderedDict[tuple, ReplicaEntry] = OrderedDict()
        #: source_key -> set of entry keys derived from that source
        self._by_source: dict[str, set] = {}
        self.bytes = 0
        self.generation = 0
        # observability
        self.published = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale_invalidations = 0
        self.corrupt_invalidations = 0

    # ---- write path ------------------------------------------------------
    def publish(self, *, content: str, size: int, src_sig,
                src_endpoint: str, src_path: str, endpoint_id: str,
                path: str, site: str = "",
                digests: dict | None = None) -> ReplicaEntry | None:
        """Index one durably-committed replica.  Oversized payloads
        (bigger than the whole byte budget) are refused rather than
        evicting the entire catalog for an entry that still won't fit."""
        if not content or size <= 0 or src_sig is None:
            return None
        if self.byte_budget is not None and size > self.byte_budget:
            return None
        entry = ReplicaEntry(content=content, size=size,
                             src_sig=list(src_sig),
                             src_endpoint=src_endpoint, src_path=src_path,
                             endpoint_id=endpoint_id, path=path,
                             site=site or self.site,
                             digests=dict(digests or {}))
        with self._lock:
            key = entry.key()
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old.size
                self._by_source.get(old.src_key(), set()).discard(key)
            self._entries[key] = entry
            self.bytes += size
            self._by_source.setdefault(entry.src_key(), set()).add(key)
            self.published += 1
            self.generation += 1
            self._evict_locked()
        return entry

    def merge_hint(self, hint: dict) -> ReplicaEntry | None:
        """Adopt a traveled replica hint (a :meth:`ReplicaEntry.to_dict`
        dict riding a :class:`~repro_torch.fed.spec.TransferSpec`).  Hints go
        through :meth:`publish`, so budgets and invalidation apply to
        them exactly as to locally-produced entries."""
        try:
            e = ReplicaEntry.from_dict(hint)
        except TypeError:
            return None  # malformed hint: ignore, never raise
        if not e.content or e.size <= 0:
            return None
        return self.publish(content=e.content, size=e.size,
                            src_sig=e.src_sig, src_endpoint=e.src_endpoint,
                            src_path=e.src_path, endpoint_id=e.endpoint_id,
                            path=e.path, site=e.site, digests=e.digests)

    def _evict_locked(self) -> None:
        while ((self.byte_budget is not None
                and self.bytes > self.byte_budget)
               or (self.max_entries is not None
                   and len(self._entries) > self.max_entries)):
            key, victim = self._entries.popitem(last=False)
            self.bytes -= victim.size
            self._by_source.get(victim.src_key(), set()).discard(key)
            self.evictions += 1
            self.generation += 1

    # ---- read path -------------------------------------------------------
    def _fresh_locked(self, src_endpoint: str, src_path: str, src_sig,
                      endpoint_id: str | None) -> ReplicaEntry | None:
        """Most-recently-used fresh entry for a source, invalidating
        stale ones as they are discovered (caller holds the lock)."""
        skey = source_key(src_endpoint, src_path)
        keys = self._by_source.get(skey)
        if not keys:
            return None
        sig = list(src_sig) if src_sig is not None else None
        best = None
        for key in list(keys):
            entry = self._entries.get(key)
            if entry is None:
                keys.discard(key)
                continue
            if sig is None or entry.src_sig != sig:
                # the source changed under the entry: every byte it
                # indexes is stale — drop it now so no later lookup
                # (possibly without a fresh stat) can be served old data
                self._drop_locked(key)
                self.stale_invalidations += 1
                continue
            if endpoint_id is not None and entry.endpoint_id != endpoint_id:
                continue
            best = entry  # OrderedDict iterates LRU->MRU; keep the last
        return best

    def lookup(self, src_endpoint: str, src_path: str, src_sig,
               endpoint_id: str | None = None) -> ReplicaEntry | None:
        """A fresh replica of ``(src_endpoint, src_path)`` at
        ``endpoint_id`` (any endpoint when ``None``), validated against
        the source's *current* stat signature.  Counts a hit/miss and
        refreshes LRU recency — this is the serving path."""
        with self._lock:
            entry = self._fresh_locked(src_endpoint, src_path, src_sig,
                                       endpoint_id)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(entry.key())
            self.hits += 1
            return entry

    def peek(self, src_endpoint: str, src_path: str, src_sig,
             endpoint_id: str | None = None) -> ReplicaEntry | None:
        """Like :meth:`lookup` but counter- and LRU-neutral — for
        routing decisions that may not be followed by a read."""
        with self._lock:
            return self._fresh_locked(src_endpoint, src_path, src_sig,
                                      endpoint_id)

    def invalidate(self, entry: ReplicaEntry,
                   reason: str = "corrupt") -> bool:
        """Drop one entry (a replica read that failed its fold calls
        this before falling back to a real transfer)."""
        with self._lock:
            if entry.key() not in self._entries:
                return False
            self._drop_locked(entry.key())
            if reason == "corrupt":
                self.corrupt_invalidations += 1
            else:
                self.stale_invalidations += 1
            return True

    def _drop_locked(self, key: tuple) -> None:
        victim = self._entries.pop(key, None)
        if victim is None:
            return
        self.bytes -= victim.size
        self._by_source.get(victim.src_key(), set()).discard(key)
        self.generation += 1

    # ---- placement / federation views ------------------------------------
    def held_bytes_at(self, endpoint_ids, src_endpoint: str,
                      src_path: str) -> int:
        """Bytes already held at any of ``endpoint_ids`` for a source
        prefix — replica-aware route/placement scoring.  Read-only: no
        counters, no LRU touch (a score is not a serve)."""
        eps = set(endpoint_ids)
        exact = source_key(src_endpoint, src_path)
        prefix = source_key(src_endpoint, src_path.rstrip("/")) + "/"
        with self._lock:
            return sum(e.size for e in self._entries.values()
                       if e.endpoint_id in eps
                       and (e.src_key() == exact
                            or e.src_key().startswith(prefix)))

    def source_summary(self) -> dict:
        """Compact ``source_key -> bytes`` map — what rides the
        federation digest exchange (see :func:`hint_bytes`)."""
        with self._lock:
            out: dict[str, int] = {}
            for e in self._entries.values():
                out[e.src_key()] = out.get(e.src_key(), 0) + e.size
            return out

    def export_hints(self, src_endpoint: str, src_path: str,
                     limit: int = 32) -> list[dict]:
        """JSON-clean entry dicts for a source prefix, MRU-first — the
        replica hints a handoff carries to the adopting site."""
        exact = source_key(src_endpoint, src_path)
        prefix = source_key(src_endpoint, src_path.rstrip("/")) + "/"
        with self._lock:
            out = [e.to_dict() for e in reversed(self._entries.values())
                   if e.src_key() == exact or e.src_key().startswith(prefix)]
        return out[:limit]

    def entries(self) -> list[ReplicaEntry]:
        """LRU->MRU snapshot (tests assert eviction order with this)."""
        with self._lock:
            return list(self._entries.values())

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self.bytes,
                    "hits": self.hits, "misses": self.misses,
                    "published": self.published,
                    "evictions": self.evictions,
                    "stale_invalidations": self.stale_invalidations,
                    "corrupt_invalidations": self.corrupt_invalidations,
                    "generation": self.generation}

    def hit_rate(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0
