"""Content-addressed replica catalog (replica management plane).

A copy of ``repro/catalog/__init__.py``: the port imports nothing of ``repro``.

Allcock et al. (PAPERS.md) showed the natural step past efficient
transport is *replica management*: don't move bytes a site already
holds.  The data plane's per-range digest journal (§7 checksum fold)
content-addresses every traveled segment anyway, so publishing the
finished (digest, location) pairs into a catalog is nearly free — and a
fan-out of N identical submissions then collapses to 1 real transfer
plus N-1 near-destination replica reads, each still verified end-to-end
by the same fold.

* :mod:`repro_torch.catalog.replica` — :class:`ReplicaCatalog`: site-scoped
  replica entries keyed by content digest + source ``(size, mtime)``
  signature, LRU/byte-budget eviction, staleness invalidation, and the
  compact summaries that ride the federation digest/etag exchange so
  placement can score replica hits.
"""

from .replica import (ReplicaCatalog, ReplicaEntry, hint_bytes,
                      source_key)

__all__ = ["ReplicaCatalog", "ReplicaEntry", "hint_bytes", "source_key"]
