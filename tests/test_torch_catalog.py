"""The port's replica catalog (``repro_torch.catalog``) against the
reference's: one seeded sequence of publish / lookup / peek / stale
signature / corrupt invalidation / hint merge / eviction operations, applied
to both catalogs, gives the same answer at every step and the same hits,
misses, evictions, ``stats()``, ``export_hints()`` and source summaries at
the end; and the same fan-out through each package's manager, with the
first replica corrupted, counts the same replica hits and fallbacks.

Every manager runs on a ``Clock(scale=0.0)`` and is shut down before the
test ends; nothing asserts on wall time."""

import os
import random

import numpy as np
import pytest

import repro.core  # noqa: F401  (imported before repro.sim: the reference's import cycle)
from repro.catalog import ReplicaCatalog as JaxReplicaCatalog
from repro.catalog import hint_bytes as jax_hint_bytes
from repro.connectors import MemoryConnector as JaxMemory
from repro.connectors import PosixConnector as JaxPosix
from repro.core import Clock as JaxClock
from repro.core import Credential as JaxCredential
from repro.core import CredentialStore as JaxCredentialStore
from repro.core import Endpoint as JaxEndpoint
from repro.core import TransferManager as JaxTransferManager
from repro.core import TransferOptions as JaxTransferOptions
from repro.sim.scenarios import _MeteredSrc as JaxMeteredSrc
from repro_torch.catalog import ReplicaCatalog, hint_bytes, source_key
from repro_torch.connectors import MemoryConnector, PosixConnector
from repro_torch.core import Clock, Credential
from repro_torch.core.manager import TransferManager
from repro_torch.core.transfer import CredentialStore, Endpoint, TransferOptions
from repro_torch.sim.scenarios import _MeteredSrc

KB = 1024

NAMES = [f"data/f{i}.bin" for i in range(6)] + ["data/sub/g.bin", "database"]
ENDPOINTS = ["dst-a", "dst-b"]


def _view(entry):
    return None if entry is None else entry.to_dict()


def _ops(seed, n=120):
    """A seeded list of catalog operations over a few sources, each a
    (name, kwargs) pair both catalogs take as is."""
    rng = np.random.default_rng(seed)
    sig = {name: [int(rng.integers(1, 9)) * KB, 1.0] for name in NAMES}
    ops = []
    for _ in range(n):
        name = NAMES[int(rng.integers(len(NAMES)))]
        ep = ENDPOINTS[int(rng.integers(2))]
        kind = rng.choice(["publish", "publish", "lookup", "lookup", "peek",
                           "stale", "mutate", "corrupt", "hint"])
        if kind == "publish":
            ops.append(("publish", dict(
                content=f"c-{name}-{sig[name][1]}", size=sig[name][0], src_sig=sig[name],
                src_endpoint="src-ep", src_path=name, endpoint_id=ep,
                path=f"out/{ep}/{name}", digests={"0": f"d-{name}"})))
        elif kind in ("lookup", "peek", "corrupt"):
            ops.append((kind, dict(src_endpoint="src-ep", src_path=name,
                                   src_sig=list(sig[name]),
                                   endpoint_id=None if rng.random() < 0.3 else ep)))
        elif kind == "stale":  # a lookup under a signature the source no longer has
            ops.append(("lookup", dict(src_endpoint="src-ep", src_path=name,
                                       src_sig=[sig[name][0], sig[name][1] + 0.5],
                                       endpoint_id=ep)))
        elif kind == "mutate":  # the source changes: later lookups see the new signature
            sig[name] = [sig[name][0], sig[name][1] + 1.0]
        else:
            ops.append(("hint", dict(content=f"h-{name}", size=sig[name][0],
                                     src_sig=list(sig[name]), src_endpoint="src-ep",
                                     src_path=name, endpoint_id=ep,
                                     path=f"hinted/{name}", site="s9", digests={})))
    ops.append(("hint", {"garbage": True}))  # malformed: ignored by both
    return ops


def _apply(cat, op, kw):
    if op == "publish":
        return _view(cat.publish(**kw))
    if op == "lookup":
        return _view(cat.lookup(**kw))
    if op == "peek":
        return _view(cat.peek(**kw))
    if op == "corrupt":  # a replica read whose fold failed drops the entry it was served
        entry = cat.lookup(**kw)
        return None if entry is None else (entry.to_dict(), cat.invalidate(entry))
    return _view(cat.merge_hint(kw))


def _summary(cat, hint_fn):
    return {
        "stats": cat.stats(),
        "hit_rate": cat.hit_rate(),
        "entries": [e.to_dict() for e in cat.entries()],
        "hints": cat.export_hints("src-ep", "data"),
        "hints_one": cat.export_hints("src-ep", "data/f1.bin", limit=2),
        "sources": cat.source_summary(),
        "held": [cat.held_bytes_at(eps, "src-ep", "data")
                 for eps in (["dst-a"], ["dst-b"], ENDPOINTS)],
        "hint_bytes": [hint_fn(cat.source_summary(), "src-ep", p)
                       for p in ("data", "data/sub", "database", "nope")],
    }


@pytest.mark.parametrize("budget", [None, 6 * KB, 20 * KB], ids=["unbounded", "6K", "20K"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_operation_sequence_matches_reference(seed, budget):
    ref = JaxReplicaCatalog(byte_budget=budget, max_entries=10, site="s0")
    port = ReplicaCatalog(byte_budget=budget, max_entries=10, site="s0")
    for i, (op, kw) in enumerate(_ops(seed)):
        assert _apply(port, op, dict(kw)) == _apply(ref, op, dict(kw)), (i, op, kw)
    want, got = _summary(ref, jax_hint_bytes), _summary(port, hint_bytes)
    assert got == want
    stats = got["stats"]
    assert stats["hits"] and stats["misses"] and stats["stale_invalidations"]
    if budget is not None:
        assert stats["evictions"] and stats["bytes"] <= budget


def test_source_key_matches_reference():
    from repro.catalog import source_key as jax_source_key
    for ep, path in [("src-ep", "data/a.bin"), ("e", ""), ("e/x", "p q/ü.bin")]:
        assert source_key(ep, path) == jax_source_key(ep, path)


def _fanout(side, root, files):
    """tests/test_catalog.py's fabric: a posix source behind a send-side
    byte meter, a memory destination, one manager sharing a catalog.  The
    tree goes out once, its replicas are corrupted in place, and two more
    copies follow: the first falls back to the source on every file, the
    second is served from the replicas the fallback republished."""
    (cat_cls, posix_cls, memory_cls, metered_cls, creds_cls, cred_cls,
     manager_cls, endpoint_cls, opts_cls, clock_cls) = side
    src_root = os.path.join(root, "srcfs")
    for name, payload in files.items():
        os.makedirs(os.path.dirname(os.path.join(src_root, name)), exist_ok=True)
        with open(os.path.join(src_root, name), "wb") as f:
            f.write(payload)
    clock = clock_cls(scale=0.0)
    cat = cat_cls()
    src, dst = metered_cls(posix_cls(src_root)), memory_cls(clock=clock)
    creds = creds_cls()
    for ep in ("src-ep", "dst-ep"):
        creds.register(ep, cred_cls("local-user", {"token": "t"}))
    manager = manager_cls(max_workers=2, per_endpoint_cap=None, credential_store=creds,
                          catalog=cat, marker_root=os.path.join(root, "markers"),
                          clock=clock)
    opts = opts_cls(integrity=True, startup_cost=0.0, retry_backoff=0.01,
                    coalesce_threshold=0)
    out = []
    try:
        for k in range(3):
            task = manager.submit(endpoint_cls(src, "data", "src-ep"),
                                  endpoint_cls(dst, f"out/t{k}", "dst-ep"), opts,
                                  task_id=f"cat-t{k}")
            assert task.wait(120) and task.status == task.SUCCEEDED, task.events[-3:]
            st = task.stats
            out.append((st.files_done, st.bytes_total, st.replica_hits, st.replica_bytes,
                        st.replica_fallbacks, src.sent("data")))
            if k == 0:
                for key in list(dst.store.keys()):
                    data = dst.store.get(key)
                    dst.store.put(key, bytes([data[0] ^ 0xFF]) + data[1:])
        landed = {key: dst.store.get(key) for key in dst.store.keys()
                  if key.startswith("out/t2/")}
    finally:
        manager.shutdown(wait=True, timeout=60)
    stats = cat.stats()
    stats.pop("generation")  # counts republishes, whose order follows the worker threads
    return out, stats, landed


def test_corrupt_replica_fanout_matches_reference(tmp_path):
    rng = random.Random(7)
    files = {f"data/f{i}.bin" if i % 2 else f"data/sub/f{i}.bin":
             rng.randbytes(rng.randint(2 * KB, 6 * KB)) for i in range(4)}
    ref = _fanout((JaxReplicaCatalog, JaxPosix, JaxMemory, JaxMeteredSrc, JaxCredentialStore,
                   JaxCredential, JaxTransferManager, JaxEndpoint, JaxTransferOptions, JaxClock),
                  str(tmp_path / "ref"), files)
    port = _fanout((ReplicaCatalog, PosixConnector, MemoryConnector, _MeteredSrc,
                    CredentialStore, Credential, TransferManager, Endpoint, TransferOptions,
                    Clock), str(tmp_path / "port"), files)
    assert port[:2] == ref[:2]
    total = sum(len(p) for p in files.values())
    (_, _, hits1, _, fallbacks1, sent1), (_, _, hits2, rbytes2, _, sent2) = port[0][1:]
    assert (hits1, fallbacks1, sent1) == (0, len(files), 2 * total)
    assert (hits2, rbytes2, sent2) == (len(files), total, 2 * total)
    assert port[1]["corrupt_invalidations"] == len(files)
    assert port[2] == {f"out/t2/{name[len('data/'):]}": p for name, p in files.items()}
