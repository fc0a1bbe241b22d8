"""The port's copy of the data pipeline (``repro_torch.data``) against the
reference's on one corpus: tests/test_ckpt_data.py's four data-pipeline
cases (determinism and shapes, disjoint host partitions, resume state,
prefetch), each run through both packages' ``ShardedTokenDataset`` over the
POSIX Connector of each on the same directory."""

import contextlib
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.connectors import PosixConnector as JaxPosix
from repro.data import DataPipelineConfig as JaxConfig
from repro.data import ShardedTokenDataset as JaxDataset
from repro.data import synthetic_corpus as jax_corpus
from repro_torch.connectors import PosixConnector
from repro_torch.data import DataPipelineConfig, ShardedTokenDataset, synthetic_corpus


def _corpus(tmp_path, **kw):
    """The corpus written by the reference, and by the port beside it: the
    same shard names and bytes.  Returns the two connectors on it."""
    jax_corpus(JaxPosix(str(tmp_path / "ref")), "corpus", **kw)
    synthetic_corpus(PosixConnector(str(tmp_path / "port")), "corpus", **kw)
    ref_dir, port_dir = (tmp_path / n / "corpus" for n in ("ref", "port"))
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir))
    for name in names:
        assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes(), name
    root = str(tmp_path / "ref")
    return JaxPosix(root), PosixConnector(root)


def _datasets(conns, **cfg):
    jconn, conn = conns
    return (JaxDataset(jconn, "corpus", JaxConfig(**cfg)),
            ShardedTokenDataset(conn, "corpus", DataPipelineConfig(**cfg)))


def _same(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])


def test_dataset_determinism_and_shapes(tmp_path):
    conns = _corpus(tmp_path, vocab_size=100, seq_len=32, n_records=64, seed=1,
                    records_per_shard=16)
    ref, ds1 = _datasets(conns, seq_len=32, batch_size=4)
    _, ds2 = _datasets(conns, seq_len=32, batch_size=4)
    for _, (a, b, want) in zip(range(10), zip(ds1.batches(), ds2.batches(), ref.batches())):
        assert a["tokens"].shape == (4, 32)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
        assert (a["labels"][:, -1] == -1).all()
        _same(a, want)


def test_dataset_host_partition_disjoint(tmp_path):
    conns = _corpus(tmp_path, vocab_size=50, seq_len=16, n_records=64, records_per_shard=8)
    seen = []
    for host in range(2):
        ref, ds = _datasets(conns, seq_len=16, batch_size=2, host_id=host, n_hosts=2)
        assert ds.shards == ref.shards
        seen.append(set(ds.shards))
    assert seen[0].isdisjoint(seen[1])
    assert len(seen[0]) + len(seen[1]) == 8


def test_dataset_resume_state(tmp_path):
    conns = _corpus(tmp_path, vocab_size=50, seq_len=16, n_records=32, records_per_shard=8)
    ref, ds = _datasets(conns, seq_len=16, batch_size=2)
    it, ref_it = ds.batches(), ref.batches()
    for _ in range(5):
        _same(next(it), next(ref_it))
    state = ds.state()
    assert state == ref.state()
    nxt = next(it)
    # a new dataset restored from the state continues at the same point, in
    # either package
    ref2, ds2 = _datasets(conns, seq_len=16, batch_size=2)
    ds2.restore(state)
    ref2.restore(state)
    nxt2 = next(ds2.batches())
    np.testing.assert_array_equal(nxt["tokens"], nxt2["tokens"])
    _same(nxt2, next(ref2.batches()))


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


def test_dataset_prefetch(tmp_path):
    conns = _corpus(tmp_path, vocab_size=50, seq_len=16, n_records=16, records_per_shard=8)
    ref, ds = _datasets(conns, seq_len=16, batch_size=2, prefetch=2)
    before = len(_prefetch_threads())
    with contextlib.closing(ds.prefetching_batches()) as gen:
        got = [b for _, b in zip(range(6), gen)]
    assert len(got) == 6
    for a, want in zip(got, ref.batches()):
        _same(a, want)
    # closing the generator stops its producer thread
    deadline = time.monotonic() + 30
    while len(_prefetch_threads()) > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(_prefetch_threads()) == before
