"""The port's copy of the transfer plane against the reference: the host
lanesum32 hasher byte for byte, third-party checkpoint replication through
the port's ``TransferService`` (tests/test_ckpt_data.py's case), and
checkpoints that cross between the two packages through each one's
service, with manifests and digests identical; the copied ``obs`` and
``svc`` packages import first without the reference's cycle.

Every service runs on a ``Clock(scale=0.0)`` (link waits are accounting
only) and every manager a test starts is shut down before it ends."""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro.core import Clock as JaxClock
from repro.core import Endpoint as JaxEndpoint
from repro.core import TransferService as JaxTransferService
from repro.core.integrity import hasher as jax_hasher
from repro.ckpt import replicate_checkpoint as jax_replicate
from repro.ckpt import restore_checkpoint as jax_restore
from repro.ckpt import save_checkpoint as jax_save
from repro.connectors import PosixConnector as JaxPosix
from repro_torch.ckpt import get_bytes, replicate_checkpoint, restore_checkpoint, save_checkpoint
from repro_torch.connectors import MemoryConnector, PosixConnector
from repro_torch.core import Clock
from repro_torch.core.integrity import checksum_bytes, hasher
from repro_torch.core.transfer import Endpoint, TransferService
from repro_torch.kernels.checksum.ref import digest_ref
from repro_torch.models.convert import flatten, params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: leaves of at least this many bytes get an object of their own, so the
#: service's per-file digest is that leaf's manifest digest
BUNDLE = 1024


def make_jax_state(seed=0):
    """tests/test_ckpt_data.py::make_state."""
    k = jax.random.PRNGKey(seed)
    return {
        "params": {"w1": jax.random.normal(k, (64, 64)),
                   "b1": jnp.zeros((64,)),
                   "blocks": {"wq": jax.random.normal(k, (4, 32, 32))}},
        "opt": {"m": {"w": jnp.ones((16,), jnp.bfloat16)},
                "step": jnp.int32(7)},
    }


def make_state(seed=0):
    return params_from_jax(jax.tree.map(np.asarray, make_jax_state(seed)), "cpu")


def _same_bytes(a, b, what=""):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), what


@contextlib.contextmanager
def service(cls, tmp_path, clock, name):
    """A transfer service whose implicit manager is shut down on exit."""
    svc = cls(marker_root=os.path.join(str(tmp_path), f"markers-{name}"), clock=clock)
    try:
        yield svc
    finally:
        svc.default_manager().shutdown(wait=True, timeout=60)


def _read(root, step_dir, name):
    with open(os.path.join(root, step_dir, name), "rb") as f:
        return f.read()


def _file_digests(task):
    """{file name: the lanesum32 the service verified at both ends}."""
    return {os.path.basename(f.dst): f.checksum for f in task.files}


#: (bytes, update size): ragged sizes in pieces of 1, 3, 4, 4093 bytes or
#: whole, and a buffer above 1 MiB in large pieces
HASH_CASES = ([(n, split) for n in (0, 1, 3, 4, 5, 1023, 4097) for split in (None, 1, 3, 4, 4093)]
              + [((1 << 20) + 3, split) for split in (None, 4093, 65537)])


@pytest.mark.parametrize("size,split", HASH_CASES)
def test_lanesum32_hasher_matches_reference(size, split):
    """The host twin of the checksum kernel, fed in pieces of ``split``
    bytes (ragged against the 4-byte words) or whole, against the
    reference's and the kernel's plain byte-stream version."""
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    got, want = hasher("lanesum32"), jax_hasher("lanesum32")
    step = split or max(size, 1)
    for i in range(0, size, step):
        got.update(data[i:i + step])
        want.update(data[i:i + step])
    assert got.hexdigest() == want.hexdigest() == digest_ref(data)
    assert checksum_bytes(data, "lanesum32") == got.hexdigest()


@pytest.mark.parametrize("algorithm", ["sha256", "crc32", "fletcher64"])
def test_other_hashers_match_reference(algorithm):
    data = np.random.default_rng(1).integers(0, 256, 4099, dtype=np.uint8).tobytes()
    got, want = hasher(algorithm), jax_hasher(algorithm)
    for i in range(0, len(data), 1000):
        got.update(data[i:i + 1000])
        want.update(data[i:i + 1000])
    assert got.hexdigest() == want.hexdigest()


def test_checkpoint_replication_third_party(tmp_path):
    """Cluster -> cloud replication via the port's managed transfer service
    (tests/test_ckpt_data.py), with lanesum32 re-verified at the destination."""
    cluster = PosixConnector(os.path.join(str(tmp_path), "cluster"))
    clock = Clock(scale=0.0)
    cloud = MemoryConnector(clock=clock)
    state = make_state()
    manifest = save_checkpoint(state, cluster, "ckpt", step=5, bundle_threshold=BUNDLE)
    with service(TransferService, tmp_path, clock, "port") as svc:
        task = replicate_checkpoint(svc, Endpoint(cluster, "ckpt"), Endpoint(cloud, "mirror"),
                                    step=5, sync=True)
    assert task.status == task.SUCCEEDED, task.events
    assert task.stats.integrity_failures == 0
    assert task.stats.files_done == task.stats.files_total == len(task.files) > 1
    digests = _file_digests(task)
    for path, meta in manifest["objects"].items():
        assert digests[meta["object"]] == meta["checksum"], path
    session = cloud.start(None)
    for path, meta in manifest["bundles"].items():
        blob = get_bytes(cloud, session, f"mirror/step_5/{meta['object']}",
                         offset=meta["offset"], length=meta["length"])
        assert checksum_bytes(blob, "lanesum32") == meta["checksum"], path
    cloud.destroy(session)
    restored, step = restore_checkpoint(state, cloud, "mirror", step=5)
    assert step == 5
    for path, leaf in flatten(state).items():
        _same_bytes(flatten(restored)[path], leaf, path)


def test_jax_checkpoint_through_port_service_restores_into_jax(tmp_path):
    """A checkpoint the reference saves, replicated by the port's service,
    restores into JAX; the reference's own service replicates it with the
    same per-file digests, and the manifest arrives byte for byte."""
    src, dst, dst_ref = (str(tmp_path / n) for n in ("src", "dst", "dst_ref"))
    jstate = make_jax_state()
    jax_save(jstate, JaxPosix(src), "ckpt", step=2, bundle_threshold=BUNDLE)
    with service(TransferService, tmp_path, Clock(scale=0.0), "port") as svc:
        task = replicate_checkpoint(svc, Endpoint(PosixConnector(src), "ckpt"),
                                    Endpoint(PosixConnector(dst), "mirror"), step=2, sync=True)
    with service(JaxTransferService, tmp_path, JaxClock(scale=0.0), "ref") as jsvc:
        jtask = jax_replicate(jsvc, JaxEndpoint(JaxPosix(src), "ckpt"),
                              JaxEndpoint(JaxPosix(dst_ref), "mirror"), step=2, sync=True)
    assert task.status == task.SUCCEEDED and jtask.status == jtask.SUCCEEDED
    assert _file_digests(task) == _file_digests(jtask)
    manifest = _read(src, "ckpt/step_2", "manifest.json")
    assert _read(dst, "mirror/step_2", "manifest.json") == manifest
    for meta in json.loads(manifest)["objects"].values():
        assert _file_digests(task)[meta["object"]] == meta["checksum"]
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    restored, step = jax_restore(abstract, JaxPosix(dst), "mirror", step=2)
    assert step == 2
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_port_checkpoint_through_reference_service_restores_into_port(tmp_path):
    """A checkpoint the port saves, replicated by the reference's service,
    restores into the port; the port's service gives the same per-file
    digests, and both manifests equal the reference's for the same state."""
    src, dst, dst_port, jax_dir = (str(tmp_path / n) for n in ("src", "dst", "dst_port", "jax"))
    state = make_state()
    save_checkpoint(state, PosixConnector(src), "ckpt", step=3, bundle_threshold=BUNDLE)
    jax_save(make_jax_state(), JaxPosix(jax_dir), "ckpt", step=3, bundle_threshold=BUNDLE)
    with service(JaxTransferService, tmp_path, JaxClock(scale=0.0), "ref") as jsvc:
        jtask = jax_replicate(jsvc, JaxEndpoint(JaxPosix(src), "ckpt"),
                              JaxEndpoint(JaxPosix(dst), "mirror"), step=3, sync=True)
    with service(TransferService, tmp_path, Clock(scale=0.0), "port") as svc:
        task = replicate_checkpoint(svc, Endpoint(PosixConnector(src), "ckpt"),
                                    Endpoint(PosixConnector(dst_port), "mirror"), step=3,
                                    sync=True)
    assert jtask.status == jtask.SUCCEEDED and task.status == task.SUCCEEDED
    assert _file_digests(jtask) == _file_digests(task)
    manifest = _read(jax_dir, "ckpt/step_3", "manifest.json")
    assert _read(src, "ckpt/step_3", "manifest.json") == manifest
    assert _read(dst, "mirror/step_3", "manifest.json") == manifest
    restored, step = restore_checkpoint(state, PosixConnector(dst), "mirror", step=3)
    assert step == 3
    for path, leaf in flatten(state).items():
        _same_bytes(flatten(restored)[path], leaf, path)


def test_replica_with_a_flipped_byte_fails_the_restore(tmp_path):
    """The mirror is held to the card's digests: a byte flipped in a
    replicated object fails the restore from the mirror."""
    from repro_torch.core.errors import IntegrityError
    cluster = PosixConnector(os.path.join(str(tmp_path), "cluster"))
    clock = Clock(scale=0.0)
    cloud = MemoryConnector(clock=clock)
    state = make_state()
    save_checkpoint(state, cluster, "ckpt", step=1, bundle_threshold=BUNDLE)
    with service(TransferService, tmp_path, clock, "port") as svc:
        task = replicate_checkpoint(svc, Endpoint(cluster, "ckpt"), Endpoint(cloud, "mirror"),
                                    step=1, sync=True)
    assert task.status == task.SUCCEEDED
    key = "mirror/step_1/params.w1.bin"
    blob = bytearray(cloud.store.get(key))
    blob[100] ^= 0x10
    cloud.store.put(key, bytes(blob))
    with pytest.raises(IntegrityError, match="params/w1"):
        restore_checkpoint(state, cloud, "mirror", step=1)


@pytest.mark.parametrize("package", ["repro_torch.obs", "repro_torch.svc"])
def test_plane_imports_first(package):
    """The reference's ``obs`` and ``svc`` raise ImportError when imported
    before ``repro.core`` (ROADMAP C2); the port's import first, in a fresh
    interpreter, and bring the transfer service up after them."""
    code = (f"import {package}, sys\n"
            "from repro_torch.core.transfer import TransferService\n"
            "from repro_torch.core.manager import TransferManager\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or m == 'repro'"
            " or m.startswith(('jax.', 'repro.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
