"""The port's checkpoints over its POSIX Connector: the round-trip,
coalescing, corruption and async+GC cases of tests/test_ckpt_data.py, and
checkpoints that cross between the JAX reference and the port on one
directory, with byte-identical manifests; among them the parameters of
scaled-down granite-moe and jamba (stacked expert weights, fp32 router and
mamba leaves inside a bf16 tree)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro.ckpt import restore_checkpoint as jax_restore
from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro.ckpt import save_checkpoint as jax_save
from repro.connectors import PosixConnector as JaxPosix
from repro_torch.ckpt import (CheckpointManager, get_bytes, put_bytes,
                              restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.connectors import PosixConnector
from repro_torch.core.errors import IntegrityError
from repro_torch.models.convert import flatten, params_from_jax
from repro_torch.models.registry import build


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
    """The same state in the port: bf16 carried byte for byte."""
    return params_from_jax(jax.tree.map(np.asarray, make_jax_state(seed)), "cpu")


def _same_bytes(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_io_roundtrip(tmp_path):
    conn = PosixConnector(str(tmp_path))
    s = conn.start(None)
    payload = os.urandom(5 * 1024 * 1024 + 13)
    put_bytes(conn, s, "deep/dir/obj.bin", payload)
    assert get_bytes(conn, s, "deep/dir/obj.bin") == payload
    assert get_bytes(conn, s, "deep/dir/obj.bin",
                     offset=100, length=999) == payload[100:1099]


def test_checkpoint_roundtrip(tmp_path):
    conn = PosixConnector(str(tmp_path))
    state = make_state()
    manifest = save_checkpoint(state, conn, "ckpt", step=3)
    assert manifest["step"] == 3
    assert manifest["bundles"]["opt/m/w"]["dtype"] == "bfloat16"
    assert manifest["bundles"]["opt/step"]["shape"] == []
    abstract = {k: v for k, v in state.items()}
    restored, step = restore_checkpoint(abstract, conn, "ckpt")
    assert step == 3
    for path, leaf in flatten(state).items():
        _same_bytes(flatten(restored)[path], leaf)


def test_checkpoint_restores_onto_meta_abstract(tmp_path):
    conn = PosixConnector(str(tmp_path))
    state = make_state()
    save_checkpoint(state, conn, "ckpt", step=1)
    abstract = flatten(state)
    meta = {"params": state["params"], "opt": {"m": {"w": abstract["opt/m/w"].to("meta")},
                                               "step": abstract["opt/step"].to("meta")}}
    restored, _ = restore_checkpoint(meta, conn, "ckpt", step=1)
    assert restored["opt"]["step"].device.type == "cpu"
    assert int(restored["opt"]["step"]) == 7


def test_checkpoint_small_leaves_coalesced(tmp_path):
    """Paper §5/§8: small tensors are bundled, not written as many tiny
    objects (per-file overhead t0 dominates otherwise)."""
    conn = PosixConnector(str(tmp_path))
    state = {f"tiny{i}": torch.full((8,), float(i)) for i in range(40)}
    manifest = save_checkpoint(state, conn, "c", step=0)
    assert len(manifest["objects"]) == 0           # nothing large
    assert len(manifest["bundles"]) == 40          # all bundled
    objects = {m["object"] for m in manifest["bundles"].values()}
    assert len(objects) <= 2                        # into a couple blobs
    restored, _ = restore_checkpoint(state, conn, "c")
    assert float(restored["tiny7"][0]) == 7.0


def test_checkpoint_bundles_flush_at_eight_thresholds(tmp_path):
    conn = PosixConnector(str(tmp_path))
    state = {f"t{i:02d}": torch.full((256,), float(i)) for i in range(40)}  # 1 KiB each
    manifest = save_checkpoint(state, conn, "c", step=0, bundle_threshold=2048)
    sizes = {}
    for m in manifest["bundles"].values():
        sizes[m["object"]] = sizes.get(m["object"], 0) + m["length"]
    assert sizes == {"bundle_0.bin": 16384, "bundle_1.bin": 16384, "bundle_2.bin": 8192}


def test_checkpoint_detects_corruption(tmp_path):
    conn = PosixConnector(str(tmp_path))
    state = {"w": torch.arange(131072, dtype=torch.float32)}
    save_checkpoint(state, conn, "c", step=1)
    # flip a byte in the stored object
    path = os.path.join(str(tmp_path), "c", "step_1", "bundle_0.bin")
    raw = bytearray(open(path, "rb").read())
    raw[1000] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(IntegrityError):
        restore_checkpoint(state, conn, "c", step=1)


def test_checkpoint_manager_async_and_gc(tmp_path):
    conn = PosixConnector(str(tmp_path))
    mgr = CheckpointManager(conn, "run1", retain=2)
    state = make_state()
    for step in (1, 2, 3, 4):
        mgr.save_async(state, step)
        # the snapshot is taken: an in-place update may follow at once
        state["opt"]["step"].add_(1)
        mgr.wait()
    s = conn.start(None)
    names = {i.name for i in conn.listdir(s, "run1")}
    assert any("step_4" in n for n in names)
    assert not any("step_1" in n for n in names)  # GC'd
    restored, step = mgr.restore_latest(state)
    assert step == 4
    assert int(restored["opt"]["step"]) == 10  # 7 + the three updates before save 4
    assert [t["step"] for t in mgr.timings] == [1, 2, 3, 4]
    assert all(t["leaves"] == 5 and t["objects"] + t["bundled"] == 5 for t in mgr.timings)


def test_save_async_snapshot_survives_in_place_update(tmp_path):
    """An 8 MB leaf is written as its own object by the writer thread; the
    in-place update that follows ``save_async`` must not reach its bytes."""
    mgr = CheckpointManager(PosixConnector(str(tmp_path)), "run", retain=1)
    gen = torch.Generator().manual_seed(3)
    state = {"big": torch.randn(1 << 21, generator=gen), "step": torch.tensor(5)}
    saved = {k: v.clone() for k, v in state.items()}
    mgr.save_async(state, 1)
    state["big"].add_(1.0)
    state["step"].add_(1)
    mgr.wait()
    assert mgr.timings[0]["objects"] == 1
    restored, step = mgr.restore_latest(state)
    assert step == 1
    for k in saved:
        _same_bytes(restored[k], saved[k])


def test_jax_saves_port_restores(tmp_path):
    jstate = make_jax_state(seed=1)
    jax_save(jstate, JaxPosix(str(tmp_path)), "ckpt", step=5)
    restored, step = restore_checkpoint(make_state(seed=0), PosixConnector(str(tmp_path)),
                                        "ckpt")
    assert step == 5
    want = flatten(params_from_jax(jax.tree.map(np.asarray, jstate), "cpu"))
    got = flatten(restored)
    assert got["opt/m/w"].dtype == torch.bfloat16
    for path in want:
        _same_bytes(got[path], want[path])


def test_port_saves_jax_restores(tmp_path):
    state = make_state(seed=2)
    save_checkpoint(state, PosixConnector(str(tmp_path)), "ckpt", step=6)
    jstate = make_jax_state(seed=0)
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    restored, step = jax_restore(abstract, JaxPosix(str(tmp_path)), "ckpt")
    assert step == 6
    want = jax.tree.map(np.asarray, make_jax_state(seed=2))
    for path, leaf in flatten(want).items():
        got = np.asarray(flatten(restored)[path])
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        assert got.tobytes() == leaf.tobytes(), path


def test_manifest_byte_identical_to_jax(tmp_path):
    jstate = make_jax_state(seed=3)
    jax_save(jstate, JaxPosix(str(tmp_path / "jax")), "ckpt", step=2,
             bundle_threshold=4096)
    save_checkpoint(params_from_jax(jax.tree.map(np.asarray, jstate), "cpu"),
                    PosixConnector(str(tmp_path / "port")), "ckpt", step=2,
                    bundle_threshold=4096)
    manifests = [(tmp_path / side / "ckpt" / "step_2" / "manifest.json").read_bytes()
                 for side in ("jax", "port")]
    assert manifests[0] == manifests[1]
    assert b'"objects": {"params/blocks/wq"' in manifests[0]  # both kinds present
    for name in ("bundle_0.bin", "params.blocks.wq.bin", "params.w1.bin"):
        assert ((tmp_path / "jax" / "ckpt" / "step_2" / name).read_bytes()
                == (tmp_path / "port" / "ckpt" / "step_2" / name).read_bytes())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-1.5-large-398b"])
def test_model_checkpoint_crosses_both_ways(tmp_path, arch):
    """A bf16 parameter tree of the MoE and hybrid families, saved by each
    package: byte-identical manifests and digests; the JAX save restores
    into the port, the port's into JAX, byte for byte, every leaf in its own
    dtype (the stacked expert weights bf16, the router and mamba's A_log,
    dt_bias and D fp32)."""
    jcfg = jax_get_config(arch).scaled_down(param_dtype="bfloat16")
    jparams = jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jax_save(jparams, JaxPosix(str(tmp_path / "jax")), "ckpt", step=1)
    save_checkpoint(params, PosixConnector(str(tmp_path / "port")), "ckpt", step=1)
    manifests = [(tmp_path / side / "ckpt" / "step_1" / "manifest.json").read_bytes()
                 for side in ("jax", "port")]
    assert manifests[0] == manifests[1]

    flat = flatten(params)
    fp32 = {p for p, t in flat.items() if t.dtype == torch.float32}
    moe = {p for p in flat if "/moe/" in p}
    assert moe and all(flat[p].dtype == torch.float32 for p in moe if p.endswith("router/w"))
    assert all(flat[p].dtype == torch.bfloat16 and flat[p].dim() == 4 for p in moe
               if p.endswith(("/wi", "/wo", "/wg")))  # (blocks, E, ., .)
    if arch.startswith("jamba"):
        assert {p.rsplit("/", 1)[1] for p in fp32 if "/mamba/" in p} == {"A_log", "dt_bias", "D"}

    like = build(get_config(arch).scaled_down(param_dtype="bfloat16"), "cpu").init(
        torch.Generator().manual_seed(1))
    restored, step = restore_checkpoint(like, PosixConnector(str(tmp_path / "jax")), "ckpt")
    assert step == 1
    for path, leaf in flatten(restored).items():
        _same_bytes(leaf, flat[path])

    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jparams)
    jrestored, step = jax_restore(abstract, JaxPosix(str(tmp_path / "port")), "ckpt")
    assert step == 1
    want = flatten(jax.tree.map(np.asarray, jparams))
    for path, leaf in flatten(jax.tree.map(np.asarray, jrestored)).items():
        assert leaf.dtype == want[path].dtype and leaf.tobytes() == want[path].tobytes(), path
