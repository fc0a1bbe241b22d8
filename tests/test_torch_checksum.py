"""The port's lanesum32 checksum (CPU path) against the JAX reference: the
Pallas kernel in interpret mode, its jnp path and the numpy ``digest_ref``,
bit-exact on the same numpy inputs.  Also the port's own numpy copy of
``digest_ref`` and the device dispatch of ``checksum_digests``."""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro.kernels.checksum.ops import checksum_digest as jax_digest
from repro.kernels.checksum.ref import digest_ref as jax_digest_ref
from repro_torch.kernels.checksum import kernel as cs_kernel
from repro_torch.kernels.checksum import ref as cs_ref
from repro_torch.kernels.checksum.ops import checksum_digest, checksum_digests
from repro_torch.kernels.checksum.ref import digest_ref

#: tests/test_kernels.py's six shape and dtype pairs
KERNEL_CASES = [((1024,), "float32"), ((8, 128), "float32"), ((1000,), "float32"),
                ((333,), "int32"), ((64, 9), "bfloat16"), ((5,), "float32")]


def _array(shape, dtype, seed=0):
    """(numpy array for JAX, torch tensor) holding the same bytes."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        j = jnp.asarray(x).astype(jnp.bfloat16)
        raw = np.asarray(j).view(np.uint16)
        return j, torch.from_numpy(raw.copy()).view(torch.bfloat16)
    x = x.astype(dtype)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _all_agree(j, t):
    want = jax_digest_ref(np.asarray(j).tobytes())
    got = checksum_digest(t)
    assert jax_digest(j, use_pallas=True) == want
    assert jax_digest(j, use_pallas=False) == want
    assert digest_ref(t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()) == want
    assert got == want
    return got


@pytest.mark.parametrize("shape,dtype", KERNEL_CASES)
def test_digest_matches_jax(shape, dtype):
    _all_agree(*_array(shape, dtype))


@pytest.mark.parametrize("nbytes", [1, 2, 3, 5, 7])
def test_digest_tail_bytes(nbytes):
    b = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8)
    _all_agree(jnp.asarray(b), torch.from_numpy(b.copy()))


def test_digest_odd_bf16_and_scalar():
    _all_agree(*_array((37,), "bfloat16", seed=3))
    _all_agree(jnp.asarray(np.int32(-7)), torch.tensor(-7, dtype=torch.int32))


def test_digest_of_views_is_of_row_major_bytes():
    """A transposed tensor and a view at a storage offset digest as the
    row-major bytes they hold, as the reference digests ``x.T`` and
    ``x[3:]``."""
    j, t = _array((24, 40), "float32", seed=4)
    _all_agree(j.T, t.T)
    jb, tb = _array((101,), "bfloat16", seed=5)
    view = tb[3:]
    assert view.storage_offset() == 3
    _all_agree(jb[3:], view)


def test_digest_detects_single_bitflip():
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    d0 = checksum_digest(torch.from_numpy(x))
    raw = bytearray(x.tobytes())
    raw[1234] ^= 0x01
    x2 = np.frombuffer(bytes(raw), np.float32)
    d1 = checksum_digest(torch.from_numpy(x2.copy()))
    assert d1 != d0
    assert d1 == jax_digest(jnp.asarray(x2))


def test_plain_versions_across_chunks(monkeypatch):
    """The chunked plain versions carry the word index across chunks."""
    monkeypatch.setattr(cs_ref, "CHUNK_WORDS", 7)
    b = np.random.default_rng(6).integers(0, 256, 4 * 50 + 3, dtype=np.uint8)
    want = jax_digest_ref(b.tobytes())
    assert digest_ref(b.tobytes()) == want
    assert checksum_digest(torch.from_numpy(b.copy())) == want


def test_batched_digests_and_dispatch():
    xs = [_array(s, d, seed=i)[1] for i, (s, d) in enumerate(KERNEL_CASES)]
    before = cs_kernel.launches
    assert checksum_digests(xs) == [checksum_digest(x) for x in xs]
    assert cs_kernel.launches == before  # the CPU path launches nothing
    assert checksum_digests([]) == []
    with pytest.raises(ValueError, match="no path"):
        checksum_digest(torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        cs_kernel.lanesum32_into(torch.zeros(4), torch.zeros(2, dtype=torch.int32))
