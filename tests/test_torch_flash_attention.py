"""The port's flash attention (CPU path) against the JAX reference: the
Pallas kernel in interpret mode and the pure-jnp ``attention_ref``, on the
same numpy inputs."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

#: B, Sq, Skv, H, KV, dh, causal, window: tests/test_kernels.py's ATTN_CASES
#: plus the full-width h2o-danube-3-4b head shape (32 heads, 8 kv, dh 120)
CASES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 128, 128, 4, 4, 128, True, None),
    (1, 96, 96, 8, 1, 32, True, None),
    (2, 64, 256, 4, 4, 48, False, None),
    (1, 256, 256, 4, 2, 64, True, 96),
    (1, 130, 130, 2, 2, 80, True, 64),
    (1, 64, 64, 32, 8, 120, True, 48),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(case, seed):
    B, Sq, Skv, H, KV, dh, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, dh), (B, Skv, KV, dh), (B, Skv, KV, dh))]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("case", CASES, ids=[f"a{i}" for i in range(len(CASES))])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_jax(case, dtype):
    *_, causal, window = case
    t_dt, j_dt, tol = DTYPES[dtype]
    arrays = _inputs(case, seed=sum(case[:6]))
    tq, tk, tv = (torch.from_numpy(a).to(t_dt) for a in arrays)
    jq, jk, jv = (jnp.asarray(a).astype(j_dt) for a in arrays)
    before = fa_kernel.launches
    got = _np(flash_attention(tq, tk, tv, causal=causal, window=window))
    assert fa_kernel.launches == before  # a CPU tensor never reaches the kernel
    for want in (jax_flash(jq, jk, jv, causal=causal, window=window),
                 jax_attention_ref(jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(got, _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=[f"a{i}" for i in range(len(CASES))])
def test_attention_ref_matches_jax(case):
    *_, causal, window = case
    arrays = _inputs(case, seed=1)
    got = attention_ref(*(torch.from_numpy(a) for a in arrays),
                        causal=causal, window=window)
    want = jax_attention_ref(*(jnp.asarray(a) for a in arrays),
                             causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_flash_attention_causality():
    """Future tokens must not influence earlier outputs."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 64, 64, 2, 2, 32, True, None), 3))
    base = flash_attention(q, k, v, causal=True, window=None)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:] = 99.0
    v2[:, 40:] = -99.0
    pert = flash_attention(q, k2, v2, causal=True, window=None)
    np.testing.assert_allclose(base[:, :40].numpy(), pert[:, :40].numpy(),
                               rtol=1e-6, atol=1e-6)


def _bf16(shape, offset=0):
    """A bf16 tensor of ``shape`` that starts ``offset`` elements into a
    fresh buffer (fresh CPU buffers are at least 16-byte aligned)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


def _qkv(B=2, S=64, H=4, KV=2, dh=64, offset=0):
    return (_bf16((B, S, H, dh), offset), _bf16((B, S, KV, dh), offset),
            _bf16((B, S, KV, dh), offset))


@pytest.mark.parametrize("name,make,want", [
    ("aligned", lambda: _qkv(), True),
    ("served_head_dim_120", lambda: _qkv(H=32, KV=8, dh=120), True),
    ("offset_one_element", lambda: _qkv(offset=1), False),
    ("offset_eight_elements", lambda: _qkv(offset=8), True),
    ("head_dim_20", lambda: _qkv(dh=20), False),
    ("float32", lambda: tuple(t.float() for t in _qkv()), False),
    # q sliced from a fused (B, S, 3H, dh) projection: strides stay 16-byte multiples
    ("fused_qkv_view", lambda: (_bf16((2, 64, 12, 64))[:, :, :4], *_qkv()[1:]), True),
    # a head-dim slice leaves 16-byte strides but a 20-column row: dh % 8 != 0
    ("head_dim_slice_20", lambda: tuple(t[..., :20] for t in _qkv()), False),
    # 8 columns of 12-element (24-byte) head rows: dh % 8 == 0, but a head
    # stride TMA cannot describe
    ("head_stride_24_bytes", lambda: (_bf16((2, 64, 4, 12))[..., :8],
                                      *[t[..., :8] for t in _qkv()[1:]]), False),
    # a dimension of size 1 may carry any stride
    ("size_one_dims", lambda: (_bf16((1, 64, 8)).unsqueeze(2).expand(1, 64, 1, 8),
                               _bf16((1, 64, 1, 8)), _bf16((1, 64, 1, 8))), True),
    ("broadcast_batch", lambda: (_bf16((1, 64, 4, 64)).expand(2, 64, 4, 64),
                                 *_qkv()[1:]), False),
])
def test_tma_path_choice(name, make, want):
    """The wrapper sends bf16 inputs TMA can describe (16-byte aligned data,
    strides of 16-byte multiples, dh % 8 == 0) to the TMA kernel and the
    rest to the mma.sync kernel; the choice reads dtypes, shapes, strides
    and pointers only, so it is the same on the CPU."""
    q, k, v = make()
    assert fa_kernel.tma_path(q, k, v) is want


def test_tma_path_leaves_cpu_dispatch_alone():
    """CPU tensors still take the plain chunked version whatever the path
    choice says, and no launch count moves."""
    q, k, v = (t.float().normal_(generator=torch.Generator().manual_seed(0)).bfloat16()
               for t in _qkv(B=1, S=32, H=2, KV=1, dh=16, offset=1))
    def counts():
        return (fa_kernel.launches, fa_kernel.tma_launches, fa_kernel.sync_launches,
                fa_kernel.f32_launches)

    before = counts()
    got = flash_attention(q, k, v, causal=True, window=None)
    assert counts() == before
    want = attention_ref(q, k, v, causal=True, window=None)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def _ablation_script():
    path = Path(__file__).resolve().parents[1] / "scripts" / "flash_ablation_torch.py"
    spec = importlib.util.spec_from_file_location("flash_ablation_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["exp2f", "one_chain", "no_pingpong", "box_past_dh",
                                  "grid_per_item", "no_softmax", "loads_only"])
def test_ablation_variant_edits_kernel_source(name):
    """scripts/flash_ablation_torch.py's changed copies of the kernel source
    still find, as often as they expect, the statements they change: each
    differs from the source, and only on the lines it names."""
    from repro_torch.kernels import _build

    abl = _ablation_script()
    src = (_build.PKG_DIR / fa_kernel.SOURCE).read_text()
    got = abl.variants(src)
    assert got["full"] == src and got[name] != src
    for pat, repl, want in abl.EDITS[name]:
        assert len(re.findall(pat, src)) == want
    added = set(got[name].splitlines()) - set(src.splitlines())
    assert added and all(any(repl in line for _, repl, _ in abl.EDITS[name]) for line in added)
