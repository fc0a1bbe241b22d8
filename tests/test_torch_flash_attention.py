"""The port's flash attention (CPU path) against the JAX reference: the
Pallas kernel in interpret mode and the pure-jnp ``attention_ref``, on the
same numpy inputs."""

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
