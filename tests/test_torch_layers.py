"""The port's layers against ``repro.models.layers`` on the same numpy
inputs and parameters, in fp32 at the reference kernels' 2e-5."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro.configs import get_config as jax_get_config
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(arch="h2o-danube-3-4b", **overrides):
    """The same scaled-down config from the reference and from the port."""
    return (jax_get_config(arch).scaled_down(**overrides),
            get_config(arch).scaled_down(**overrides))


def _params(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_rmsnorm():
    x = _x((2, 5, 16))
    scale = _x((16,), 1)
    _close(tl.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-5),
           jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5))


@pytest.mark.parametrize("dh", [32, 120])
def test_apply_rope(dh):
    x = _x((2, 7, 3, dh))
    pos = np.random.default_rng(2).integers(0, 5000, (2, 7)).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "granite-20b"],
                         ids=["swiglu", "gelu"])
def test_mlp_apply(arch):
    jcfg, tcfg = _cfgs(arch)
    p = jl.mlp_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = _x((2, 5, jcfg.d_model))
    _close(tl.mlp_apply(_params(p), torch.from_numpy(x), tcfg),
           jl.mlp_apply(p, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "qwen1.5-0.5b", "granite-20b"])
def test_attention_apply(arch):
    jcfg, tcfg = _cfgs(arch, swa_window=24)
    p = jl.attention_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = _x((2, 40, jcfg.d_model), 3)
    out, (k, v) = tl.attention_apply(_params(p), torch.from_numpy(x), tcfg)
    jout, (jk, jv) = jl.attention_apply(p, jnp.asarray(x), jcfg)
    _close(out, jout)
    _close(k, jk)
    _close(v, jv)


def test_full_attention_impl():
    """attn_impl="full" is the plain full-matrix path, in both packages."""
    jcfg, tcfg = _cfgs(swa_window=24, attn_impl="full")
    p = jl.attention_init(jax.random.PRNGKey(4), jcfg, jnp.float32)
    x = _x((1, 40, jcfg.d_model), 5)
    out, _ = tl.attention_apply(_params(p), torch.from_numpy(x), tcfg)
    jout, _ = jl.attention_apply(p, jnp.asarray(x), jcfg)
    _close(out, jout)


@pytest.mark.parametrize("pos", [3, 20])
def test_attention_decode_window(pos):
    jcfg, tcfg = _cfgs(swa_window=8)  # at pos 20 the window cuts the cache
    p = jl.attention_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    B, S_max = 2, 24
    x = _x((B, 1, jcfg.d_model), 6)
    ck = _x((B, S_max, jcfg.n_kv_heads, jcfg.head_dim), 7)
    cv = _x((B, S_max, jcfg.n_kv_heads, jcfg.head_dim), 8)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out, tk2, tv2 = tl.attention_decode(_params(p), torch.from_numpy(x), tk, tv, pos, tcfg)
    jout, jk, jv = jl.attention_decode(p, jnp.asarray(x), jnp.asarray(ck),
                                       jnp.asarray(cv), pos, jcfg)
    _close(out, jout)
    _close(tk2, jk)
    _close(tv2, jv)
    assert tk2 is tk  # written in place


def test_layers_configs_match_reference():
    """The port's config copies equal the reference's field by field."""
    from repro.configs import ARCH_IDS
    for arch in ARCH_IDS:
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg), arch
