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


def _attn_inputs(B=2, S=40, H=4, KV=2, dh=16, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, n, dh)).astype(np.float32) for n in (H, KV, KV)]


def test_attn_accum_bf16_matches_jax():
    """``attn_accum_bf16`` (P.V and the accumulator in bf16) in the port's
    plain chunked attention, against the reference's.  Both round the same
    fp32 values to bf16, so they agree to a bf16 rounding of the
    accumulator (2^-8 of it) per chunk, and both land further than that
    from the fp32 accumulation."""
    q, k, v = _attn_inputs()
    kw = dict(causal=True, window=24, chunk=16)
    got = tl.chunked_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw,
                               accum_bf16=True)
    want = jl.chunked_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw, accum_bf16=True)
    f32 = jl.chunked_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    err = np.abs(got.numpy() - np.asarray(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2**-7, atol=2**-8)
    assert err.max() < 0.5 * np.abs(np.asarray(f32) - np.asarray(want)).max()


def test_attn_accum_bf16_reaches_model_and_backward():
    """``cfg.attn_accum_bf16`` reaches the layer's attention and the plain
    backward that ``FlashAttention`` recomputes: the layer's output and the
    gradient of q match the reference's chunked path with bf16
    accumulation."""
    jcfg, tcfg = _cfgs(swa_window=24, attn_accum_bf16=True)
    p = jl.attention_init(jax.random.PRNGKey(6), jcfg, jnp.float32)
    x = _x((2, 40, jcfg.d_model), 10)
    out, _ = tl.attention_apply(_params(p), torch.from_numpy(x), tcfg)
    jout, _ = jl.attention_apply(p, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=2**-7, atol=2**-8)
    q, k, v = _attn_inputs(seed=11)
    kw = dict(causal=True, window=24, cfg=tcfg)
    tq = torch.from_numpy(q).requires_grad_()
    from repro_torch.kernels.flash_attention.ops import flash_attention_auto
    (flash_attention_auto(tq, torch.from_numpy(k), torch.from_numpy(v), **kw) ** 2).sum().backward()
    jgrad = jax.grad(lambda a: (jl.chunked_attention(
        a, jnp.asarray(k), jnp.asarray(v), causal=True, window=24,
        chunk=min(jcfg.attn_chunk, k.shape[1]), accum_bf16=True) ** 2).sum())(jnp.asarray(q))
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgrad), rtol=2**-6, atol=2**-6)


def test_attn_accum_bf16_raises_off_the_cpu():
    """The Hopper kernel accumulates in fp32: off the CPU, ``attn_accum_bf16``
    raises before any kernel runs rather than compute fp32."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_auto
    _, tcfg = _cfgs(attn_accum_bf16=True)
    q, k, v = (torch.empty((1, 8, n, 16), device="meta") for n in (4, 2, 2))
    with pytest.raises(NotImplementedError, match="attn_accum_bf16"):
        flash_attention_auto(q, k, v, causal=True, window=None, cfg=tcfg)


def test_attn_shard_constraints_raises():
    """The reference pins q, k, v to a sharding; the port has none yet
    (A12), so the toggle raises instead of being ignored."""
    _, tcfg = _cfgs(attn_shard_constraints=True)
    jcfg = _cfgs()[0]
    p = jl.attention_init(jax.random.PRNGKey(7), jcfg, jnp.float32)
    x = torch.from_numpy(_x((1, 8, jcfg.d_model), 12))
    with pytest.raises(NotImplementedError, match="A12"):
        tl.attention_apply(_params(p), x, tcfg)


def test_remat_dots_raises():
    """``remat="dots"`` is the reference's selective checkpoint policy; the
    port has only whole-block remat, so it raises rather than run without
    any remat."""
    from repro_torch.models import transformer as ttf
    from repro_torch.models.registry import build
    _, tcfg = _cfgs(remat="dots")
    api = build(dataclasses.replace(tcfg, remat="block"), "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="selective"):
        ttf.final_hidden(params, batch, tcfg)
