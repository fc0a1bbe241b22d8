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


def test_attn_accum_bf16_on_meta():
    """The dry run counts ``attn_accum_bf16`` cells: on ``meta`` the
    dispatcher runs the plain chunked form with bf16 accumulation, whose
    output has q's shape and dtype, and launches no kernel."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention_auto
    _, tcfg = _cfgs(attn_accum_bf16=True)
    q, k, v = (torch.empty((2, 96, n, 16), device="meta") for n in (4, 2, 2))
    before = fa_kernel.launches
    out = flash_attention_auto(q, k, v, causal=True, window=None, cfg=tcfg)
    want = tl.chunked_attention(q, k, v, causal=True, chunk=min(tcfg.attn_chunk, 96),
                             accum_bf16=True)
    assert out.device.type == "meta" and out.shape == want.shape == q.shape
    assert out.dtype == want.dtype == q.dtype
    assert fa_kernel.launches == before


@pytest.mark.parametrize("accum", [False, True])
def test_attn_accum_bf16_sends_its_chunk_to_the_kernel(monkeypatch, accum):
    """On CUDA the dispatcher hands the kernel ``accum_chunk``: the model's
    KV chunk, ``min(attn_chunk, Skv)``, under ``attn_accum_bf16`` (the
    kernel then accumulates in bf16 over chunks of that size), else 0."""
    from types import SimpleNamespace
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops
    calls = []
    monkeypatch.setattr(fa_kernel, "flash_attention_fwd",
                        lambda q, k, v, **kw: calls.append(kw) or "launched")
    q = SimpleNamespace(device=torch.device("cuda", 0))
    got = ops._dispatch(q, None, None, causal=True, window=7, chunk=48, accum_bf16=accum)
    assert got == "launched"
    assert calls == [{"causal": True, "window": 7, "accum_chunk": 48 if accum else 0}]


@pytest.mark.parametrize("impl", ["chunked", "full"])
def test_attn_shard_constraints_match_jax(impl):
    """``attn_shard_constraints`` pins q, k, v (and the chunked path's k, v)
    under the active sharding rules; with none installed the pins are the
    identity in both packages, so the toggled layer equals JAX's toggled
    layer (a 2x2 mesh's pins are in tests/test_torch_cells.py)."""
    jcfg, tcfg = _cfgs(attn_shard_constraints=True, attn_impl=impl)
    p = jl.attention_init(jax.random.PRNGKey(7), jcfg, jnp.float32)
    x = _x((2, 24, jcfg.d_model), 12)
    out, (k, v) = tl.attention_apply(_params(p), torch.from_numpy(x), tcfg)
    jout, (jk, jv) = jl.attention_apply(p, jnp.asarray(x), jcfg)
    _close(out, jout, rtol=1e-4, atol=1e-4)
    _close(k, jk, rtol=1e-4, atol=1e-4)
    _close(v, jv, rtol=1e-4, atol=1e-4)


def test_cross_attention_apply():
    """``x_kv``: keys and values from the encoder output, no RoPE, every
    encoder position visible (the reference's plain ``full_attention``)."""
    jcfg, tcfg = _cfgs("whisper-medium")
    p = jl.attention_init(jax.random.PRNGKey(8), jcfg, jnp.float32)
    x, x_kv = _x((2, 10, jcfg.d_model), 13), _x((2, 24, jcfg.d_model), 14)
    out, (k, v) = tl.attention_apply(_params(p), torch.from_numpy(x), tcfg, causal=False,
                                     x_kv=torch.from_numpy(x_kv))
    jout, (jk, jv) = jl.attention_apply(p, jnp.asarray(x), jcfg, causal=False,
                                        x_kv=jnp.asarray(x_kv))
    assert tuple(k.shape) == (2, 24, jcfg.n_kv_heads, jcfg.head_dim)
    _close(out, jout)
    _close(k, jk)
    _close(v, jv)


def test_cross_attention_decode():
    """``cross_kv``: one token against every encoder position, no RoPE, and
    the self-attention caches are neither read nor written."""
    jcfg, tcfg = _cfgs("whisper-medium")
    p = jl.attention_init(jax.random.PRNGKey(9), jcfg, jnp.float32)
    x = _x((2, 1, jcfg.d_model), 15)
    ck = _x((2, 24, jcfg.n_kv_heads, jcfg.head_dim), 16)
    cv = _x((2, 24, jcfg.n_kv_heads, jcfg.head_dim), 17)
    out, _, _ = tl.attention_decode(_params(p), torch.from_numpy(x), None, None, 5, tcfg,
                                    cross_kv=(torch.from_numpy(ck), torch.from_numpy(cv)))
    jout, _, _ = jl.attention_decode(p, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), 5,
                                     jcfg, cross_kv=(jnp.asarray(ck), jnp.asarray(cv)))
    _close(out, jout)


def test_encode():
    """The encoder stack alone: non-causal blocks with RoPE, then enc_norm."""
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf
    jcfg, tcfg = _cfgs("whisper-medium")
    jparams = jtf.init_params(jax.random.PRNGKey(10), jcfg)
    audio = _x((2, jcfg.encdec.n_audio_ctx, jcfg.d_model), 18)
    with torch.inference_mode():
        got = ttf._encode(_params(jparams), torch.from_numpy(audio), tcfg)
    _close(got, jtf._encode(jparams, jnp.asarray(audio), jcfg))


def _vlm_embed(S, seed):
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf
    jcfg, tcfg = _cfgs("llava-next-mistral-7b")
    jparams = jtf.init_params(jax.random.PRNGKey(11), jcfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    img = _x((2, jcfg.vlm.n_image_tokens, jcfg.vlm.patch_dim), seed + 1)
    jbatch = {"tokens": jnp.asarray(tokens), "image_embeds": jnp.asarray(img)}
    tbatch = {"tokens": torch.from_numpy(tokens), "image_embeds": torch.from_numpy(img)}
    return (lambda: jtf._embed(jparams, jbatch["tokens"], jcfg, jbatch),
            lambda: ttf._embed(_params(jparams), tbatch["tokens"], tcfg, tbatch))


def test_embed_splices_image_embeddings():
    """llava: the first n_image_tokens positions are the projected image
    embeddings, the rest the token embeddings."""
    jfn, tfn = _vlm_embed(S=24, seed=19)
    got = tfn()
    _close(got, jfn())
    assert tuple(got.shape) == (2, 24, 128)


def test_embed_refuses_prompt_shorter_than_image():
    """A prompt shorter than its image positions fails in the reference
    (``dynamic_update_slice``'s shape check) and raises ValueError in the
    port, naming both lengths."""
    jfn, tfn = _vlm_embed(S=10, seed=21)
    with pytest.raises(Exception):
        jfn()
    with pytest.raises(ValueError, match="10 tokens .* 16 image positions"):
        tfn()
