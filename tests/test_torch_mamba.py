"""The port's mamba2 mixer (jamba's SSM layers) against the reference's
``repro.models.transformer`` on the same numpy inputs and the reference's
own parameters, in fp32 at rtol = atol = 1e-4: ``_causal_conv`` with and
without a carried state, ``mamba_apply`` fresh and carried (outputs, the
``ssm`` and ``conv`` states), ``mamba_decode``, each also with a d_state of
24 against a head_dim of 16 (at the scaled-down default both are 16, so a
K / V swap in the state would pass unseen); the scan op's scalar-decay path
and its gradient against ``jax.grad`` of the reference's
``ssm_scan_chunked(..., scalar_decay=True)``; the whole jamba model with
d_state 24; and the kernel wrapper's reading of mamba's layout in place."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import flatten, params_from_jax, unflatten
from repro_torch.models.registry import build

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "jamba-1.5-large-398b"


def _cfgs(d_state=16):
    """jamba scaled down in both packages; ``d_state`` other than the
    head_dim of 16 gives K != V in the scan and the state."""
    def cut(cfg):
        cfg = cfg.scaled_down()
        return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, d_state=d_state))
    return cut(jax_get_config(ARCH)), cut(get_config(ARCH))


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _params(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=what, **TOL)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried_state"])
def test_causal_conv_matches_jax(carried):
    x, w = _x((2, 9, 12), 0), _x((4, 12), 1, 0.5)
    state = _x((2, 3, 12), 2) if carried else None
    got = ttf._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           None if state is None else torch.from_numpy(state))
    want = jtf._causal_conv(jnp.asarray(x), jnp.asarray(w),
                            None if state is None else jnp.asarray(state))
    _close(got, want)


@pytest.mark.parametrize("d_state", [16, 24], ids=["K16", "K24"])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried_state"])
def test_mamba_apply_matches_jax(carried, d_state):
    jcfg, tcfg = _cfgs(d_state)
    p = jtf.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    d_inner, H = jtf._mamba_dims(jcfg)
    B, S = 2, 40  # 40 pads the chunked scan (chunk 16)
    x = _x((B, S, jcfg.d_model), 1)
    state = ((_x((B, H, d_state, jcfg.ssm.head_dim), 2, 0.3),
              _x((B, jcfg.ssm.d_conv - 1, d_inner), 3)) if carried else None)
    out, (s, conv) = ttf.mamba_apply(_params(p), torch.from_numpy(x), tcfg,
                                     state=None if state is None
                                     else tuple(torch.from_numpy(t) for t in state))
    jout, (js, jconv) = jtf.mamba_apply(p, jnp.asarray(x), jcfg,
                                        state=None if state is None
                                        else tuple(jnp.asarray(t) for t in state))
    assert tuple(s.shape) == (B, H, d_state, jcfg.ssm.head_dim) and s.dtype == torch.float32
    _close(out, jout, "out")
    _close(s, js, "ssm")
    _close(conv, jconv, "conv")


@pytest.mark.parametrize("d_state", [16, 24], ids=["K16", "K24"])
def test_mamba_decode_matches_jax(d_state):
    jcfg, tcfg = _cfgs(d_state)
    p = jtf.mamba_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    d_inner, H = jtf._mamba_dims(jcfg)
    B = 3
    x = _x((B, 1, jcfg.d_model), 4)
    state = (_x((B, H, d_state, jcfg.ssm.head_dim), 5, 0.3),
             _x((B, jcfg.ssm.d_conv - 1, d_inner), 6))
    out, (s, conv) = ttf.mamba_decode(_params(p), torch.from_numpy(x), tcfg,
                                      tuple(torch.from_numpy(t) for t in state))
    jout, (js, jconv) = jtf.mamba_decode(p, jnp.asarray(x), jcfg,
                                         tuple(jnp.asarray(t) for t in state))
    _close(out, jout, "out")
    _close(s, js, "ssm")
    _close(conv, jconv, "conv")


def test_mamba_params_keep_fp32_leaves():
    """In a bf16 tree ``A_log``, ``dt_bias`` and ``D`` are fp32, in the port's
    own init as in the reference's, with the reference's paths and shapes."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    want = flatten(jax.tree.map(np.asarray,
                                jtf.mamba_init(jax.random.PRNGKey(2), jcfg, jnp.bfloat16)))
    own = flatten(ttf.mamba_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16))
    assert list(own) == list(want)
    for path, leaf in want.items():
        assert tuple(own[path].shape) == leaf.shape, path
        assert own[path].dtype == (torch.float32 if leaf.dtype == np.float32
                                   else torch.bfloat16), path
    assert {p for p, leaf in want.items() if leaf.dtype == np.float32} == {"A_log", "D",
                                                                            "dt_bias"}
    np.testing.assert_allclose(own["A_log"].numpy(), want["A_log"], rtol=1e-6)
    for name in ("dt_bias", "D"):
        np.testing.assert_array_equal(own[name].numpy(), want[name])


def _scan_inputs(B=2, T=40, H=3, K=8, V=6, seed=7):
    """mamba's scan operands as numpy: C_t and B_t (B, T, K), one log decay
    per (b, t, h), v and an initial state."""
    c, b = _x((B, T, K), seed, 0.5), _x((B, T, K), seed + 1, 0.5)
    g = -np.exp(_x((B, T, H, 1), seed + 2) - 1.5)
    return c, b, _x((B, T, H, V), seed + 3, 0.5), g, _x((B, H, K, V), seed + 4, 0.3)


def test_scan_scalar_decay_matches_per_key_path():
    """``scalar_decay=True`` takes the (R, R, H) path and gives what the
    per-key path gives with the decay broadcast over K (the default for a
    (B, T, H, 1) decay), and what the reference's scalar path gives."""
    c, b, v, g, s0 = _scan_inputs()
    H, K = v.shape[2], c.shape[-1]
    q, k = (torch.from_numpy(t)[:, :, None].expand(-1, -1, H, -1) for t in (c, b))
    outs = [ssm_scan(q, k, torch.from_numpy(v), torch.from_numpy(g), None, torch.from_numpy(s0),
                     chunk=16, subchunk=8, scalar_decay=sd) for sd in (True, False)]
    jq, jk = (jnp.broadcast_to(jnp.asarray(t)[:, :, None], q.shape) for t in (c, b))
    jy, js = jssm.ssm_scan_chunked(jq, jk, jnp.asarray(v), jnp.asarray(g),
                                   initial_state=jnp.asarray(s0), chunk=16, subchunk=8,
                                   scalar_decay=True)
    for y, s in outs:
        _close(y, jy, "y")
        _close(s, js, "state")
    assert K != v.shape[-1]


@pytest.mark.parametrize("outputs", ["y", "y_and_state"])
def test_scan_scalar_decay_grads_match_jax(outputs):
    """Gradients through ``SSMScan``'s plain backward with mamba's layout
    (q and k expanded views of (B, T, K) rows, g of (B, T, H, 1)) against
    ``jax.grad`` of the reference's scalar-decay chunked form; the decay's
    gradient comes back in its own (B, T, H, 1) shape."""
    c, b, v, g, s0 = _scan_inputs(T=36)
    H = v.shape[2]
    wy = _x((2, 36, H, v.shape[-1]), 20)
    ws = _x(s0.shape, 21) if outputs == "y_and_state" else None

    def jloss(c, b, v, g, s0):
        q, k = (jnp.broadcast_to(t[:, :, None], (*t.shape[:2], H, t.shape[-1])) for t in (c, b))
        y, s = jssm.ssm_scan_chunked(q, k, v, g, initial_state=s0, chunk=16, subchunk=4,
                                     scalar_decay=True)
        return jnp.sum(y * wy) + (0.0 if ws is None else jnp.sum(s * ws))

    want = jax.grad(jloss, argnums=range(5))(*(jnp.asarray(t) for t in (c, b, v, g, s0)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (c, b, v, g, s0)]
    q, k = (t[:, :, None].expand(-1, -1, H, -1) for t in leaves[:2])
    y, s = ssm_scan(q, k, leaves[2], leaves[3], None, leaves[4], chunk=16, subchunk=4,
                    scalar_decay=True)
    loss = (y * torch.from_numpy(wy)).sum() + (0 if ws is None else (s * torch.from_numpy(ws)).sum())
    got = torch.autograd.grad(loss, leaves)
    assert got[3].shape == (2, 36, H, 1)
    for name, gt, gw in zip(("C", "B", "v", "g", "s0"), got, want):
        _close(gt, gw, name)


def test_kernel_wrapper_reads_mamba_layout_in_place():
    """What the kernel wrapper hands the kernel for mamba's operands: q and
    k as they are, with a head stride of 0 and 16-byte rows; g as one value
    per (b, t, h), whether it comes as (B, T, H, 1) or broadcast over K.  A
    last axis without unit stride is copied, and only then."""
    B, T, H, K = 2, 40, 3, 8
    c = torch.zeros((B, T, K))
    q = c[:, :, None].expand(B, T, H, K)
    assert ssm_kernel._rows(q) is q
    assert ssm_kernel._strides(q) == [T * K, K, 0]
    assert ssm_kernel._vec(q, K) == int(c.data_ptr() % 16 == 0)
    assert ssm_kernel._vec(c[:, :, 1:].unsqueeze(2), K - 1) == 0  # rows off 16 bytes
    g = torch.zeros((B, T, H, 1))
    assert ssm_kernel._strides(g) == [T * H, H, 1]
    assert ssm_kernel._strides(g.expand(B, T, H, K)) == [T * H, H, 1]
    assert g.expand(B, T, H, K).stride(3) == 0
    t = torch.zeros((B, T, K, H)).transpose(2, 3)
    assert ssm_kernel._rows(t) is not t and ssm_kernel._rows(t).is_contiguous()


def _model(d_state, seed):
    jcfg, tcfg = _cfgs(d_state)
    japi = jax_build(jcfg)
    jparams = jax.jit(japi.init)(jax.random.PRNGKey(seed))
    return japi, jparams, build(tcfg, "cpu"), _params(jparams)


def test_jamba_prefill_decode_d_state_24():
    """The whole hybrid stack with K = 24 != V = 16: prefill logits and every
    cache (attention, ``ssm``, ``conv``), then greedy decode steps."""
    japi, jparams, api, params = _model(24, seed=3)
    B, S, steps = 2, 24, 3
    tokens = np.random.default_rng(3).integers(0, api.cfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, jcache, _ = jax.jit(lambda p, b: japi.prefill(p, b, pad_to=S + steps))(
        jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        logits, cache, _ = api.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                       pad_to=S + steps)
    _close(logits, jlogits, "prefill logits")
    assert set(cache) == set(jcache) == {"attn_k", "attn_v", "ssm", "conv"}
    for key in cache:
        assert cache[key].shape == jcache[key].shape, key
        _close(cache[key], jcache[key], key)
    ref_cache = ttf.make_decode_cache(api.cfg, B, S + steps, "cpu")
    assert {k: tuple(v.shape) for k, v in ref_cache.items()} == \
        {k: tuple(v.shape) for k, v in cache.items()}
    tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(steps):
        jlogits, jcache = jax.jit(japi.decode)(jparams, jcache, jnp.asarray(tok),
                                               jnp.int32(S + i))
        with torch.inference_mode():
            logits, cache = api.decode(params, cache, torch.from_numpy(tok), S + i)
        _close(logits, jlogits, f"decode step {i}")
        tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)[:, None]
    for key in ("ssm", "conv"):
        _close(cache[key], jcache[key], key)


def test_jamba_loss_and_grads_d_state_24():
    japi, jparams, api, params = _model(24, seed=4)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, api.cfg.vocab_size, (2, 64)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -1, np.int32)], axis=1)
    batch = {"tokens": tokens, "labels": labels}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {k: v.requires_grad_() for k, v in flatten(params).items()}
    loss, m = api.loss(unflatten(params, leaves), {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _close(loss, jloss, "loss")
    _close(m["moe_aux"], jm["moe_aux"], "moe_aux")
    want = flatten(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    for path, g in want.items():
        _close(grads[path], g, path)
