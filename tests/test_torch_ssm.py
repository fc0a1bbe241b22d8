"""The port's gated linear recurrence and rwkv6 layers against the JAX
reference on the same numpy inputs, in fp32: ``ssm_scan`` (the CPU path)
against the reference's Pallas kernel in interpret mode and its
``ssm_scan_ref``; the plain versions and the decode step against theirs; the
rwkv6 time mix and channel mix against ``repro.models.transformer``."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

from repro.configs import get_config as jax_get_config
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_chunked, ssm_scan_ref
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build

#: B, T, H, K, V, use_u, chunk, sub: tests/test_kernels.py's SSM_CASES
SSM_CASES = [
    (2, 64, 3, 8, 16, False, 32, 8),
    (1, 128, 2, 16, 16, False, 64, 16),
    (2, 48, 2, 8, 8, True, 16, 8),
    (1, 40, 4, 8, 8, True, 16, 4),          # pad path (40 % 16 != 0)
    (1, 256, 1, 32, 32, False, 128, 16),
]
TOL = dict(rtol=3e-5, atol=3e-5)            # tests/test_kernels.py's
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(B, T, H, K, V, seed, scalar=False, decay_scale=1.5):
    """q, k, v, g, s0, u as fp32 numpy, distributed as tests/test_kernels.py's
    ``_ssm_inputs`` draws them."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, T, H, K)) * 0.5 for _ in range(2))
    v = rng.standard_normal((B, T, H, V)) * 0.5
    g = -np.exp(rng.standard_normal((B, T, H, 1 if scalar else K)) - decay_scale)
    g = np.broadcast_to(g, (B, T, H, K))
    s0 = rng.standard_normal((B, H, K, V)) * 0.3
    u = rng.standard_normal((H, K)) * 0.5
    return [np.ascontiguousarray(x, dtype=np.float32) for x in (q, k, v, g, s0, u)]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("case", SSM_CASES, ids=[f"s{i}" for i in range(len(SSM_CASES))])
def test_ssm_scan_matches_jax(case):
    B, T, H, K, V, use_u, chunk, sub = case
    q, k, v, g, s0, u = _inputs(B, T, H, K, V, seed=T + K)
    uu = u if use_u else None
    launches = ssm_kernel.launches
    y, s = ssm_scan(*_t(q, k, v, g), u=None if uu is None else torch.from_numpy(uu),
                    initial_state=torch.from_numpy(s0), chunk=chunk, subchunk=sub)
    assert ssm_kernel.launches == launches  # a CPU tensor takes the plain path
    assert y.shape == (B, T, H, V) and s.dtype == torch.float32
    jy, js = jax_ssm_scan(*_j(q, k, v, g), u=None if uu is None else jnp.asarray(uu),
                          initial_state=jnp.asarray(s0), chunk=chunk, subchunk=sub)
    _close(y, jy)
    _close(s, js)
    ry, rs = jssm.ssm_scan_ref(*_j(q, k, v, g), u=None if uu is None else jnp.asarray(uu),
                               initial_state=jnp.asarray(s0))
    _close(y, ry)
    _close(s, rs)


def test_ssm_scan_strong_decay():
    """Strong decays (rwkv-style, log decay about -4.5 a step) must not
    overflow the chunked form (tests/test_kernels.py's stability case)."""
    q, k, v, g, s0, u = _inputs(1, 64, 2, 8, 8, seed=0, decay_scale=-1.5)
    y, s = ssm_scan(*_t(q, k, v, g), u=torch.from_numpy(u),
                    initial_state=torch.from_numpy(s0), chunk=32, subchunk=8)
    assert torch.isfinite(y).all()
    ry, rs = jssm.ssm_scan_ref(*_j(q, k, v, g), u=jnp.asarray(u), initial_state=jnp.asarray(s0))
    _close(y, ry, rtol=1e-4, atol=1e-4)
    _close(s, rs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_u", [False, True], ids=["inclusive", "bonus"])
def test_ssm_scan_scalar_decay(use_u):
    """g constant over K (mamba2's per-head decay): the op, and the plain
    chunked form's (R, R) scalar path, against JAX's."""
    q, k, v, g, s0, u = _inputs(2, 48, 3, 8, 8, seed=5, scalar=True)
    uu = u if use_u else None
    tu = None if uu is None else torch.from_numpy(uu)
    ju = None if uu is None else jnp.asarray(uu)
    jy, js = jax_ssm_scan(*_j(q, k, v, g), u=ju, initial_state=jnp.asarray(s0),
                          chunk=16, subchunk=8)
    # the op takes g of q's shape, or mamba's (B, T, H, 1) broadcast over K
    g1 = np.ascontiguousarray(g[..., :1])
    for gg in (g, g1):
        y, s = ssm_scan(*_t(q, k, v, gg), u=tu, initial_state=torch.from_numpy(s0),
                        chunk=16, subchunk=8)
        _close(y, jy)
        _close(s, js)
    # the plain chunked form's scalar path reads g with a last axis of 1
    y2, s2 = ssm_scan_chunked(*_t(q, k, v, g1), u=tu, initial_state=torch.from_numpy(s0),
                              chunk=16, subchunk=8, scalar_decay=True)
    jy2, js2 = jssm.ssm_scan_chunked(*_j(q, k, v, g1), u=ju, initial_state=jnp.asarray(s0),
                                     chunk=16, subchunk=8, scalar_decay=True)
    _close(y2, jy2)
    _close(s2, js2)


@pytest.mark.parametrize("use_u", [False, True], ids=["inclusive", "bonus"])
def test_ssm_plain_versions_match_jax(use_u):
    """``ssm_scan_ref`` and ``ssm_scan_chunked`` (no initial state, a T that
    pads) against the reference's, function by function."""
    q, k, v, g, _, u = _inputs(2, 37, 2, 8, 16, seed=9)
    tu = torch.from_numpy(u) if use_u else None
    ju = jnp.asarray(u) if use_u else None
    for got, want in ((ssm_scan_ref(*_t(q, k, v, g), u=tu),
                       jssm.ssm_scan_ref(*_j(q, k, v, g), u=ju)),
                      (ssm_scan_chunked(*_t(q, k, v, g), u=tu, chunk=16, subchunk=8),
                       jssm.ssm_scan_chunked(*_j(q, k, v, g), u=ju, chunk=16, subchunk=8))):
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("use_u", [False, True], ids=["inclusive", "bonus"])
def test_ssm_decode_step_matches_jax(use_u):
    q, k, v, g, s0, u = _inputs(2, 1, 3, 8, 16, seed=11)
    args = [x[:, 0] for x in (q, k, v, g)]
    y, s = tssm.ssm_decode_step(*_t(*args), torch.from_numpy(s0),
                                u=torch.from_numpy(u) if use_u else None)
    jy, js = jssm.ssm_decode_step(*_j(*args), jnp.asarray(s0),
                                  u=jnp.asarray(u) if use_u else None)
    _close(y, jy)
    _close(s, js)


def test_ssm_scan_rejects_subchunk_that_does_not_divide():
    q, k, v, g, _, _ = _inputs(1, 20, 1, 8, 8, seed=1)
    with pytest.raises(ValueError, match="must divide"):
        ssm_scan(*_t(q, k, v, g), chunk=20, subchunk=16)


def test_ssm_scan_cpu_path_is_differentiable():
    """The CPU path is plain PyTorch: its gradient is the step recurrence's."""
    q, k, v, g, s0, u = _inputs(1, 24, 2, 8, 8, seed=3)
    grads = []
    for fn in (lambda *a, **kw: ssm_scan(*a, **kw, chunk=8, subchunk=4), ssm_scan_ref):
        leaves = [t.requires_grad_() for t in _t(q, k, v, g, u, s0)]
        y, s = fn(*leaves[:4], u=leaves[4], initial_state=leaves[5])
        grads.append(torch.autograd.grad((y * y).sum() + s.sum(), leaves))
    for got, want in zip(*grads):
        _close(got, want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("where", ["chunked", "op", "model"])
def test_ssm_shard_constrain_raises(where):
    """The reference's sharding pin has no port yet: the plain function, the
    op and an rwkv6 model with ``ssm_shard_constraints`` refuse it (A12)."""
    q, k, v, g, _, _ = _inputs(1, 8, 1, 8, 8, seed=2)
    with pytest.raises(NotImplementedError, match="A12"):
        if where == "chunked":
            ssm_scan_chunked(*_t(q, k, v, g), shard_constrain=True)
        elif where == "op":
            ssm_scan(*_t(q, k, v, g), chunk=8, shard_constrain=True)
        else:
            cfg = dataclasses.replace(_rwkv_cfgs()[1], ssm_shard_constraints=True)
            api = build(cfg, "cpu")
            params = api.init(torch.Generator().manual_seed(0))
            api.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long)})


@pytest.mark.parametrize("use_u", [False, True], ids=["inclusive", "bonus"])
def test_ssm_scan_io_dtype_matches_jax(use_u):
    """``io_dtype=bfloat16`` (the reference's ``ssm_bf16_io``) rounds q, k, v
    to bf16 before the fp32 math, as the reference's chunked form does."""
    q, k, v, g, s0, u = _inputs(2, 40, 2, 8, 16, seed=13)
    tu = torch.from_numpy(u) if use_u else None
    ju = jnp.asarray(u) if use_u else None
    y, s = ssm_scan(*_t(q, k, v, g), u=tu, initial_state=torch.from_numpy(s0),
                    chunk=16, subchunk=8, io_dtype=torch.bfloat16)
    assert y.dtype == torch.float32
    jy, js = jssm.ssm_scan_chunked(*_j(q, k, v, g), u=ju, initial_state=jnp.asarray(s0),
                                   chunk=16, subchunk=8, io_dtype=jnp.bfloat16)
    _close(y, jy)
    _close(s, js)


# ---------------------------------------------------------------------------
# rwkv6 layers
# ---------------------------------------------------------------------------
def _rwkv_cfgs():
    return jax_get_config("rwkv6-7b").scaled_down(), get_config("rwkv6-7b").scaled_down()


def _params(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried_state"])
def test_rwkv_time_mix_matches_jax(carried):
    jcfg, tcfg = _rwkv_cfgs()
    p = jtf.rwkv_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    H, dh = jtf._rwkv_dims(jcfg)
    B, S = 2, 40  # 40 pads the chunked scan (chunk 16)
    x = _x((B, S, jcfg.d_model), 1)
    state = (_x((B, H, dh, dh), 2) * 0.3, _x((B, 1, jcfg.d_model), 3)) if carried else None
    out, (s, last) = ttf.rwkv_time_mix(
        _params(p), torch.from_numpy(x), tcfg,
        state=None if state is None else tuple(_t(*state)))
    jout, (js, jlast) = jtf.rwkv_time_mix(
        p, jnp.asarray(x), jcfg, state=None if state is None else tuple(_j(*state)))
    _close(out, jout, **LAYER_TOL)
    _close(s, js, **LAYER_TOL)
    _close(last, jlast, **LAYER_TOL)


def test_rwkv_time_mix_decode_matches_jax():
    jcfg, tcfg = _rwkv_cfgs()
    p = jtf.rwkv_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    H, dh = jtf._rwkv_dims(jcfg)
    B = 3
    x, s0, prev = _x((B, 1, jcfg.d_model), 4), _x((B, H, dh, dh), 5) * 0.3, \
        _x((B, 1, jcfg.d_model), 6)
    out, (s, last) = ttf.rwkv_time_mix_decode(_params(p), torch.from_numpy(x), tcfg,
                                              tuple(_t(s0, prev)))
    jout, (js, jlast) = jtf.rwkv_time_mix_decode(p, jnp.asarray(x), jcfg, tuple(_j(s0, prev)))
    _close(out, jout, **LAYER_TOL)
    _close(s, js, **LAYER_TOL)
    _close(last, jlast, **LAYER_TOL)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried_state"])
def test_cmix_apply_matches_jax(carried):
    jcfg, tcfg = _rwkv_cfgs()
    p = jtf.cmix_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    x = _x((2, 9, jcfg.d_model), 7)
    prev = _x((2, 1, jcfg.d_model), 8) if carried else None
    out, last = ttf.cmix_apply(_params(p), torch.from_numpy(x), tcfg,
                               state=None if prev is None else torch.from_numpy(prev))
    jout, jlast = jtf.cmix_apply(p, jnp.asarray(x), jcfg,
                                 state=None if prev is None else jnp.asarray(prev))
    _close(out, jout, **LAYER_TOL)
    _close(last, jlast, **LAYER_TOL)


def test_rwkv_params_keep_fp32_leaves():
    """In a bf16 tree, ``u`` and ``decay_bias`` arrive fp32 and byte for
    byte; there is no option to cast the tree to one dtype."""
    jcfg = jax_get_config("rwkv6-7b").scaled_down(param_dtype="bfloat16")
    p = jax.tree.map(np.asarray, jtf.rwkv_init(jax.random.PRNGKey(3), jcfg, jnp.bfloat16))
    got = params_from_jax(p, "cpu")
    assert got["wr"]["w"].dtype == torch.bfloat16
    for name in ("u", "decay_bias"):
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), p[name])
    with pytest.raises(TypeError):
        params_from_jax(p, "cpu", dtype=torch.float32)


@pytest.mark.parametrize("arch,item", [("jamba-1.5-large-398b", "A10"),
                                       ("dbrx-132b", "A10"),
                                       ("whisper-medium", "A11")])
def test_pending_layer_kinds_raise(arch, item):
    """The mamba mixer, MoE and cross-attention raise from the model code
    too (``_layer_kinds``), naming their ROADMAP item."""
    cfg = get_config(arch).scaled_down()
    with pytest.raises(NotImplementedError, match=item):
        ttf.block_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    with pytest.raises(NotImplementedError, match=item):
        ttf.make_decode_cache(cfg, 1, 8, "cpu")


def test_every_kernel_source_is_built_up_front():
    """chip_smoke.py builds ``_build.SOURCES`` in parallel before it runs
    anything; every kernel binding's source must be among them."""
    from pathlib import Path

    from repro_torch.kernels import _build
    from repro_torch.kernels.checksum import kernel as cs_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    for mod in (fa_kernel, cs_kernel, ssm_kernel):
        assert mod.SOURCE in _build.SOURCES, mod.__name__
        assert (Path(_build.PKG_DIR) / mod.SOURCE).is_file()
