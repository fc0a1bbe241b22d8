"""The port's gated linear recurrence and rwkv6 layers against the JAX
reference on the same numpy inputs, in fp32: ``ssm_scan`` (the CPU path)
against the reference's Pallas kernel in interpret mode and its
``ssm_scan_ref``; the plain versions and the decode step against theirs; the op's gradients
(``SSMScan``'s plain backward) against ``jax.grad`` of the reference's
chunked form and, under strong decay, of its step form; the rwkv6 time mix
and channel mix against ``repro.models.transformer``."""

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
from repro_torch.kernels.ssm_scan.ref import (ssm_scan_blocked, ssm_scan_chunked,
                                              ssm_scan_ref, tf32_round)
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


#: B, T, H, K, V, use_u, chunk, sub, decay: rwkv6's per-key decay, the pad
#: path (T 40, chunk 16), and mamba's (B, T, H, 1) decay broadcast over K
GRAD_CASES = [
    (2, 48, 2, 8, 8, True, 16, 8, "key"),
    (1, 40, 3, 8, 16, False, 16, 4, "key"),
    (2, 32, 2, 8, 8, True, 16, 8, "head"),
]


def _grads_vs_jax(jax_fn, q, k, v, g, s0, u, chunk, sub, wy, ws):
    """Gradients of sum(y wy) (+ sum(s ws) unless ``ws`` is None) through the
    port's op and through ``jax_fn``, for q, k, v, g, u, s0."""
    leaves = [t.requires_grad_() for t in _t(q, k, v, g, u, s0)]
    y, s = ssm_scan(*leaves[:4], u=leaves[4], initial_state=leaves[5],
                    chunk=chunk, subchunk=sub)
    loss = (y * torch.from_numpy(wy)).sum()
    if ws is not None:
        loss = loss + (s * torch.from_numpy(ws)).sum()
    got = torch.autograd.grad(loss, leaves)

    def jloss(q, k, v, g, u, s0):
        y, s = jax_fn(q, k, v, jnp.broadcast_to(g, q.shape), u=u, initial_state=s0)
        return (y * wy).sum() + (0.0 if ws is None else (s * ws).sum())

    want = jax.grad(jloss, argnums=tuple(range(6)))(*_j(q, k, v, g, u, s0))
    return got, want


@pytest.mark.parametrize("outputs", ["y", "y_and_state"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=[f"g{i}" for i in range(len(GRAD_CASES))])
def test_ssm_scan_grads_match_jax(case, outputs):
    """``SSMScan``'s backward against ``jax.grad`` of the reference's
    ``ssm_scan_chunked`` (what its rwkv6 layer trains through), at 1e-4;
    with y alone the final state's gradient never reaches the backward, as
    in training."""
    B, T, H, K, V, use_u, chunk, sub, decay = case
    q, k, v, g, s0, u = _inputs(B, T, H, K, V, seed=T + 7, scalar=decay == "head")
    if decay == "head":
        g = np.ascontiguousarray(g[..., :1])
    if not use_u:
        u = np.zeros_like(u)  # inert; its gradient is still compared
    rng = np.random.default_rng(T)
    wy = rng.standard_normal((B, T, H, V)).astype(np.float32)
    ws = rng.standard_normal((B, H, K, V)).astype(np.float32) if outputs != "y" else None
    got, want = _grads_vs_jax(
        lambda *a, **kw: jssm.ssm_scan_chunked(*a, **kw, chunk=chunk, subchunk=sub),
        q, k, v, g, s0, u, chunk, sub, wy, ws)
    for name, a, b in zip(("q", "k", "v", "log_decay", "u", "initial_state"), got, want):
        assert a.shape == b.shape, name
        _close(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


def test_ssm_scan_grads_strong_decay():
    """Under strong decay (log decay about -4.5 a step) the gradient stays
    finite and matches ``jax.grad`` of the step form ``ssm_scan_ref``.  The
    reference's chunked form gives nan there (ROADMAP C5), so it cannot be
    the oracle."""
    q, k, v, g, s0, u = _inputs(1, 64, 2, 8, 8, seed=0, decay_scale=-1.5)
    rng = np.random.default_rng(1)
    wy = rng.standard_normal((1, 64, 2, 8)).astype(np.float32)
    ws = rng.standard_normal((1, 2, 8, 8)).astype(np.float32)
    got, want = _grads_vs_jax(jssm.ssm_scan_ref, q, k, v, g, s0, u, 32, 8, wy, ws)
    for name, a, b in zip(("q", "k", "v", "log_decay", "u", "initial_state"), got, want):
        assert torch.isfinite(a).all(), name
        _close(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


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


@pytest.mark.parametrize("where", ["chunked", "op", "model", "mamba"])
def test_ssm_shard_constrain_matches_jax(where):
    """The reference's (batch, heads) pins, with no sharding rules
    installed, are the identity in both packages: the plain function and
    rwkv6 / jamba models with ``ssm_shard_constraints`` equal JAX's with the
    same toggle, and so does the op, which has no pin of its own (a rank
    runs it on its local tensors, where a pin is the identity).  Under a 2x2
    mesh they are held to the unsharded port in tests/test_torch_cells.py."""
    q, k, v, g, s0, u = _inputs(2, 40, 2, 8, 8, seed=2)
    if where in ("chunked", "op"):
        pin = {"shard_constrain": True} if where == "chunked" else {}
        fn = ssm_scan_chunked if where == "chunked" else ssm_scan
        y, s = fn(*_t(q, k, v, g), u=torch.from_numpy(u), initial_state=torch.from_numpy(s0),
                  chunk=8, subchunk=4, **pin)
        jy, js = jssm.ssm_scan_chunked(*_j(q, k, v, g), u=jnp.asarray(u),
                                       initial_state=jnp.asarray(s0), chunk=8, subchunk=4,
                                       shard_constrain=True)
        _close(y, jy)
        _close(s, js)
        return
    arch = "rwkv6-7b" if where == "model" else "jamba-1.5-large-398b"
    jcfg, tcfg = (c.scaled_down(ssm_shard_constraints=True)
                  for c in (jax_get_config(arch), get_config(arch)))
    from repro.models.registry import build as jax_build
    p = jax_build(jcfg).init(jax.random.PRNGKey(3))
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    logits, _, _ = build(tcfg, "cpu").prefill(_params(p), {"tokens": torch.from_numpy(tokens)})
    jlogits, _, _ = jax_build(jcfg).prefill(p, {"tokens": jnp.asarray(tokens)})
    _close(logits, jlogits, rtol=1e-4, atol=1e-4)


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
# ssm_scan_blocked: the Hopper kernel's blocking, on the CPU
# ---------------------------------------------------------------------------
#: B, T, H, K, V, use_u, use_s0: T of 1, 17 and 300 (ragged against the
#: 32-token chunks), K != V, K = 128
BLOCKED_CASES = [
    (2, 17, 3, 8, 16, True, True),
    (1, 1, 2, 16, 8, False, True),
    (1, 300, 2, 16, 24, True, False),
    (2, 64, 2, 128, 32, False, True),
    (1, 45, 1, 128, 128, True, True),
    (2, 300, 1, 32, 8, False, False),
]


@pytest.mark.parametrize("tf32", [False, True], ids=["fp32", "tf32_split"])
@pytest.mark.parametrize("case", BLOCKED_CASES, ids=[f"b{i}" for i in range(len(BLOCKED_CASES))])
def test_ssm_scan_blocked_matches_jax(case, tf32):
    """The kernel's algebra (chunks of 32, sub-chunks of 4, the state carried
    once per chunk, exact diagonal blocks, off-diagonal blocks factorised
    about the earlier sub-chunk's end), with and without the TF32 split
    emulated, against JAX's step recurrence and chunked form and the port's
    step recurrence, at the reference's SSM tolerance."""
    B, T, H, K, V, use_u, use_s0 = case
    q, k, v, g, s0, u = _inputs(B, T, H, K, V, seed=T + K + V)
    tu = torch.from_numpy(u) if use_u else None
    ju = jnp.asarray(u) if use_u else None
    ts0 = torch.from_numpy(s0) if use_s0 else None
    js0 = jnp.asarray(s0) if use_s0 else None
    y, s = ssm_scan_blocked(*_t(q, k, v, g), u=tu, initial_state=ts0, chunk_len=32,
                            sub_len=4, tf32_split=tf32)
    assert y.shape == (B, T, H, V) and s.shape == (B, H, K, V)
    for want in (jssm.ssm_scan_ref(*_j(q, k, v, g), u=ju, initial_state=js0),
                 jssm.ssm_scan_chunked(*_j(q, k, v, g), u=ju, initial_state=js0,
                                       chunk=16, subchunk=8),
                 ssm_scan_ref(*_t(q, k, v, g), u=tu, initial_state=ts0)):
        _close(y, want[0])
        _close(s, want[1])


@pytest.mark.parametrize("tf32", [False, True], ids=["fp32", "tf32_split"])
@pytest.mark.parametrize("use_u", [False, True], ids=["inclusive", "bonus"])
def test_ssm_scan_blocked_harsh_decay(use_u, tf32):
    """A log decay of about -20 a step: e^{-z} from a sub-chunk's start
    overflows fp32 within a 16-token sub-chunk (the config's), so a factorisation about the start
    gives inf and nan.  The blocked form multiplies only factors <= 1 and
    gives finite values equal to the step recurrence (the reference's jnp
    chunked form gives nan here, so it is left out)."""
    q, k, v, _, s0, u = _inputs(2, 70, 2, 16, 8, seed=21)
    g = (-20.0 + np.random.default_rng(22).standard_normal(q.shape)).astype(np.float32)
    assert torch.isinf(torch.exp(-torch.cumsum(torch.from_numpy(g)[:, :16], 1))).any()
    tu = torch.from_numpy(u) if use_u else None
    y, s = ssm_scan_blocked(*_t(q, k, v, g), u=tu, initial_state=torch.from_numpy(s0),
                            tf32_split=tf32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    ry, rs = ssm_scan_ref(*_t(q, k, v, g), u=tu, initial_state=torch.from_numpy(s0))
    _close(y, ry.numpy())
    _close(s, rs.numpy())
    jy, js = jssm.ssm_scan_ref(*_j(q, k, v, g), u=jnp.asarray(u) if use_u else None,
                               initial_state=jnp.asarray(s0))
    _close(y, jy)
    _close(s, js)


def test_ssm_scan_blocked_rejects_bad_blocking():
    q, k, v, g, _, _ = _inputs(1, 8, 1, 8, 8, seed=4)
    with pytest.raises(ValueError, match="must divide"):
        ssm_scan_blocked(*_t(q, k, v, g), chunk_len=32, sub_len=5)


def test_tf32_round():
    """Round to nearest with ties away from zero, 10 mantissa bits kept."""
    x = torch.tensor([1 + 2**-11, 1 + 2**-12, -(1 + 2**-11), 1 + 3 * 2**-11, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, 1.0, -(1 + 2**-10), 1 + 2 * 2**-10, 3.0, 0.0])
    assert torch.equal(tf32_round(x), want)
    r = tf32_round(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()


def test_ssm_kernel_binding_matches_c_entry_point():
    """The ctypes argument types bound once in kernel.py follow the C entry
    point's parameters in csrc/ssm_scan.cu: a pointer per pointer, a 64-bit
    int per ``long long`` (the strides), an int per int."""
    import ctypes
    import re
    from pathlib import Path

    from repro_torch.kernels import _build
    src = (Path(_build.PKG_DIR) / ssm_kernel.SOURCE).read_text()
    sig = re.search(r'extern "C" int repro_ssm_scan_fwd\(([^)]*)\)', src).group(1)
    params = [p.strip() for p in sig.split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_longlong if p.startswith("long long")
            else ctypes.c_int for p in params]
    assert ssm_kernel.ARGTYPES == want


def test_ssm_kernel_load_variant_binds_once(monkeypatch):
    """``load_variant`` points the wrapper at another library and drops the
    bound entry point; the entry point is typed once and reused, and None
    goes back to the repo's own source."""
    from repro_torch.kernels import _build

    class Lib:
        def __init__(self, name):
            self.name = name
            self.repro_ssm_scan_fwd = type("Fn", (), {})()

    opened, loaded = [], []
    monkeypatch.setattr(ssm_kernel.ctypes, "CDLL", lambda path: opened.append(path) or Lib(path))
    monkeypatch.setattr(_build, "load", lambda src: loaded.append(src) or Lib("repo"))
    try:
        ssm_kernel.load_variant("build/variant.so")
        fn = ssm_kernel._fn()
        assert opened == ["build/variant.so"] and loaded == []
        assert fn.argtypes == ssm_kernel.ARGTYPES and ssm_kernel._fn() is fn
        ssm_kernel.load_variant(None)
        fn2 = ssm_kernel._fn()
        assert loaded == [ssm_kernel.SOURCE] and fn2 is not fn and ssm_kernel._fn() is fn2
    finally:
        ssm_kernel.load_variant(None)


def test_ssm_scan_script_checks_and_times_every_build():
    """scripts/ssm_scan_torch.py holds every build with chip_smoke.py's own
    ssm_check, whose cases include the harsh decay and T of 1 and 17, and
    exits non-zero without CUDA (as here) before it builds anything."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    text = (root / "scripts" / "ssm_scan_torch.py").read_text()
    assert "chip_smoke.ssm_check(" in text and "chip_smoke.ssm_times(" in text
    proc = subprocess.run([sys.executable, str(root / "scripts" / "ssm_scan_torch.py")],
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


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


def test_every_kernel_source_is_built_up_front():
    """chip_smoke.py builds ``_build.SOURCES`` in parallel before it runs
    anything; every kernel binding's source must be among them."""
    from pathlib import Path

    from repro_torch.kernels import _build
    from repro_torch.kernels.checksum import kernel as cs_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.selective_scan import kernel as scan1_kernel
    for mod in (fa_kernel, cs_kernel, ssm_kernel, scan1_kernel):
        assert mod.SOURCE in _build.SOURCES, mod.__name__
        assert (Path(_build.PKG_DIR) / mod.SOURCE).is_file()
