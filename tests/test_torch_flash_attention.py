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


def _ablation_script(name="flash_ablation_torch"):
    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script,name", [
    *[pytest.param("flash_ablation_torch", n, id=n)
      for n in ("exp2f", "one_chain", "no_pingpong", "box_past_dh", "grid_per_item",
                "no_softmax", "loads_only")],
    *[pytest.param("flash_bwd_ablation_torch", n, id=f"bwd_{n}")
      for n in ("no_atomics", "no_dq", "no_exp", "no_bar")]])
def test_ablation_variant_edits_kernel_source(script, name):
    """scripts/flash_ablation_torch.py's and scripts/flash_bwd_ablation_torch.py's
    changed copies of the kernel source still find, as often as they expect,
    the statements they change: each differs from the source, and only on
    the lines it names."""
    from repro_torch.kernels import _build

    abl = _ablation_script(script)
    src = (_build.PKG_DIR / fa_kernel.SOURCE).read_text()
    got = abl.variants(src)
    assert got["full"] == src and got[name] != src
    for pat, repl, want in abl.EDITS[name]:
        assert len(re.findall(pat, src)) == want
    added = set(got[name].splitlines()) - set(src.splitlines())
    assert added and all(any(repl in line for _, repl, _ in abl.EDITS[name]) for line in added)


#: B, Sq, Skv, H, KV, dh, causal, window of the backward's plain algebra:
#: query groups of 1, 2 and 4 heads, causal, windowed and non-causal, Sq
#: above and below Skv, lengths no multiple of 64 or 128, a window of one
#: key, and a non-causal window whose last rows see no key
BWD_CASES = [
    (2, 64, 64, 4, 4, 16, True, None),
    (1, 70, 70, 4, 2, 16, True, None),
    (1, 130, 130, 8, 2, 8, True, 48),
    (2, 50, 90, 4, 1, 16, False, None),
    (1, 90, 50, 2, 1, 8, False, None),
    (1, 100, 100, 4, 2, 24, True, 1),
    (1, 40, 30, 2, 1, 8, False, 5),
]


def _bwd_inputs(case, seed=0):
    B, Sq, Skv, H, KV, dh, _, _ = case
    gen = torch.Generator().manual_seed(seed + sum(case[:6]))
    return [torch.randn(*s, generator=gen) for s in
            ((B, Sq, H, dh), (B, Skv, KV, dh), (B, Skv, KV, dh), (B, Sq, H, dh))]


@pytest.mark.parametrize("case", BWD_CASES, ids=[f"b{i}" for i in range(len(BWD_CASES))])
def test_chunked_attention_lse_is_the_rows_logsumexp(case):
    """``chunked_attention``'s lse is torch.logsumexp of each row's masked
    scaled scores (-inf where a row sees no key), and its output is the same
    with or without it."""
    from repro_torch.kernels.flash_attention.ref import _mask, chunked_attention
    B, Sq, Skv, H, KV, dh, causal, window = case
    q, k, v, _ = _bwd_inputs(case)
    o, lse = chunked_attention(q, k, v, causal=causal, window=window, chunk=32, return_lse=True)
    assert torch.equal(o, chunked_attention(q, k, v, causal=causal, window=window, chunk=32))
    s = torch.einsum("bqhd,bshd->bhqs", q, k.repeat_interleave(H // KV, dim=2)) / dh ** 0.5
    mask = _mask(torch.arange(Sq), torch.arange(Skv), causal=causal, window=window)
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    assert lse.shape == (B, H, Sq)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    torch.testing.assert_close(lse[~torch.isinf(lse)], want[~torch.isinf(want)],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", BWD_CASES, ids=[f"b{i}" for i in range(len(BWD_CASES))])
def test_flash_attention_bwd_ref_matches_autograd(case):
    """The backward kernel's algebra (``flash_attention_bwd_ref``: P from the
    forward's lse, D = rowsum(dO o O), dS = P (dP - D), dK and dV summed over
    the query group) gives autograd's gradients of ``chunked_attention`` and
    of ``attention_ref`` in fp32, and zeros for rows that see no key."""
    from repro_torch.kernels.flash_attention.ref import chunked_attention, flash_attention_bwd_ref
    *_, causal, window = case
    q, k, v, do = _bwd_inputs(case)
    o, lse = chunked_attention(q, k, v, causal=causal, window=window, chunk=32, return_lse=True)
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    for fn in (lambda q, k, v: chunked_attention(q, k, v, causal=causal, window=window, chunk=32),
               lambda q, k, v: attention_ref(q, k, v, causal=causal, window=window)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(fn(*leaves), leaves, do)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    dead = torch.isinf(lse).any(dim=1)[0]  # (Sq,): rows that see no key, batch 0
    assert torch.equal(got[0][0, dead], torch.zeros_like(got[0][0, dead]))


def test_flash_attention_bwd_ref_rounded_operands_stay_near():
    """Rounding P and dS to bf16 before their products, as the kernel does,
    moves the fp32 gradients by bf16's rounding, not more."""
    from repro_torch.kernels.flash_attention.ref import chunked_attention, flash_attention_bwd_ref
    case = BWD_CASES[2]
    *_, causal, window = case
    q, k, v, do = _bwd_inputs(case)
    o, lse = chunked_attention(q, k, v, causal=causal, window=window, chunk=32, return_lse=True)
    exact = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    rounded = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                      round_operands=True)
    for a, b in zip(rounded, exact):
        err = float((a - b).norm() / b.norm())
        assert 0 < err < 2.0 ** -7


@pytest.mark.parametrize("name,make,accum,want", [
    ("aligned", lambda: _qkv(), 0, True),
    ("served_head_dim_120", lambda: _qkv(H=32, KV=8, dh=120), 0, True),
    ("head_dim_128", lambda: _qkv(H=8, KV=2, dh=128), 0, True),
    ("accum_bf16_mode", lambda: _qkv(), 1024, False),
    ("float32", lambda: tuple(t.float() for t in _qkv()), 0, False),
    ("offset_one_element", lambda: _qkv(offset=1), 0, False),
    ("head_dim_20", lambda: _qkv(dh=20), 0, False),
    ("fused_qkv_view", lambda: (_bf16((2, 64, 12, 64))[:, :, :4], *_qkv()[1:]), 0, True),
])
def test_backward_kernel_dispatch(name, make, accum, want):
    """``ops.kernel_backward`` sends to the backward kernel exactly the CUDA
    inputs the TMA forward takes (``kernel.tma_path``) with fp32
    accumulation; the ``attn_accum_bf16`` mode, fp32 and inputs TMA cannot
    describe keep the plain backward.  It reads the device, dtypes, shapes,
    strides, pointers and the mode alone, so the CPU tensors here, shown to
    it as CUDA ones, give the card's answer; as CPU tensors they never take
    the kernel."""
    from repro_torch.kernels.flash_attention.ops import kernel_backward
    ts = make()
    assert kernel_backward(*(_OnCard(t) for t in ts), bool(accum)) is want
    assert kernel_backward(*(_OnCard(t) for t in ts), False) is fa_kernel.tma_path(*ts)
    assert kernel_backward(*ts, bool(accum)) is False


class _OnCard:
    """A CPU tensor as ``kernel_backward`` reads a CUDA one: its dtype,
    shape, strides and data pointer, on a CUDA device."""
    is_cuda = True

    def __init__(self, t):
        self.t, self.dtype, self.shape = t, t.dtype, t.shape

    def stride(self):
        return self.t.stride()

    def data_ptr(self):
        return self.t.data_ptr()


def test_cpu_backward_stays_plain():
    """A CPU gradient through ``FlashAttention`` is the plain backward's,
    launches nothing and matches ``attention_ref``'s autograd."""
    case = BWD_CASES[1]
    *_, causal, window = case
    q, k, v, do = _bwd_inputs(case)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa_kernel.launches, fa_kernel.bwd_launches)
    got = torch.autograd.grad(flash_attention(*leaves, causal=causal, window=window), leaves, do)
    assert (fa_kernel.launches, fa_kernel.bwd_launches) == before
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, causal=causal, window=window), leaves, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
