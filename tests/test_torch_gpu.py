"""The port's kernels on the card: the serving paths run the flash kernel
and the ssm_scan kernel once per layer, the flash kernel's TMA path and its
mma.sync path and the ssm_scan kernel agree with their plain versions, and the
lanesum32 kernel agrees bit for bit with its plain version.

It needs a CUDA device and skips without one.  It imports no JAX, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` checks the flash kernel at the served shapes as well, and
the checksum kernel's larger cases (above 2 GiB) and the ssm_scan kernel's
served shapes.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.kernels.checksum import kernel as cs_kernel
from repro_torch.kernels.checksum.ops import checksum_digests
from repro_torch.kernels.checksum.ref import digest_of, lanesum32_torch
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import chunked_attention
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_chunked, ssm_scan_ref
from repro_torch.models.registry import build

#: B, T, H, K, V, use_u, chunk, sub: tests/test_kernels.py's SSM_CASES, then
#: ragged K, V and T
SSM_CASES = [
    (2, 64, 3, 8, 16, False, 32, 8),
    (1, 128, 2, 16, 16, False, 64, 16),
    (2, 48, 2, 8, 8, True, 16, 8),
    (1, 40, 4, 8, 8, True, 16, 4),
    (1, 256, 1, 32, 32, False, 128, 16),
    (2, 37, 3, 20, 21, True, 16, 8),
]

#: B, Sq, Skv, H, KV, dh, causal, window: tests/test_kernels.py's ATTN_CASES,
#: the served head shape, and lengths ragged against the kernel's 128-row tiles
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 128, 128, 4, 4, 128, True, None),
    (1, 96, 96, 8, 1, 32, True, None),
    (2, 64, 256, 4, 4, 48, False, None),
    (1, 256, 256, 4, 2, 64, True, 96),
    (1, 130, 130, 2, 2, 80, True, 64),
    (2, 300, 300, 32, 8, 120, True, 128),
    (1, 333, 333, 8, 2, 128, True, 200),
    (2, 130, 333, 4, 1, 64, False, 100),
]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flash_inputs(case, device, offset=0):
    """bf16 q, k, v of ``case``; with ``offset``, views that start that many
    elements into their buffers."""
    B, Sq, Skv, H, KV, dh, _, _ = case
    gen = torch.Generator(device).manual_seed(sum(case[:6]))
    return [torch.randn(B * S * n * dh + offset, generator=gen, device=device)
            .bfloat16()[offset:].view(B, S, n, dh)
            for S, n in ((Sq, H), (Skv, KV), (Skv, KV))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[f"f{i}" for i in range(len(FLASH_CASES))])
def test_flash_tma_kernel_matches_plain(cuda, case):
    """The TMA / wgmma kernel against the plain chunked version on the same
    bf16 inputs, at tests/test_kernels.py's bf16 tolerance (2e-2)."""
    *_, causal, window = case
    q, k, v = _flash_inputs(case, cuda)
    assert fa_kernel.tma_path(q, k, v)
    before, tma_before = fa_kernel.launches, fa_kernel.tma_launches
    got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + 1 and fa_kernel.tma_launches == tma_before + 1
    want = chunked_attention(q, k, v, causal=causal, window=window, chunk=128)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case,offset", [((2, 200, 200, 4, 2, 20, True, None), 0),
                                         ((1, 300, 300, 32, 8, 120, True, 128), 1)],
                         ids=["head_dim_20", "offset_one_element"])
def test_flash_mma_sync_path_matches_plain(cuda, case, offset):
    """Inputs a TMA tensor map cannot describe (40-byte rows; data 2 bytes
    past a 16-byte boundary) take the mma.sync kernel and agree with the
    plain chunked version at 2e-2."""
    *_, causal, window = case
    q, k, v = _flash_inputs(case, cuda, offset)
    assert not fa_kernel.tma_path(q, k, v)
    before, tma_before = fa_kernel.launches, fa_kernel.tma_launches
    sync_before = fa_kernel.sync_launches
    got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_kernel.sync_launches == sync_before + 1 and fa_kernel.launches == before + 1
    assert fa_kernel.tma_launches == tma_before
    want = chunked_attention(q, k, v, causal=causal, window=window, chunk=128)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_prefill_runs_kernel_per_layer(cuda):
    cfg = get_config("h2o-danube-3-4b").scaled_down(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    api = build(cfg, cuda)
    params = api.init(torch.Generator(api.device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda)
    before, tma_before = fa_kernel.launches, fa_kernel.tma_launches
    with torch.inference_mode():
        logits, _, _ = api.prefill(params, {"tokens": tokens})
        # one launch a layer, on the TMA path
        assert fa_kernel.launches == before + cfg.n_layers
        assert fa_kernel.tma_launches == tma_before + cfg.n_layers
        plain = build(dataclasses.replace(cfg, attn_impl="full"), cuda)
        want, _, _ = plain.prefill(params, {"tokens": tokens})
    torch.testing.assert_close(logits, want, rtol=5e-2, atol=5e-2)


def test_checksum_kernel_matches_plain(cuda):
    """Bit-exact on tail lengths, bf16, a 0-d tensor, a transposed tensor,
    views at unaligned storage offsets and a buffer of several MB."""
    gen = torch.Generator(cuda).manual_seed(0)
    big = torch.randn(3 * 2**20 + 7, generator=gen, device=cuda)
    b8 = torch.randint(0, 256, (4099,), generator=gen, device=cuda, dtype=torch.uint8)
    xs = [b8[:n] for n in (0, 1, 2, 3, 5, 7)]
    xs += [b8[o:o + 1000] for o in (1, 2, 3, 4, 12)]  # every alignment mod 16
    xs += [big.to(torch.bfloat16)[1:1002], torch.tensor(-7, dtype=torch.int32, device=cuda),
           big[:999 * 37].reshape(999, 37).T, big]
    before = cs_kernel.launches
    got = checksum_digests(xs)
    torch.cuda.synchronize()
    assert cs_kernel.launches == before + len(xs)
    assert got == [digest_of(*lanesum32_torch(x)) for x in xs]
    flipped = big.clone()
    flipped.view(torch.int32)[12345] ^= 1 << 7
    assert checksum_digests([flipped]) != checksum_digests([big])


def _ssm_inputs(case, dtype, device, seed=0):
    B, T, H, K, V, use_u, _, _ = case
    gen = torch.Generator(device).manual_seed(seed)
    q, k = (torch.randn((B, T, H, K), generator=gen, device=device) * 0.5 for _ in range(2))
    v = torch.randn((B, T, H, V), generator=gen, device=device) * 0.5
    g = -torch.exp(torch.randn((B, T, H, K), generator=gen, device=device) - 1.5)
    s0 = torch.randn((B, H, K, V), generator=gen, device=device) * 0.3
    u = torch.randn((H, K), generator=gen, device=device) * 0.5 if use_u else None
    return q.to(dtype), k.to(dtype), v.to(dtype), g, s0, u


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSM_CASES, ids=[f"s{i}" for i in range(len(SSM_CASES))])
def test_ssm_kernel_matches_plain(cuda, case, dtype):
    """Against the plain chunked form and the step recurrence on the same
    inputs: fp32 at tests/test_kernels.py's 3e-5; in bf16 y may differ by
    the rounding of y to bf16 (2e-2, as the flash kernel's bf16 cases), the
    fp32 state by the order of fp32 sums (3e-5)."""
    q, k, v, g, s0, u = _ssm_inputs(case, getattr(torch, dtype), cuda)
    chunk, sub = case[-2:]
    before = ssm_kernel.launches
    y, s = ssm_scan(q, k, v, g, u, s0, chunk=chunk, subchunk=sub)
    torch.cuda.synchronize()
    assert ssm_kernel.launches == before + 1
    assert y.dtype == q.dtype and s.dtype == torch.float32
    tol = 3e-5 if dtype == "float32" else 2e-2
    for want_y, want_s in (ssm_scan_chunked(q, k, v, g, u, s0, chunk=chunk, subchunk=sub),
                           ssm_scan_ref(q, k, v, g, u, s0)):
        torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(s, want_s, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("use_u", [False, True], ids=["inclusive", "bonus"])
def test_ssm_kernel_head_decay_and_io_dtype(cuda, use_u):
    """A (B, T, H, 1) log decay broadcast over K, and ``io_dtype=bfloat16``
    on fp32 inputs, through the kernel against the plain chunked form given
    the same arguments (fp32 state and y: 3e-5)."""
    q, k, v, g, s0, u = _ssm_inputs((2, 40, 3, 8, 8, use_u, 16, 8), torch.float32, cuda)
    g1 = g[..., :1].contiguous()
    before = ssm_kernel.launches
    y, s = ssm_scan(q, k, v, g1, u, s0, chunk=16, subchunk=8, io_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert ssm_kernel.launches == before + 1 and y.dtype == torch.float32
    want_y, want_s = ssm_scan_chunked(q, k, v, g1, u, s0, chunk=16, subchunk=8,
                                      io_dtype=torch.bfloat16)
    torch.testing.assert_close(y, want_y, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(s, want_s, rtol=3e-5, atol=3e-5)


def test_ssm_kernel_refuses_autograd(cuda):
    q, k, v, g, s0, u = _ssm_inputs(SSM_CASES[2], torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="A9a"):
        ssm_scan(q.requires_grad_(), k, v, g, u, s0)
    with torch.no_grad():
        ssm_scan(q, k, v, g, u, s0)


def test_rwkv_prefill_runs_ssm_kernel_per_layer(cuda):
    cfg = get_config("rwkv6-7b").scaled_down(param_dtype="bfloat16", compute_dtype="bfloat16")
    api = build(cfg, cuda)
    params = api.init(torch.Generator(api.device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda)
    before, fa_before = ssm_kernel.launches, fa_kernel.launches
    with torch.inference_mode():
        logits, cache, _ = api.prefill(params, {"tokens": tokens})
        assert ssm_kernel.launches == before + cfg.n_layers
        api.decode(params, cache, logits[:, -1].argmax(-1)[:, None], 96)
        assert ssm_kernel.launches == before + cfg.n_layers  # decode is the plain step
        assert fa_kernel.launches == fa_before
    assert torch.isfinite(logits).all()
