"""The port's kernels on the card: the serving paths run the flash kernel
and the ssm_scan kernel once per layer (jamba's hybrid stack: the scan once
per mamba layer, flash once per attention layer; whisper: flash once per
encoder layer, non-causal, and once per decoder layer, the cross-attention
plain), rwkv6 training runs the
scan kernel twice a layer with the plain scan's gradients, the flash
kernel's TMA path and its mma.sync path and the ssm_scan kernel agree with
their plain versions (the scan also on strided q, k and g and on mamba's
layout, read in place and bit for bit what contiguous copies give), the
Mamba-1 selective-scan kernel agrees with its plain forms (at the published
Jamba's width, d_inner 8192 and d_state 16, over 16384 steps too) and runs
once per Mamba layer of a prefill, and the lanesum32 kernel agrees bit for
bit with its plain version.

It needs a CUDA device and skips without one.  It imports no JAX, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` checks the flash kernel at the served shapes as well, and
the checksum kernel's larger cases (above 2 GiB) and the ssm_scan kernel's
served shapes.
"""

import dataclasses
import hashlib
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.kernels.checksum import kernel as cs_kernel
from repro_torch.kernels.checksum.ops import checksum_digests
from repro_torch.kernels.checksum.ref import digest_of, lanesum32_torch
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.kernel import ACC_CASES, ACC_MEAN_RATIO, ACC_TOL
from repro_torch.kernels.flash_attention.ref import attention_ref, chunked_attention
from repro_torch.kernels.selective_scan import kernel as scan1_kernel
from repro_torch.kernels.selective_scan.ref import selective_scan_chunked, selective_scan_ref
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_chunked, ssm_scan_ref
from repro_torch.models.registry import build
from repro_torch.roofline import LiveBytes

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
#: the served head shape, lengths ragged against the kernel's 128-row tiles,
#: whisper's encoder heads (non-causal, one q head per kv head) and llava's
#: (dh 128, 32 / 8 heads) at ragged lengths
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
    (2, 333, 333, 16, 16, 64, False, None),
    (2, 300, 300, 32, 8, 128, True, 128),
]
#: the cases of the encoder-decoder and VLM heads, also held in fp32
WIDE_CASES = FLASH_CASES[-2:]
#: sha256 of the fp32-accumulating kernels' outputs on _flash_inputs (bf16
#: cases: the mma.sync kernel at offset 1 element; fp32 cases: the fp32
#: kernel), from the kernel source before the bf16-accumulating instances
#: were added (golden_outputs() on a build of it; NVIDIA H100 80GB HBM3,
#: torch 2.11.0+cu128): accum_chunk 0 must give them bit for bit
GOLDEN = {
    "sync_dh20": "7387a29f05da227f15a6ea7e4d6ff12277f56ad3c037447817f1ab2351b76722",
    "sync_offset": "128823260c0b380ae5bd7b90dc8fdfe8c6a4b5281a77ee5545c788f203739fd2",
    "sync_noncausal": "4eee2c25318eb16eaad302339caf1ad3b281696e16a337a4330e79cb6b3f8127",
    "f32_dh128": "8dcd2b2df323972d3373158d5347c5f76b7f9828958f67f150f9106a89b80c36",
    "f32_noncausal": "d3ec5b3e72700e2eec472f1528149cf6a786e2e03660c5abd8e8dd9d902a73bc",
}

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


@pytest.mark.parametrize("case", WIDE_CASES, ids=["noncausal_g1", "dh128"])
def test_flash_f32_kernel_matches_plain(cuda, case):
    """The fp32 kernel against the plain chunked version at
    tests/test_kernels.py's fp32 tolerance (2e-5)."""
    *_, causal, window = case
    q, k, v = (t.float() for t in _flash_inputs(case, cuda))
    before, f32_before = fa_kernel.launches, fa_kernel.f32_launches
    got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + 1 and fa_kernel.f32_launches == f32_before + 1
    want = chunked_attention(q, k, v, causal=causal, window=window, chunk=128)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case,chunk", ACC_CASES, ids=[f"a{i}" for i in range(len(ACC_CASES))])
def test_flash_accum_bf16_matches_plain(cuda, case, chunk, dtype):
    """``accum_chunk`` > 0 (attn_accum_bf16): one launch of the mma.sync
    (bf16) or fp32 kernel, within ACC_TOL of the plain chunked form with
    ``accum_bf16`` element by element, and as far from fp32 truth on the
    mean as that form is, within ACC_MEAN_RATIO, where the fp32-accumulating
    kernel is not."""
    *_, causal, window = case
    q, k, v = (t.to(getattr(torch, dtype)) for t in _flash_inputs(case, cuda))
    counts = (fa_kernel.launches, fa_kernel.tma_launches, fa_kernel.sync_launches,
              fa_kernel.f32_launches)
    got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                        accum_chunk=chunk).float()
    torch.cuda.synchronize()
    took = tuple(a - b for a, b in zip((fa_kernel.launches, fa_kernel.tma_launches,
                                        fa_kernel.sync_launches, fa_kernel.f32_launches),
                                       counts))
    assert took == ((1, 0, 1, 0) if dtype == "bfloat16" else (1, 0, 0, 1))
    plain = chunked_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                              accum_bf16=True).float()
    truth = attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
    f32_acc = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window).float()
    limit = ACC_TOL * (plain.abs() + plain.abs().mean(dim=-1, keepdim=True))
    assert bool(((got - plain).abs() <= limit).all())
    scale = truth.abs().mean(dim=-1, keepdim=True)
    mean_err = lambda o: ((o - truth).abs() / scale).mean().item()
    band = lambda r: 1 / ACC_MEAN_RATIO <= r <= ACC_MEAN_RATIO
    assert band(mean_err(got) / mean_err(plain))
    assert not band(mean_err(f32_acc) / mean_err(plain))


#: B, Sq, Skv, H, KV, dh, causal, window of the backward kernel: granite-moe's
#: training step (B2 S4096, 16 / 8 heads of 64, causal), lengths ragged
#: against its 64-row q and 128-key tiles, windowed and non-causal bands, Sq
#: above and below Skv with rows that see no key (non-causal window 20 over
#: 100 keys: rows 119-199), one q head per kv head, dh 32 and 48 (head
#: columns past dh inside the 64-wide instance's tile), and dh 80, 120 and
#: 128 (chip_smoke.py's dense and VLM training heads) on the 128-wide instance
BWD_CASES = [
    (2, 4096, 4096, 16, 8, 64, True, None),
    (2, 300, 300, 4, 2, 64, True, None),
    (1, 256, 256, 4, 2, 64, True, 96),
    (2, 130, 333, 4, 1, 64, False, 100),
    (1, 200, 100, 2, 1, 64, False, 20),
    (2, 333, 333, 16, 16, 64, False, None),
    (1, 96, 96, 8, 1, 32, True, None),
    (2, 64, 256, 4, 4, 48, False, None),
    (1, 130, 130, 2, 2, 80, True, 64),
    (2, 300, 300, 8, 2, 120, True, 128),
    (1, 333, 333, 8, 2, 128, True, 200),
    (1, 1024, 1024, 8, 2, 128, False, None),
]
#: the backward kernel against the plain backward (its oracle) on bf16
#: inputs: relative L2 error of each gradient, and the largest error over
#: the largest |plain|.  The kernel rounds P and dS to bf16 as operands of
#: their products (the plain backward keeps them fp32) and writes bf16:
#: 2^-9 relative a rounding; on an H100 it read 0.0024-0.0031 and 0.003-0.007
#: on these cases.  Against fp32 truth (the plain algebra on fp32 copies of
#: the inputs) its error may be BWD_TRUTH_RATIO times the plain backward's
#: (read: 1.2-1.4x).
BWD_REL_L2 = 1e-2
BWD_MAX = 2e-2
BWD_TRUTH_RATIO = 2.0
#: ... and against its own algebra in fp32 with P and dS rounded to bf16 where
#: it rounds them (``flash_attention_bwd_ref(round_operands=True)`` from its
#: o and lse): what is left is the order of sums, ex2.approx and the bf16
#: outputs (read: at most 4.3e-4)
BWD_EMUL_REL_L2 = 2e-3


def _bwd_inputs(case, device):
    B, Sq, Skv, H, KV, dh, _, _ = case
    q, k, v = _flash_inputs(case, device)
    gen = torch.Generator(device).manual_seed(sum(case[:6]) + 1)
    return q, k, v, torch.randn(B, Sq, H, dh, generator=gen, device=device).bfloat16()


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("case", BWD_CASES, ids=[f"b{i}" for i in range(len(BWD_CASES))])
def test_flash_bwd_kernel_matches_plain_backward(cuda, case):
    """A backward through ``FlashAttention`` on bf16 TMA-path inputs runs the
    backward kernel once (and its forward writes the lse), within BWD_REL_L2
    and BWD_MAX of the plain backward, and no further from fp32 truth than
    BWD_TRUTH_RATIO times the plain backward is, and within BWD_EMUL_REL_L2
    of its own algebra in fp32 (P and dS rounded).  dK and dV are bit-equal
    from run to run; dQ's fp32 accumulator takes atomic adds, whose order
    varies, so a rerun is held to BWD_REL_L2 / 10."""
    from repro_torch.kernels.flash_attention.ops import FlashAttention, plain_backward
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    B, Sq, Skv, H, KV, dh, causal, window = case
    q, k, v, do = _bwd_inputs(case, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa_kernel.tma_launches, fa_kernel.bwd_launches)
    got = torch.autograd.grad(FlashAttention.apply(*leaves, causal, window, min(1024, Skv)),
                              leaves, do)
    again = torch.autograd.grad(FlashAttention.apply(*leaves, causal, window, min(1024, Skv)),
                                leaves, do)
    torch.cuda.synchronize()
    assert (fa_kernel.tma_launches, fa_kernel.bwd_launches) == (before[0] + 2, before[1] + 2)
    want = plain_backward(q, k, v, do, causal=causal, window=window, chunk=min(1024, Skv))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rel_l2(g, w) <= BWD_REL_L2
        assert float((g.float() - w.float()).abs().max()) <= BWD_MAX * float(w.float().abs().max())
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    assert _rel_l2(again[0], got[0]) <= BWD_REL_L2 / 10
    if Sq * Skv <= 1 << 20:
        o, lse = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                               with_lse=True)
        truth = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, o)), lse * math.log(2),
                                        do.float(), causal=causal, window=window)
        for g, w, t in zip(got, want, truth):
            assert _rel_l2(g, t) <= BWD_TRUTH_RATIO * _rel_l2(w, t)
        emul = flash_attention_bwd_ref(q, k, v, o, lse * math.log(2), do, causal=causal,
                                       window=window, round_operands=True)
        for g, e in zip(got, emul):
            assert _rel_l2(g, e) <= BWD_EMUL_REL_L2


@pytest.mark.parametrize("case", BWD_CASES, ids=[f"b{i}" for i in range(len(BWD_CASES))])
def test_flash_fwd_lse_matches_plain_logsumexp(cuda, case):
    """The TMA forward's LSE instance writes the same output bit for bit as
    the instance without it, and each row's log2-sum-exp2 of its scaled
    scores: the plain form's natural logsumexp times log2 e, -inf for the
    same rows (those that see no key).  The kernel's ex2.approx and log2f
    read within 3e-6 of it on an H100; the limit is 1e-4."""
    *_, causal, window = case
    q, k, v = _flash_inputs(case, cuda)
    o, lse = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window, with_lse=True)
    assert torch.equal(o, fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window))
    _, want = chunked_attention(q, k, v, causal=causal, window=window, chunk=1024,
                                return_lse=True)
    want = want * math.log2(math.e)
    dead = torch.isinf(want)
    assert lse.shape == want.shape and torch.equal(torch.isinf(lse), dead)
    assert bool((lse[dead] < 0).all())
    torch.testing.assert_close(lse[~dead], want[~dead], rtol=0, atol=1e-4)


def test_flash_backward_dispatch_on_the_card(cuda, monkeypatch):
    """The kernel backward runs for bf16 TMA-path inputs with a gradient due,
    one launch a backward; a forward with no gradient due asks for no lse;
    fp32 inputs, the attn_accum_bf16 mode and inputs TMA cannot describe
    (mma.sync forward) keep the plain backward and launch no backward
    kernel, and their gradients are the plain backward's."""
    from repro_torch.kernels.flash_attention.ops import FlashAttention, plain_backward
    case = BWD_CASES[1]
    *_, causal, window = case
    asked = []
    fwd = fa_kernel.flash_attention_fwd
    monkeypatch.setattr(fa_kernel, "flash_attention_fwd",
                        lambda *a, **kw: asked.append(kw.get("with_lse", False)) or fwd(*a, **kw))
    q, k, v, do = _bwd_inputs(case, cuda)
    before = fa_kernel.bwd_launches
    FlashAttention.apply(q, k, v, causal, window, 128)
    assert asked == [False] and fa_kernel.bwd_launches == before
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(FlashAttention.apply(*leaves, causal, window, 128), leaves, do)
    assert asked == [False, True] and fa_kernel.bwd_launches == before + 1
    off = _flash_inputs(case, cuda, offset=1)  # 2 bytes past 16-byte boundaries
    for name, ins, accum in (("fp32", [t.float() for t in (q, k, v)], False),
                             ("accum_bf16", [q, k, v], True),
                             ("mma_sync", off, False)):
        leaves = [t.detach().requires_grad_() for t in ins]  # views keep their offsets
        got = torch.autograd.grad(FlashAttention.apply(*leaves, causal, window, 128, accum),
                                  leaves, do.to(ins[0].dtype))
        assert fa_kernel.bwd_launches == before + 1, name
        want = plain_backward(*ins, do.to(ins[0].dtype), causal=causal, window=window,
                              chunk=128, accum_bf16=accum)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


def _digest(t):
    bits = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()


#: GOLDEN's cases: (name, case, dtype, offset); offset 1 takes bf16 inputs
#: to the mma.sync kernel
GOLDEN_CASES = [("sync_dh20", (2, 200, 200, 4, 2, 20, True, None), "bfloat16", 0),
                ("sync_offset", (1, 300, 300, 32, 8, 120, True, 128), "bfloat16", 1),
                ("sync_noncausal", (2, 130, 333, 4, 1, 64, False, 100), "bfloat16", 1),
                ("f32_dh128", (2, 300, 300, 32, 8, 128, True, 128), "float32", 0),
                ("f32_noncausal", (2, 333, 333, 16, 16, 64, False, None), "float32", 0)]


def golden_outputs():
    """{name: sha256 of the kernel's output} on GOLDEN_CASES, accum_chunk 0."""
    out = {}
    for name, case, dtype, offset in GOLDEN_CASES:
        *_, causal, window = case
        q, k, v = (t.to(getattr(torch, dtype)) for t in _flash_inputs(case, "cuda", offset))
        out[name] = _digest(fa_kernel.flash_attention_fwd(q, k, v, causal=causal,
                                                          window=window))
    torch.cuda.synchronize()
    return out


def test_flash_accum_chunk_zero_is_the_fp32_accumulating_kernel(cuda):
    """The mma.sync and fp32 kernels' fp32-accumulating instances (accum_chunk
    0, every path the models take without attn_accum_bf16) give the outputs
    of the kernel source before the bf16-accumulating instances, bit for
    bit (GOLDEN)."""
    assert golden_outputs() == GOLDEN


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_encdec_and_vlm_prefill_run_kernel_per_self_attention(cuda, arch):
    """whisper: one TMA launch per encoder layer and per decoder layer (its
    cross-attention is plain); llava: one per layer, the prompt beginning
    with its image positions.  Logits against plain attention."""
    cfg = get_config(arch).scaled_down(param_dtype="bfloat16", compute_dtype="bfloat16")
    api = build(cfg, cuda)
    params = api.init(torch.Generator(api.device).manual_seed(0))
    gen = torch.Generator(api.device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 96), generator=gen, device=cuda)}
    if cfg.is_encdec:
        batch["audio_embeds"] = torch.randn((2, cfg.encdec.n_audio_ctx, cfg.d_model),
                                            generator=gen, device=cuda)
    if cfg.vlm is not None:
        batch["image_embeds"] = torch.randn((2, cfg.vlm.n_image_tokens, cfg.vlm.patch_dim),
                                            generator=gen, device=cuda)
    want_launches = cfg.n_layers + (cfg.encdec.n_encoder_layers if cfg.is_encdec else 0)
    before, tma_before = fa_kernel.launches, fa_kernel.tma_launches
    with torch.inference_mode():
        logits, cache, _ = api.prefill(params, batch)
        assert fa_kernel.launches == before + want_launches
        assert fa_kernel.tma_launches == tma_before + want_launches
        plain = build(dataclasses.replace(cfg, attn_impl="full"), cuda)
        want, _, _ = plain.prefill(params, batch)
    assert fa_kernel.launches == before + want_launches
    torch.testing.assert_close(logits, want, rtol=5e-2, atol=5e-2)


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


#: B, T, H, K, V, use_u: T of 1 and 17 (one ragged chunk of the kernel's 32
#: tokens), K = 128 beside a V ragged against its 32-column blocks, and
#: enough heads for 64-column blocks with V = 72
SSM_EDGE_CASES = [(1, 1, 2, 8, 8, True), (2, 17, 3, 16, 8, False), (1, 100, 2, 128, 40, True),
                  (3, 40, 48, 16, 72, True)]


@pytest.mark.parametrize("harsh", [False, True], ids=["decay", "harsh_decay"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSM_EDGE_CASES, ids=[f"e{i}" for i in range(len(SSM_EDGE_CASES))])
def test_ssm_kernel_edges_match_step_form(cuda, case, dtype, harsh):
    """The chunked kernel at ragged and short T, and under a log decay of
    about -20 a step (``harsh``: finite, where a factorisation about a
    sub-chunk's start would overflow), against the step recurrence and
    ``ssm_scan_blocked`` at test_ssm_kernel_matches_plain's limits.  (The
    plain chunked form is itself further than 3e-5 from the step form
    under the harsh decay, so it is not the yardstick there.)"""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_blocked
    q, k, v, g, s0, u = _ssm_inputs((*case, 16, 8), getattr(torch, dtype), cuda, seed=7)
    if harsh:
        g = g * 0 - 20.0 + torch.randn(g.shape, device=cuda,
                                       generator=torch.Generator(cuda).manual_seed(8))
    before = ssm_kernel.launches
    y, s = ssm_scan(q, k, v, g, u, s0, chunk=16, subchunk=8)
    torch.cuda.synchronize()
    assert ssm_kernel.launches == before + 1
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    tol = 3e-5 if dtype == "float32" else 2e-2
    for want_y, want_s in (ssm_scan_ref(q, k, v, g, u, s0), ssm_scan_blocked(q, k, v, g, u, s0)):
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_kernel_grads_match_plain(cuda, dtype):
    """Training through the kernel: ``ssm_scan`` launches the kernel once
    for its forward, and its gradients (the plain chunked form's backward
    from the saved inputs) equal those of the plain chunked form run under
    autograd on the card, for every input, with and without the final
    state's gradient."""
    case = (2, 48, 2, 8, 8, True, 16, 8)
    for with_state in (False, True):
        grads = []
        for fn in (ssm_scan, ssm_scan_chunked):
            q, k, v, g, s0, u = (t.clone().requires_grad_()
                                 for t in _ssm_inputs(case, getattr(torch, dtype), cuda))
            leaves = [q, k, v, g, u, s0]
            before = ssm_kernel.launches
            y, s = fn(*leaves, chunk=16, subchunk=8)
            assert ssm_kernel.launches == before + (fn is ssm_scan)
            w = torch.linspace(-1, 1, y.numel(), device=cuda).view(y.shape)
            loss = (y.float() * w).sum() + (s.sum() if with_state else 0)
            grads.append(torch.autograd.grad(loss, leaves))
            assert ssm_kernel.launches == before + (fn is ssm_scan)  # the backward is plain
        for got, want in zip(*grads):
            assert got.dtype == want.dtype and torch.isfinite(got).all()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_rwkv_loss_and_grad_run_ssm_kernel_twice_per_layer(cuda):
    """rwkv6 training on the card: one loss and gradient launches the scan
    kernel twice a layer (the forward, then the block remat's recompute),
    and its gradients are those of the plain scan's step."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.models.convert import flatten
    from repro_torch.runtime.steps import value_and_grad
    cfg = get_config("rwkv6-7b").scaled_down()
    api = build(cfg, cuda)
    params = api.init(torch.Generator(api.device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    before, fa_before = ssm_kernel.launches, fa_kernel.launches
    loss, _, grads = value_and_grad(api, params, batch)
    assert ssm_kernel.launches == before + 2 * cfg.n_layers
    assert fa_kernel.launches == fa_before
    kernel_scan = ssm_ops.ssm_scan
    try:
        ssm_ops.ssm_scan = lambda q, k, v, g, u=None, initial_state=None, *, chunk, subchunk, \
            io_dtype: ssm_scan_chunked(q, k, v, g, u, initial_state, chunk=chunk,
                                       subchunk=subchunk, io_dtype=io_dtype)
        loss_p, _, grads_p = value_and_grad(api, params, batch)
    finally:
        ssm_ops.ssm_scan = kernel_scan
    assert ssm_kernel.launches == before + 2 * cfg.n_layers
    torch.testing.assert_close(loss, loss_p, rtol=1e-4, atol=1e-4)
    for path, want in flatten(grads_p).items():
        torch.testing.assert_close(flatten(grads)[path], want, rtol=1e-3, atol=1e-4,
                                   msg=lambda m, path=path: f"{path}: {m}")


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


#: B, T, H, K, V: mamba's layout at small sizes, K 18 (rows that cp.async
#: cannot copy whole), and jamba's head shape (256 heads of K = V = 64)
MAMBA_CASES = [(2, 40, 3, 8, 8), (1, 33, 4, 18, 12), (2, 70, 256, 64, 64)]


def _tols(dtype):
    """test_ssm_kernel_matches_plain's limits: (y, state)."""
    return (3e-5 if dtype == "float32" else 2e-2), 3e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MAMBA_CASES, ids=[f"m{i}" for i in range(len(MAMBA_CASES))])
def test_ssm_kernel_mamba_layout_in_place(cuda, case, dtype):
    """q and k one (B, T, K) row per (b, t), expanded over the heads (head
    stride 0), and g one log decay per (b, t, h) of shape (B, T, H, 1): one
    launch, bit for bit what the kernel gives on contiguous copies of q, k
    and the expanded g, and within test_ssm_kernel_matches_plain's limits
    of the plain scalar-decay chunked form."""
    B, T, H, K, V = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(sum(case))
    c, b = ((torch.randn((B, T, K), generator=gen, device=cuda) * 0.5).to(dt) for _ in range(2))
    v = (torch.randn((B, T, H, V), generator=gen, device=cuda) * 0.5).to(dt)
    g = -torch.exp(torch.randn((B, T, H, 1), generator=gen, device=cuda) - 1.5)
    s0 = torch.randn((B, H, K, V), generator=gen, device=cuda) * 0.3
    q, k = c[:, :, None].expand(B, T, H, K), b[:, :, None].expand(B, T, H, K)
    before = ssm_kernel.launches
    y, s = ssm_scan(q, k, v, g, None, s0, chunk=16, subchunk=8, scalar_decay=True)
    torch.cuda.synchronize()
    assert ssm_kernel.launches == before + 1
    y_copy, s_copy = ssm_kernel.ssm_scan_fwd(q.contiguous(), k.contiguous(), v,
                                             g.expand(B, T, H, K).contiguous(), None, s0)
    torch.cuda.synchronize()
    assert torch.equal(y, y_copy) and torch.equal(s, s_copy)
    want_y, want_s = ssm_scan_chunked(q, k, v, g, None, s0, chunk=16, subchunk=8,
                                      scalar_decay=True)
    tol_y, tol_s = _tols(dtype)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol_y, atol=tol_y)
    torch.testing.assert_close(s, want_s, rtol=tol_s, atol=tol_s)


@pytest.mark.parametrize("extra", [8, 1], ids=["aligned_rows", "unaligned_rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_kernel_strided_inputs_in_place(cuda, dtype, extra):
    """q, k and a per-key g that are slices of wider buffers (row stride
    K + ``extra``: 16-byte rows, or rows cp.async cannot take): read in
    place, bit for bit what contiguous copies give, and within
    test_ssm_kernel_matches_plain's limits of the plain chunked form."""
    B, T, H, K, V = 2, 45, 3, 16, 8
    dt = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(extra)
    def wide(fn):
        """fn of a (B, T, H, K + extra) draw, then its first K columns: a view
        (an elementwise op on a view would return a contiguous tensor)."""
        return fn(torch.randn((B, T, H, K + extra), generator=gen, device=cuda))[..., :K]

    q, k = (wide(lambda x: (x * 0.5).to(dt)) for _ in range(2))
    g = wide(lambda x: -torch.exp(x - 1.5))
    v = (torch.randn((B, T, H, V), generator=gen, device=cuda) * 0.5).to(dt)
    u = torch.randn((H, K), generator=gen, device=cuda) * 0.5
    assert not (q.is_contiguous() or g.is_contiguous())
    before = ssm_kernel.launches
    y, s = ssm_scan(q, k, v, g, u, None, chunk=16, subchunk=8)
    torch.cuda.synchronize()
    assert ssm_kernel.launches == before + 1
    y_copy, s_copy = ssm_kernel.ssm_scan_fwd(q.contiguous(), k.contiguous(), v, g.contiguous(),
                                             u, None)
    torch.cuda.synchronize()
    assert torch.equal(y, y_copy) and torch.equal(s, s_copy)
    want_y, want_s = ssm_scan_chunked(q, k, v, g, u, None, chunk=16, subchunk=8)
    tol_y, tol_s = _tols(dtype)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol_y, atol=tol_y)
    torch.testing.assert_close(s, want_s, rtol=tol_s, atol=tol_s)


def test_hybrid_prefill_runs_scan_per_mamba_layer_and_flash_per_attention_layer(cuda):
    """jamba scaled down (2 blocks of 7 mamba layers and 1 attention layer,
    MoE every second layer), fp32: a prefill launches the scan once per
    mamba layer and flash once per attention layer (its fp32 path), a decode
    step neither, and the logits and caches agree with the same model
    through the plain attention and the plain scan."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    cfg = get_config("jamba-1.5-large-398b").scaled_down()
    kinds = [m for m in cfg.block_pattern()] * cfg.n_blocks
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    assert (n_mamba, n_attn) == (14, 2)
    api = build(cfg, cuda)
    params = api.init(torch.Generator(api.device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda)
    before, fa_before = ssm_kernel.launches, fa_kernel.f32_launches
    with torch.inference_mode():
        logits, cache, _ = api.prefill(params, {"tokens": tokens}, pad_to=97)
        assert ssm_kernel.launches == before + n_mamba
        assert fa_kernel.f32_launches == fa_before + n_attn
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        logits_d, _ = api.decode(params, cache, nxt, 96)
        assert ssm_kernel.launches == before + n_mamba
        plain = build(dataclasses.replace(cfg, attn_impl="full"), cuda)
        kernel_scan = ssm_ops.ssm_scan
        try:
            ssm_ops.ssm_scan = lambda q, k, v, g, u=None, initial_state=None, *, chunk, subchunk, \
                scalar_decay, io_dtype: ssm_scan_chunked(
                    q, k, v, g, u, initial_state, chunk=chunk, subchunk=subchunk,
                    scalar_decay=scalar_decay, io_dtype=io_dtype)
            want, want_cache, _ = plain.prefill(params, {"tokens": tokens}, pad_to=97)
            want_d, _ = plain.decode(params, want_cache, nxt, 96)
        finally:
            ssm_ops.ssm_scan = kernel_scan
    assert ssm_kernel.launches == before + n_mamba
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(logits_d, want_d, rtol=1e-4, atol=1e-4)


#: Bt, T, D, with s0 and D: the Mamba-1 selective scan's cases; the last is
#: the published Jamba's width at the cell's shortest prompt
SCAN1_CASES = [(2, 100, 64, True), (1, 1, 32, False), (1, 130, 96, True),
               (1, 16384, 8192, True)]


def _scan1_inputs(case, dtype, device, seed=0):
    Bt, T, D, extra = case
    g = torch.Generator(device).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=device)
    u, Bm, Cm = (rnd(*s).to(dtype) for s in ((Bt, T, D), (Bt, T, 16), (Bt, T, 16)))
    dt = torch.nn.functional.softplus(rnd(Bt, T, D) - 4.0)
    A = -torch.exp(torch.log(torch.arange(1, 17, device=device, dtype=torch.float32))
                   + 0.5 * (torch.rand((D, 1), generator=g, device=device) - 0.5))
    return u, dt, A, Bm, Cm, (rnd(D) if extra else None), (rnd(Bt, D, 16) if extra else None)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", SCAN1_CASES, ids=[f"c{i}" for i in range(len(SCAN1_CASES))])
def test_selective_scan_kernel_matches_plain(cuda, case, dtype):
    """The kernel against the plain chunked form and, up to T 130, the
    exact step recurrence, on the same (rounded) inputs; the device memory
    it adds is y and the state alone, no (Bt, T, D, N) tensor."""
    dtype = getattr(torch, dtype)
    inputs = _scan1_inputs(case, dtype, cuda)
    u = inputs[0]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n = scan1_kernel.launches
    y, s = scan1_kernel.selective_scan_fwd(*inputs)
    torch.cuda.synchronize()
    assert scan1_kernel.launches == n + 1
    grown = torch.cuda.max_memory_allocated() - before
    assert grown <= y.numel() * y.element_size() + s.numel() * 4 + (1 << 20), grown
    assert y.dtype == dtype and s.dtype == torch.float32
    want_y, want_s = selective_scan_chunked(*inputs, chunk=16)
    tol_y = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol_y, atol=tol_y)
    torch.testing.assert_close(s, want_s, rtol=1e-3, atol=1e-3)
    if case[1] <= 130:
        step_y, step_s = selective_scan_ref(*inputs)
        torch.testing.assert_close(y.float(), step_y.float(), rtol=tol_y, atol=tol_y)
        torch.testing.assert_close(s, step_s, rtol=1e-3, atol=1e-3)


def test_jamba2_prefill_runs_selective_scan_per_mamba_layer(cuda):
    """The published Jamba block, tiny, fp32: a prefill launches the
    selective scan once per Mamba layer (14 of 16) and flash once per
    attention layer, a decode step neither, and the logits agree with the
    same model through the plain scan."""
    from repro_torch.kernels.selective_scan import ops as scan1_ops
    from repro_torch.models.common import ArchConfig, MoEConfig, SSMConfig
    cfg = ArchConfig(arch_id="tiny-jamba", family="hybrid", n_layers=16, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=96, vocab_size=256, attn_every=8, attn_offset=4,
                     use_rope=False, norm_eps=1e-6,
                     moe=MoEConfig(n_experts=4, top_k=2, moe_every=2, renormalize=False),
                     ssm=SSMConfig(kind="mamba1", d_state=16, expand=2, d_conv=4, dt_rank=8),
                     param_dtype="float32", compute_dtype="float32", remat="none")
    api = build(cfg, cuda)
    params = api.init(torch.Generator(api.device).manual_seed(0))
    tokens = torch.randint(0, 256, (2, 96), device=cuda)
    before, fa_before = scan1_kernel.launches, fa_kernel.f32_launches
    with torch.inference_mode():
        logits, cache, _ = api.prefill(params, {"tokens": tokens}, pad_to=97)
        assert scan1_kernel.launches == before + 14
        assert fa_kernel.f32_launches == fa_before + 2
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        api.decode(params, cache, nxt, 96)
        assert scan1_kernel.launches == before + 14
        kernel_scan = scan1_ops.selective_scan
        try:
            scan1_ops.selective_scan = lambda u, dt, A, B, C, D=None, s0=None: \
                selective_scan_chunked(u, dt, A, B, C, D, s0)
            want, _, _ = api.prefill(params, {"tokens": tokens})
        finally:
            scan1_ops.selective_scan = kernel_scan
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def mesh1():
    """A (1, 1) ("data", "model") CUDA mesh over a one-rank NCCL group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        yield make_test_mesh(1, 1, device_type="cuda")
    finally:
        dist.destroy_process_group()


def _on_mesh(mesh, t, placed, heads_dim=2, batch=True):
    """``t`` as a DTensor on the one-rank mesh: replicated, or cut as a
    sharded run cuts it (batch over "data", heads over "model"; on one rank
    each shard is the whole tensor)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    place = ([Replicate(), Replicate()] if placed == "replicate"
             else [Shard(0) if batch else Replicate(), Shard(heads_dim)])
    return DTensor.from_local(t, mesh, place, run_check=False)


@pytest.mark.parametrize("placed", ["replicate", "shard"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"], ids=["tma", "f32"])
def test_flash_through_local_map_matches_direct_call(cuda, mesh1, dtype, placed):
    """Sharded q, k, v go through ``local_map``: one kernel launch on the
    path the direct call takes, its output a DTensor in q's placements and
    bit for bit the direct call's."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels.flash_attention.ops import flash_attention
    case = FLASH_CASES[-1]
    *_, causal, window = case
    q, k, v = (t.to(getattr(torch, dtype)) for t in _flash_inputs(case, cuda))
    want = flash_attention(q, k, v, causal=causal, window=window)
    counts = (fa_kernel.launches, fa_kernel.tma_launches, fa_kernel.f32_launches)
    got = flash_attention(*(_on_mesh(mesh1, t, placed) for t in (q, k, v)),
                          causal=causal, window=window)
    torch.cuda.synchronize()
    path = 1 if dtype == "bfloat16" else 2
    after = (fa_kernel.launches, fa_kernel.tma_launches, fa_kernel.f32_launches)
    assert after[0] == counts[0] + 1 and after[path] == counts[path] + 1
    assert isinstance(got, DTensor)
    assert torch.equal(got.to_local(), want)


@pytest.mark.parametrize("placed", ["replicate", "shard"])
def test_flash_backward_through_local_map_runs_kernel(cuda, mesh1, placed):
    """Sharded bf16 q, k, v with a gradient due: one backward kernel launch
    through ``local_map`` on the rank's local tensors, the gradients DTensors
    whose local dK and dV are bit for bit the direct call's and dQ within
    BWD_REL_L2 / 10 of it (the order of its atomic adds varies)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels.flash_attention.ops import flash_attention
    case = FLASH_CASES[-1]
    *_, causal, window = case
    q, k, v, do = _bwd_inputs(case, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention(*leaves, causal=causal, window=window),
                               leaves, do)
    before = fa_kernel.bwd_launches
    dleaves = [_on_mesh(mesh1, t.clone(), placed).requires_grad_() for t in (q, k, v)]
    out = flash_attention(*dleaves, causal=causal, window=window)
    got = torch.autograd.grad(out, dleaves, _on_mesh(mesh1, do, placed))
    torch.cuda.synchronize()
    assert fa_kernel.bwd_launches == before + 1
    assert all(isinstance(g, DTensor) for g in got)
    got = [g.to_local() for g in got]
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert _rel_l2(got[0], want[0]) <= BWD_REL_L2 / 10


@pytest.mark.parametrize("placed", ["replicate", "shard"])
@pytest.mark.parametrize("layout", ["rwkv", "mamba"])
def test_ssm_scan_through_local_map_matches_direct_call(cuda, mesh1, layout, placed):
    """The scan on sharded inputs goes through ``local_map``: one kernel
    launch, y and the final state DTensors bit for bit the direct call's, in
    rwkv6's layout (bonus u, an initial state) and in mamba's (q and k
    expanded over the heads, one decay per head, read through strides)."""
    from torch.distributed.tensor import DTensor
    B, T, H, K, V = 2, 70, 4, 64, 64
    gen = torch.Generator(cuda).manual_seed(7)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=cuda) * 0.5
    v, s0 = rand(B, T, H, V).bfloat16(), rand(B, H, K, V)
    if layout == "rwkv":
        q, k = rand(B, T, H, K).bfloat16(), rand(B, T, H, K).bfloat16()
        g, u, kw = -torch.exp(rand(B, T, H, K) - 1.5), rand(H, K), {}
    else:
        q = rand(B, T, K).bfloat16()[:, :, None].expand(B, T, H, K)
        k = rand(B, T, K).bfloat16()[:, :, None].expand(B, T, H, K)
        g, u, kw = -torch.exp(rand(B, T, H, 1) - 1.5), None, {"scalar_decay": True}
    want_y, want_s = ssm_scan(q, k, v, g, u, s0, chunk=16, subchunk=8, **kw)
    before = ssm_kernel.launches
    dt = [_on_mesh(mesh1, t, placed) for t in (q, k, v, g)]
    du = None if u is None else _on_mesh(mesh1, u, placed, heads_dim=0, batch=False)
    ds0 = _on_mesh(mesh1, s0, placed, heads_dim=1)
    y, s = ssm_scan(*dt, du, ds0, chunk=16, subchunk=8, **kw)
    torch.cuda.synchronize()
    assert ssm_kernel.launches == before + 1
    assert isinstance(y, DTensor) and isinstance(s, DTensor)
    assert torch.equal(y.to_local(), want_y) and torch.equal(s.to_local(), want_s)


#: the tracker's peak against the allocator's on a chain of products, bytes:
#: the caching allocator rounds each block up to 512 bytes, and the chain's
#: 2 MiB blocks are whole multiples of it, so the two should agree exactly;
#: one block of slack
LIVE_BYTES_SLACK = 2 << 20


def test_live_bytes_peak_matches_cuda_allocator(cuda):
    """``roofline.LiveBytes`` (the dry run's temp bytes) on the card: the
    peak of a chain of products and activations above the bytes allocated
    before it equals ``torch.cuda.max_memory_allocated`` minus that
    baseline.  The product runs once before, so cuBLAS's workspace is in
    the baseline."""
    gen = torch.Generator(cuda).manual_seed(3)
    x = torch.randn((1024, 512), generator=gen, device=cuda)
    ws = [torch.randn((512, 512), generator=gen, device=cuda) for _ in range(4)]
    x @ ws[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with LiveBytes() as live:
        h = x
        for w in ws:
            h = torch.tanh(h @ w) + h
        out = h.sum()
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    assert torch.isfinite(out)
    assert live.peak > 0 and abs(live.peak - measured) <= LIVE_BYTES_SLACK
