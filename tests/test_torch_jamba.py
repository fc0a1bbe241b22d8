"""The published Jamba block in the port (``ssm.kind="mamba1"``, attention
placed at ``attn_offset`` without RoPE, top-k gates not renormalised)
against the benchmark's plain reference, ``portbench/reference/jamba.py``,
on seeded random weights at a tiny size (two periods of 8 layers, 4
experts), in fp32 on the CPU; and the Mamba-1 selective scan's plain forms
against each other and through ``gradcheck``."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan.ref import (selective_scan_chunked,
                                                    selective_scan_ref)
from repro_torch.models import layers, moe, transformer
from repro_torch.models.common import ArchConfig, MoEConfig, SSMConfig
from repro_torch.models.convert import flatten
from repro_torch.models.registry import build

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import jamba as ref  # noqa: E402

#: the reference's configuration keys at the tiny size
HF = dict(name="tiny-jamba", hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
          intermediate_size=96, vocab_size=256, num_experts=4, num_experts_per_tok=2,
          mamba_d_state=16, mamba_dt_rank=8, mamba_expand=2, mamba_d_conv=4,
          num_hidden_layers=16, attn_layer_period=8, attn_layer_offset=4,
          expert_layer_period=2, expert_layer_offset=1, rms_norm_eps=1e-6,
          capacity_factor=1.25)
TOL = dict(rtol=1e-4, atol=1e-4)


def arch(capacity_factor=1.25) -> ArchConfig:
    """The port's configuration of ``HF``."""
    return ArchConfig(
        arch_id="tiny-jamba", family="hybrid", n_layers=16, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab_size=256, attn_every=8, attn_offset=4, use_rope=False, norm_eps=1e-6,
        moe=MoEConfig(n_experts=4, top_k=2, moe_every=2, capacity_factor=capacity_factor,
                      renormalize=False),
        ssm=SSMConfig(kind="mamba1", d_state=16, expand=2, d_conv=4, dt_rank=8),
        param_dtype="float32", compute_dtype="float32", remat="none")


def params(cfg: ArchConfig, seed=0):
    """The port's init from ``seed``, every RMSNorm scale and D moved off 1
    so that a dropped scale shows."""
    p = build(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for path, t in flatten(p).items():
        if path.endswith("scale") or path.endswith("/D"):
            t.add_(0.1 * torch.randn(t.shape, generator=gen))
    return p


def hf(**over) -> dict:
    return dict(HF, **over)


def tokens(B, S, seed=3):
    return torch.randint(0, 256, (B, S), generator=torch.Generator().manual_seed(seed))


def layer_of(p, i: int) -> dict:
    """Layer i's port parameters as the reference reads them."""
    return ref.layer_params(flatten(p), HF, i)


def test_layer_pattern_has_attention_at_offset_4_and_moe_on_odd_layers():
    cfg = arch()
    kinds = transformer._layer_kinds(cfg) * cfg.n_blocks
    assert kinds == [ref.layer_kind(HF, i) for i in range(16)]
    assert [i for i, (m, _) in enumerate(kinds) if m == "attn"] == [4, 12]
    assert [i for i, (_, f) in enumerate(kinds) if f == "moe"] == list(range(1, 16, 2))
    # unset, attention stays last in each block, as the reference's jamba has it
    assert dataclasses.replace(cfg, attn_offset=None).block_pattern()[-1] == "attn"


@pytest.mark.parametrize("T", [1, 17, 40, 64])
@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_scan_matches_step_recurrence(T, chunk):
    g = torch.Generator().manual_seed(T * 100 + chunk)
    B, D, N = 2, 24, 16
    u, Bm, Cm = (torch.randn(s, generator=g) for s in ((B, T, D), (B, T, N), (B, T, N)))
    dt = 0.2 * torch.rand((B, T, D), generator=g)
    A = -torch.exp(torch.randn((D, N), generator=g))
    Dv, s0 = torch.randn(D, generator=g), torch.randn((B, D, N), generator=g)
    want_y, want_s = selective_scan_ref(u, dt, A, Bm, Cm, Dv, s0)
    y, s = selective_scan_chunked(u, dt, A, Bm, Cm, Dv, s0, chunk=chunk)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(s, want_s, **TOL)
    # the dispatch on the CPU is the chunked form, the state fp32
    y2, s2 = scan_ops.selective_scan(u, dt, A, Bm, Cm, Dv, s0, chunk=chunk)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    assert s2.dtype == torch.float32


def test_scan_shapes_on_meta():
    u = torch.empty((1, 40, 32), device="meta")
    y, s = scan_ops.selective_scan(u, u, torch.empty((32, 16), device="meta"),
                                   torch.empty((1, 40, 16), device="meta"),
                                   torch.empty((1, 40, 16), device="meta"))
    assert (tuple(y.shape), tuple(s.shape)) == ((1, 40, 32), (1, 32, 16))


@pytest.mark.parametrize("i", [0, 9])
def test_mamba1_mixer_matches_reference(i):
    cfg = arch()
    p = params(cfg)
    b, j = divmod(i, 8)
    x = torch.randn((2, 37, 64), generator=torch.Generator().manual_seed(i))
    out, (s_ssm, s_conv) = transformer.mamba1_apply(
        transformer._index(p["blocks"], b)["layers"][j]["mamba"], x, cfg)
    torch.testing.assert_close(out, ref.mamba(x, layer_of(p, i), HF, "fp32"), **TOL)
    assert tuple(s_ssm.shape) == (2, 128, 16) and tuple(s_conv.shape) == (2, 3, 128)


def test_attention_has_no_rope():
    cfg = arch()
    p = params(cfg)
    x = torch.randn((2, 33, 64), generator=torch.Generator().manual_seed(5))
    a = transformer._index(p["blocks"], 0)["layers"][4]["attn"]
    want = ref.self_attention(x, layer_of(p, 4), HF, "fp32")
    out, _ = layers.attention_apply(a, x, cfg, use_rope=cfg.use_rope)
    torch.testing.assert_close(out, want, **TOL)
    roped, _ = layers.attention_apply(a, x, cfg, use_rope=True)
    assert (roped - want).abs().max() > 1e-2


def test_gates_are_not_renormalised():
    cfg = arch(capacity_factor=2.0)
    p = params(cfg)
    x = torch.randn((2, 29, 64), generator=torch.Generator().manual_seed(6))
    lay = transformer._index(p["blocks"], 0)["layers"][1]["moe"]
    want = ref.experts(x, layer_of(p, 1), hf(capacity_factor=2.0), "fp32")
    out, _ = moe.moe_apply(lay, x, cfg)
    torch.testing.assert_close(out, want, **TOL)
    renorm = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, renormalize=True))
    assert (moe.moe_apply(lay, x, renorm)[0] - want).abs().max() > 1e-2


@pytest.mark.parametrize("B,S", [(1, 40), (2, 64)])
def test_prefill_logits_match_reference(B, S):
    """Capacity 1.25: the experts drop pairs, as the reference mirrors."""
    cfg = arch()
    p = params(cfg)
    tok = tokens(B, S)
    logits, cache, pos = build(cfg, "cpu").prefill(p, {"tokens": tok})
    want = ref.last_logits(flatten(p), tok, HF)
    torch.testing.assert_close(logits[:, -1], want, **TOL)
    assert pos == S and tuple(cache["ssm"].shape) == (2, 7, B, 128, 16)


def test_prefill_then_decode_matches_full_forward():
    """Prefill, then 4 decode steps through the cache, each against the
    reference's full forward over the extended prompt.  Capacity 2.0 holds
    every pair (C >= T), so a step and the full forward route alike."""
    cfg = arch(capacity_factor=2.0)
    want_cfg = hf(capacity_factor=2.0)
    p = params(cfg)
    api = build(cfg, "cpu")
    tok = tokens(2, 21)
    logits, cache, pos = api.prefill(p, {"tokens": tok}, pad_to=25)
    w = flatten(p)
    for step in range(4):
        nxt = logits[:, -1].argmax(-1)[:, None]
        tok = torch.cat([tok, nxt], dim=1)
        logits, cache = api.decode(p, cache, nxt, pos + step)
        torch.testing.assert_close(logits[:, -1], ref.last_logits(w, tok, want_cfg), **TOL)


def test_scan_plain_backward_gradcheck():
    g = torch.Generator().manual_seed(11)
    B, T, D, N = 1, 7, 4, 16
    u, Bm, Cm = (torch.randn(s, generator=g, dtype=torch.float64)
                 for s in ((B, T, D), (B, T, N), (B, T, N)))
    dt = 0.3 * torch.rand((B, T, D), generator=g, dtype=torch.float64)
    A = -torch.exp(torch.randn((D, N), generator=g, dtype=torch.float64))
    Dv = torch.randn(D, generator=g, dtype=torch.float64)
    s0 = torch.randn((B, D, N), generator=g, dtype=torch.float64)
    inputs = [t.requires_grad_() for t in (u, dt, A, Bm, Cm, Dv, s0)]
    assert torch.autograd.gradcheck(
        lambda *ts: scan_ops.selective_scan(*ts, chunk=4), inputs)
