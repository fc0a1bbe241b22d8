#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``src/repro_torch`` (``nvcc``,
   one process per source, all at once);
3. holds each kernel against its plain PyTorch version on the card:
   flash attention (``kernel_check``: the TMA / wgmma path on every bf16
   case it can describe, the mma.sync path on a head dim of 20 and on views
   one element off 16-byte alignment, the fp32 path), the lanesum32 checksum
   (``checksum_check``, bit-exact, a buffer above 2 GiB included) and the
   ssm_scan recurrence (``ssm_check``: tests/test_kernels.py's cases,
   strong and scalar decay, the chunked kernel's edges (T 1 and 17, a
   decay of about -20 a step, K 128 and 18), the full-width rwkv6 head
   shape at T 300, 512 and 5120, y and the final state);
4. times each kernel, its plain version and its bound at the main-path
   shapes (``kernel_times``, ``checksum_times``, ``ssm_times``); for
   ssm_scan and flash attention also the device time per call from
   ``torch.profiler``, for flash of the kernel and SDPA alike, and their
   ratio (where the window cuts, SDPA with the band as a mask computes the
   kernel's function, and SDPA with ``is_causal`` over every causal pair
   is timed beside it);
5. serves full-width h2o-danube-3-4b (24 layers, bf16, random weights from
   a seed) through ``repro_torch.launch.serve`` (``serve``): 4 requests x
   512-token prompts to 32 tokens, then 1 request x a 5120-token prompt to
   8 tokens, and checks finite logits, 24 flash launches per prefill, all
   on the TMA path, the same greedy first token through the plain
   attention, and logits about as close to an fp32 prefill as the plain
   bf16 prefill's; one profiled prefill gives the device busy time, idle
   share and the flash kernel's share of the busy time;
6. serves full-width rwkv6-7b (32 layers, bf16) the same two ways
   (``serve_rwkv``): 32 scan launches per prefill and none per decode step,
   no flash or checksum launch, finite logits; in fp32 compute the kernel
   path's greedy first tokens equal to the plain scan's on every request and
   its logits within FP32_LOGIT_LIMIT of them (a scan fed bf16 inputs must
   land beyond it); bf16 logits as close to an fp32 prefill as the plain
   bf16 prefill's; tokens/s, peak memory, and the device busy time and
   idle share of a profiled prefill and decode step;
7. serves full-width, full-depth granite-moe-1b-a400m (24 MoE layers of 32
   experts, top 8, bf16) the same two ways (``serve_moe``): 24 flash
   launches per prefill, all on the TMA path, finite logits; in fp32
   compute the kernel path's greedy first tokens equal to the plain
   attention's and its logits within MOE_FP32_LOGIT_LIMIT of them (the
   kernel fed bf16-rounded q, k, v must land beyond it); in bf16 the logit
   error against fp32 and the routing decisions that differ from the plain
   run are printed, not gated (top-k routing turns bf16 noise into other
   experts); tokens/s and a profiled prefill;
8. runs one jamba mamba mixer at full width (``mamba_layer``: d_model
   8192, 256 heads of 64, d_state 64) at B4 x T512 and B1 x T5120, then 8
   decode steps: one scan launch per prefill and none per decode step;
   the scan's q and k are C_t and B_t expanded over the heads and g one
   value per (b, t, h), read in place: the kernel's y and state against
   the plain scalar-decay chunked form (fp32 and bf16), bit for bit what
   it gives on contiguous copies, and device memory growing by no more
   than y and the state during the call; its device time and bound at both
   shapes, its share of the layer's prefill, and the memory and time the
   copying call would add;
9. serves jamba scaled down (2 blocks of 7 mamba + 1 attention layer, MoE
   every second layer, fp32) through ``repro_torch.launch.serve``
   (``serve_hybrid``): the scan once per mamba layer and flash once per
   attention layer in a prefill, neither in decode; prefill and decode
   logits against the same model through plain attention and the plain
   scan, within HYBRID_FP32_LOGIT_LIMIT (a scan fed bf16 inputs must land
   beyond it), and the same greedy first tokens;
10. trains full-width h2o-danube-3-4b cut to 2 layers through
   ``repro_torch.launch.train`` (batch 2 x 2048 tokens, bf16 parameters,
   fp32 AdamW moments, a corpus and checkpoints on the POSIX Connector in
   a temporary directory): a run stopped by an injected failure at step 5,
   then a restart from the step-4 checkpoint; it checks the loss and
   gradients against plain-attention steps in bf16 and fp32, the kernel
   launches per step and per checkpoint, the restored bytes, the digests
   on disk against numpy, and that a flipped byte fails the restore; the
   restart's save is replicated (``--replicate-to s3``) by a third-party
   ``TransferService`` task to an emulated object store in host memory:
   the task must succeed with integrity on, every leaf's lanesum32 at the
   destination must equal the digest the card took at save time, the
   mirror must restore onto the card byte for byte, and a byte flipped in
   the mirror must fail its restore (``replication`` in ``train``);
11. trains full-width rwkv6-7b cut to 2 layers the same way, without
   checkpoints (``train_rwkv``): 2 scan launches per layer and step (the
   forward, then the block remat's recompute; the backward is the plain
   chunked form's), no flash or checksum launch, one step's per-token
   losses and gradients through the kernel in bf16 and fp32 against the
   plain scan's, the warm training rate and a profiled step's device time
   split into the scan kernel, the plain scan backward, AdamW and the rest;
12. prints one JSON line of per-kernel launches (by path), times and
   bounds, then ``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero.  Without CUDA, or without the repository
around it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

ARCH = "h2o-danube-3-4b"
#: (requests, prompt tokens, generated tokens) served at full width
WORKLOADS = [(4, 512, 32), (1, 5120, 8)]
#: B, Sq, Skv, H, KV, dh, causal, window: tests/test_kernels.py's ATTN_CASES,
#: then the full-width head shape at small lengths and at the two served ones
CHECK_CASES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 128, 128, 4, 4, 128, True, None),
    (1, 96, 96, 8, 1, 32, True, None),
    (2, 64, 256, 4, 4, 48, False, None),
    (1, 256, 256, 4, 2, 64, True, 96),
    (1, 130, 130, 2, 2, 80, True, 64),
    (1, 64, 64, 32, 8, 120, True, 48),
    (2, 300, 300, 32, 8, 120, True, 128),
    (1, 333, 333, 8, 2, 128, True, 200),  # lengths ragged against the 128-row tiles
    (2, 130, 333, 4, 1, 64, False, 100),
]
#: bf16 inputs a TMA tensor map cannot describe, which take the mma.sync
#: kernel: a head dim of 20 (40-byte rows), and q, k, v whose data start one
#: element (2 bytes) past a 16-byte boundary
SYNC_CASES = [((2, 200, 200, 4, 2, 20, True, None), 0),
              ((1, 300, 300, 32, 8, 120, True, 128), 1)]
MAIN_CASES = [(4, 512, 512, 32, 8, 120, True, 4096),
              (1, 5120, 5120, 32, 8, 120, True, 4096),
              (2, 2048, 2048, 32, 8, 120, True, 4096),  # the training step's
              (4, 512, 512, 16, 8, 64, True, None)]  # granite-moe's 4 x 512 prefill
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # rtol = atol, as tests/test_kernels.py
#: served logits may be this many times further from an fp32 prefill than
#: the plain-attention bf16 prefill's logits are
LOGIT_SLACK = 1.5
#: rwkv6-7b fp32 prefill, kernel scan against plain scan: largest logit
#: difference allowed.  A sound kernel read 1.66e-4 (fp32 order of sums
#: through 32 layers); the scan fed bf16 q, k, v (ssm_bf16_io) read 0.17 to
#: 0.19 and must stay above it.
FP32_LOGIT_LIMIT = 2e-3

#: calls under the profiler for kernel_times' device time per call, and runs
#: of a profile that lost kernel records before the phase fails
PROFILED_CALLS, PROFILE_TRIES = 20, 5
#: H100 SXM data sheet, dense: memory bytes/s, bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12

#: training: full width, depth cut to TRAIN_LAYERS (checkpoint bytes on disk
#: and the time limit), batch x tokens, injected failure before FAIL_AT
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, FAIL_AT, CKPT_EVERY = 2, 2, 2048, 6, 5, 2
WARM_STEPS = 12  # unprofiled warm steps timed one by one for the training rate
#: the emulated object store the training restart replicates its save to
MIRROR_PROVIDER = "s3"
#: rwkv6 training: full width cut to TRAIN_LAYERS layers, TRAIN_BATCH x
#: TRAIN_SEQ tokens a step, this many steps through run_training
RWKV_TRAIN_STEPS = 3
#: checksum_check cases: tests/test_kernels.py's six shape and dtype pairs
CHECKSUM_CASES = [((1024,), "float32"), ((8, 128), "float32"), ((1000,), "float32"),
                  ((333,), "int32"), ((64, 9), "bfloat16"), ((5,), "float32")]
#: words of the fp32 buffer above 2 GiB
BIG_WORDS = 2**29 + 4099

RWKV_ARCH = "rwkv6-7b"
#: (requests, prompt tokens, generated tokens) served at full width and depth
RWKV_WORKLOADS = [(4, 512, 32), (1, 5120, 8)]
#: B, T, H, K, V, use_u, chunk, subchunk, kind: tests/test_kernels.py's
#: SSM_CASES, its strong-decay case and a scalar decay (g constant over K),
#: then the full-width rwkv6 head shape at a ragged T and at the two served
#: shapes (the served rwkv6 layers call the scan with chunk 128, subchunk 16)
SSM_SMALL_CASES = [
    (2, 64, 3, 8, 16, False, 32, 8, "random"),
    (1, 128, 2, 16, 16, False, 64, 16, "random"),
    (2, 48, 2, 8, 8, True, 16, 8, "random"),
    (1, 40, 4, 8, 8, True, 16, 4, "random"),
    (1, 256, 1, 32, 32, False, 128, 16, "random"),
    (1, 64, 2, 8, 8, True, 32, 8, "strong"),
    (2, 48, 3, 8, 8, False, 16, 8, "scalar"),
]
#: the chunked kernel's edges, fp32 and bf16: T of 1 and 17 (one ragged
#: chunk), a decay of about -20 a step (``harsh``: a factorisation about a
#: sub-chunk's start would overflow there), K = 128 with V = 40 (a ragged
#: 32-column block), K = 18 (rows that cp.async cannot copy whole), and
#: enough heads for 64-column blocks with V = 72 (a ragged one)
SSM_EDGE_CASES = [
    (1, 1, 2, 8, 8, True, 16, 8, "random"),
    (2, 17, 3, 16, 8, False, 16, 8, "random"),
    (2, 70, 2, 64, 64, True, 32, 16, "harsh"),
    (1, 45, 2, 8, 16, False, 16, 8, "harsh"),
    (1, 100, 2, 128, 40, True, 32, 16, "random"),
    (1, 33, 2, 18, 12, True, 16, 4, "random"),
    (3, 40, 48, 16, 72, True, 16, 8, "random"),
]
SSM_WIDE_CASES = [(2, 300, 64, 64, 64, True, 128, 16, "random")]
SSM_MAIN_CASES = [(4, 512, 64, 64, 64, True, 128, 16, "random"),
                  (1, 5120, 64, 64, 64, True, 128, 16, "random")]
#: fp32: rtol = atol as tests/test_kernels.py (3e-5; 1e-4 for strong decay)
SSM_TOL = {"random": 3e-5, "scalar": 3e-5, "strong": 1e-4, "harsh": 3e-5}
#: bf16 y: two bf16 ulps (an ulp is at most 2^-7 of the value), since the
#: kernel and the plain version each round their fp32 y to bf16 once
SSM_BF16_RTOL = 2.0 ** -6
#: H100 SXM data sheet: fp32 FLOP/s on the CUDA cores (no tensor cores)
PEAK_FP32_FLOPS = 67e12

MOE_ARCH = "granite-moe-1b-a400m"
#: (requests, prompt tokens, generated tokens) served at full width and depth
MOE_WORKLOADS = [(4, 512, 32), (1, 5120, 8)]
#: granite-moe fp32 prefill, flash kernel against plain attention: largest
#: logit difference allowed.  A sound kernel read 4.2e-6 / 7.6e-6 at 4 x 512
#: / 1 x 5120 (no routing decision differed); the kernel fed bf16-rounded
#: q, k, v read 0.109 / 0.036 and must stay above it.
MOE_FP32_LOGIT_LIMIT = 1e-3

#: jamba: one mamba mixer at full width, (batch, tokens) of its prefills,
#: then this many one-token decode steps
HYBRID_ARCH = "jamba-1.5-large-398b"
MAMBA_SHAPES = [(4, 512), (1, 5120)]
MAMBA_DECODE_STEPS = 8
#: B, T, H, K, V, use_u, chunk, subchunk, kind: the mamba layer's scan at
#: full width (256 heads, K = V = 64, one decay per head), both shapes
MAMBA_MAIN_CASES = [(4, 512, 256, 64, 64, False, 512, 128, "mamba"),
                    (1, 5120, 256, 64, 64, False, 512, 128, "mamba")]
#: allocator slack per tensor in the copy-free check: a block may hold up to
#: 1 MiB past its 512-byte rounded request (CUDA caching allocator)
ALLOC_SLACK = 2 << 20
#: the scaled-down hybrid stack served in fp32 (requests, prompt, generated)
HYBRID_WORKLOADS = [(2, 256, 8)]
#: its logits, flash and scan kernels against plain attention and the plain
#: scan: largest difference allowed.  A sound pair of kernels read at most
#: 1.02e-5 over the prefill and 7 decode steps; the scan fed bf16 q, k, v
#: (ssm_bf16_io) read 0.048 and must stay above it.
HYBRID_FP32_LOGIT_LIMIT = 1e-3


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def attention_work(B, Sq, Skv, H, KV, dh, causal, window, elem_bytes):
    """(bytes, flops) the attention forward must move and do: q, k, v read
    once, o written once; 4 * dh flops per unmasked (q, k) pair."""
    pairs = 0
    for q in range(Sq):
        lo = max(0, q - window + 1) if window is not None else 0
        hi = min(Skv, q + 1) if causal else Skv
        pairs += max(0, hi - lo)
    nbytes = elem_bytes * dh * (2 * B * Sq * H + 2 * B * Skv * KV)
    return nbytes, 4 * dh * pairs * B * H


def time_ms(fn, torch, min_s=0.2):
    """Mean device time of one call, by CUDA events over a run of calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    n = max(3, min(200, int(min_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def attn_inputs(case, dtype, seed, device, torch, offset=0):
    """q, k, v of ``case``; with ``offset``, each a view that starts that many
    elements into its buffer."""
    B, Sq, Skv, H, KV, dh, _, _ = case
    gen = torch.Generator(device).manual_seed(seed)
    return [torch.randn(math.prod(shape) + offset, generator=gen, device=device).to(dtype)
            [offset:].view(shape)
            for shape in ((B, Sq, H, dh), (B, Skv, KV, dh), (B, Skv, KV, dh))]


def flash_counts(fa_kernel):
    """The flash wrapper's launch counts: (all, TMA, mma.sync, fp32)."""
    return (fa_kernel.launches, fa_kernel.tma_launches, fa_kernel.sync_launches,
            fa_kernel.f32_launches)


def reset_flash_counts(fa_kernel):
    fa_kernel.launches = fa_kernel.tma_launches = 0
    fa_kernel.sync_launches = fa_kernel.f32_launches = 0


def kernel_check(torch, fa_kernel, fa_ref, device):
    """Kernel against the plain chunked version and attention_ref on the card.

    The limit is ``atol + rtol * |want|`` with rtol = TOL.  On CHECK_CASES
    atol = TOL too, as in tests/test_kernels.py.  On MAIN_CASES a row mixes
    up to 4096 keys, so its outputs are about 0.03 and an atol of 2e-2
    would hide a fault: there atol is TOL times the mean |want| of each
    (b, q, h) row, the scale of that row's outputs and of its rounding."""
    rows, worst = [], 0.0
    cases = [(c, dt, 0) for c in CHECK_CASES for dt in ("float32", "bfloat16")]
    cases += [(c, "bfloat16", 0) for c in MAIN_CASES]
    cases += [(c, "bfloat16", off) for c, off in SYNC_CASES]
    for i, (case, dt, off) in enumerate(cases):
        *_, causal, window = case
        q, k, v = attn_inputs(case, getattr(torch, dt), i, device, torch, offset=off)
        want_path = ("fp32" if dt == "float32" else
                     "TMA" if (case[5] % 8 == 0 and not off) else "mma.sync")
        check((want_path == "TMA") == fa_kernel.tma_path(q, k, v),
              f"case {case} {dt} offset {off}: tma_path disagrees with {want_path}")
        counts = flash_counts(fa_kernel)
        got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window).float()
        torch.cuda.synchronize()
        took = tuple(a - b for a, b in zip(flash_counts(fa_kernel), counts))
        want = {"TMA": (1, 1, 0, 0), "mma.sync": (1, 0, 1, 0), "fp32": (1, 0, 0, 1)}[want_path]
        check(took == want, f"case {case} {dt}: launches (all, TMA, mma.sync, fp32) {took}, "
                            f"want one on the {want_path} path")
        row = {"case": list(case), "dtype": dt, "offset_elems": off, "path": want_path}
        for name, want in (
                ("plain", fa_ref.chunked_attention(q, k, v, causal=causal, window=window,
                                                   chunk=128)),
                ("attention_ref", fa_ref.attention_ref(q, k, v, causal=causal, window=window))):
            want = want.float()
            err = (got - want).abs()
            atol = (TOL[dt] * want.abs().mean(dim=-1, keepdim=True) if case in MAIN_CASES
                    else torch.full_like(want[..., :1], TOL[dt]))
            share = err / (atol + TOL[dt] * want.abs())
            at = share.argmax()
            row.update({f"max_abs_err_{name}": err.max().item(),
                        f"min_atol_{name}": atol.min().item(),
                        f"max_err_share_of_limit_{name}": share.flatten()[at].item(),
                        f"err_at_worst_share_{name}": err.flatten()[at].item()})
            check(row[f"max_err_share_of_limit_{name}"] <= 1.0,
                  f"kernel vs {name}: case {case} {dt}: {row}")
            del want, err, atol, share
        worst = max(worst, row["max_abs_err_plain"])
        rows.append(row)
    emit({"phase": "kernel_check", "ok": True, "cases": rows})
    return worst


def kernel_times(torch, fa_kernel, fa_ref, F, device):
    """kernel / plain / library times and the bound at the main-path shapes:
    CUDA-event times over a loop of calls, and the device time per call that
    torch.profiler records over PROFILED_CALLS calls, kernel and library
    alike.  The library call is SDPA with ``is_causal`` where the window does
    not cut, else with the causal-and-window band as a boolean mask, which
    takes SDPA off its flash backend; there SDPA with ``is_causal`` (every
    causal pair, a superset of the band) is timed too, as the yardstick a
    user would pick."""
    out = []
    for i, case in enumerate(MAIN_CASES):
        B, Sq, Skv, H, KV, dh, causal, window = case
        q, k, v = attn_inputs(case, torch.bfloat16, 100 + i, device, torch)
        nbytes, flops = attention_work(*case, elem_bytes=2)
        t_mem, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        row = {"B": B, "S": Sq, "H": H, "KV": KV, "dh": dh, "window": window,
               "bytes": nbytes, "flops": flops,
               "ms": time_ms(lambda: fa_kernel.flash_attention_fwd(
                   q, k, v, causal=causal, window=window), torch),
               "plain_ms": time_ms(lambda: fa_ref.chunked_attention(
                   q, k, v, causal=causal, window=window, chunk=1024), torch),
               "bound_ms": max(t_mem, t_ops),
               "bound_by": "bytes" if t_mem >= t_ops else "operations"}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None or window >= Skv:  # SDPA's causal mask is the same mask
            sdpa = dict(is_causal=causal)
        else:
            pos = torch.arange(Sq, device=device)
            sdpa = dict(attn_mask=(pos[None, :] <= pos[:, None])
                        & (pos[None, :] > pos[:, None] - window))

        def lib(**kw):
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **(kw or sdpa))

        row["library_ms"] = time_ms(lib, torch)
        row["library_max_abs_err"] = (lib().transpose(1, 2).float() - fa_ref.chunked_attention(
            q, k, v, causal=causal, window=window).float()).abs().max().item()
        row["kernel_ms"] = row["ms"]
        # device time per call from the profiler's kernel records, which an
        # enqueue-bound loop of events would not show
        timed = [("device_ms", lambda: fa_kernel.flash_attention_fwd(
            q, k, v, causal=causal, window=window)), ("library_device_ms", lib)]
        if "attn_mask" in sdpa:
            causal_lib = lambda: lib(is_causal=True)
            row["library_is_causal_ms"] = time_ms(causal_lib, torch)
            timed.append(("library_is_causal_device_ms", causal_lib))
        for key, fn in timed:
            kernels, n, _, _, _ = profile_device(
                torch, lambda: [fn() for _ in range(PROFILED_CALLS)],
                complete=lambda counts: counts and all(
                    c % PROFILED_CALLS == 0 for c in counts.values()))
            row[key] = sum(kernels.values()) / PROFILED_CALLS
            row[key.replace("_ms", "_kernels_per_call")] = n / PROFILED_CALLS
        row["ratio_to_library"] = row["ms"] / row["library_ms"]
        row["device_ratio_to_library"] = row["device_ms"] / row["library_device_ms"]
        if "attn_mask" in sdpa:
            row["device_ratio_to_library_is_causal"] = (row["device_ms"]
                                                        / row["library_is_causal_device_ms"])
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["device_share_of_bound"] = row["bound_ms"] / row["device_ms"]
        out.append(row)
        del q, k, v, qt, kt, vt, sdpa
    emit({"phase": "kernel_times", "rows": out})
    return out


def serve_full_width(torch, serve, build, fa_kernel, cs_kernel, ssm_kernel, device):
    """The serving path: full-width serving through repro_torch.launch.serve."""
    results, launches = [], 0
    for B, S, gen_len in WORKLOADS:
        args = serve.parse_args(["--arch", ARCH, "--no-scaled-down", "--requests", str(B),
                                 "--prompt-len", str(S), "--gen-len", str(gen_len),
                                 "--device", str(device), "--seed", "0"])
        api, params, tokens = serve.setup(args)
        cfg = api.cfg
        check(cfg == serve.get_config(ARCH), f"not the full-width config: {cfg}")
        serve.serve(api, params, tokens, 2)  # warm-up: first-call set-up is not timed
        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        res = serve.serve(api, params, tokens, gen_len)
        n, n_tma, n_sync, n_f32 = flash_counts(fa_kernel)
        launches += n
        check(n == cfg.n_layers, f"{n} kernel launches in one prefill, want {cfg.n_layers}")
        check(n_tma == n, f"serving took the mma.sync path {n_sync} / the fp32 path "
                          f"{n_f32} times")
        check(cs_kernel.launches == 0, "serving launched the checksum kernel")
        check(ssm_kernel.launches == 0, "dense serving launched the scan kernel")
        logits = res["logits"]
        check(tuple(logits.shape) == (B, 1, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        toks = res["tokens"]
        check(tuple(toks.shape) == (B, gen_len) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, f"generated tokens {tuple(toks.shape)}")
        peak_mem = torch.cuda.max_memory_allocated(device)

        # one profiled prefill: device busy time and the flash kernel's share
        def prefill():
            return api.prefill(params, {"tokens": tokens})

        with torch.inference_mode():
            reset_flash_counts(fa_kernel)
            pre_wall = statistics.median(wall_ms(torch, prefill, 3))
            pre_all, pre_tma, pre_sync, _ = flash_counts(fa_kernel)  # 3 prefills
            by_name, pre_n, _, _, _ = profile_device(
                torch, prefill, complete=lambda counts: sum(
                    c for name, c in counts.items() if "attn_fwd_bf16_tma" in name) == cfg.n_layers)
        check(pre_all == pre_tma == 3 * cfg.n_layers and pre_sync == 0,
              f"3 prefills: {pre_all} launches, {pre_tma} TMA and {pre_sync} mma.sync, "
              f"want {3 * cfg.n_layers} on the TMA path")
        pre_busy = sum(by_name.values())
        pre_fa = sum(ms for name, ms in by_name.items() if "attn_fwd_bf16_tma" in name)
        check(pre_fa > 0, "the profiled prefill shows no attn_fwd_bf16_tma kernel")

        # the same prefill through plain attention, in bf16 and in fp32
        plain = build(dataclasses.replace(cfg, attn_impl="full"), device)
        exact = build(dataclasses.replace(cfg, attn_impl="full", compute_dtype="float32"),
                      device)
        before = flash_counts(fa_kernel)
        with torch.inference_mode():
            logits_plain, _, _ = plain.prefill(params, {"tokens": tokens})
            logits_exact, _, _ = exact.prefill(params, {"tokens": tokens})
        check(flash_counts(fa_kernel) == before,
              f"the plain-attention prefills launched the kernel: (all, TMA, mma.sync, fp32) "
              f"{before} -> {flash_counts(fa_kernel)}")
        diff = (logits - logits_plain).abs().max().item()
        err = (logits - logits_exact).abs().max().item()
        err_plain = (logits_plain - logits_exact).abs().max().item()
        first, first_plain = logits[:, -1].argmax(-1), logits_plain[:, -1].argmax(-1)
        top2 = logits_plain[:, -1].topk(2, dim=-1).values
        row = {"requests": B, "prompt_len": S, "gen_len": gen_len,
               "kernel_launches": n, "flash_mma_sync_launches": n_sync + pre_sync,
               "prefill_s": res["prefill_s"],
               "decode_s": res["decode_s"], "prefill_tok_s": res["prefill_tok_s"],
               "decode_tok_s": res["decode_tok_s"], "max_memory_allocated": peak_mem,
               "prefill_profile": {"wall_ms_unprofiled": pre_wall, "device_busy_ms": pre_busy,
                                   "idle_share": 1.0 - pre_busy / pre_wall, "kernels": pre_n,
                                   "flash_kernel_ms": pre_fa,
                                   "flash_kernel_share_of_busy": pre_fa / pre_busy,
                                   "flash_tma_launches": pre_tma // 3,
                                   "flash_mma_sync_launches": pre_sync // 3},
               "max_abs_logit_diff_vs_plain": diff,
               "max_abs_logit_err_vs_fp32": err,
               "plain_max_abs_logit_err_vs_fp32": err_plain,
               "logit_err_ratio": err / err_plain,
               "min_top2_margin_plain": (top2[:, 0] - top2[:, 1]).min().item(),
               "first_tokens": first.tolist(), "sample_tokens": toks[0, :8].tolist()}
        emit({"phase": "serve", **row})
        check(bool((first == first_plain).all()),
              f"greedy first token {first.tolist()} vs plain {first_plain.tolist()}")
        # the kernel path may be no further from the fp32 prefill than the plain
        # bf16 one is, with LOGIT_SLACK for the spread of a maximum over logits
        check(err <= LOGIT_SLACK * err_plain,
              f"logits {err} from the fp32 prefill; the plain bf16 one is {err_plain}")
        results.append(row)
        del api, params, tokens, res, logits, logits_plain, logits_exact, plain, exact, prefill
        torch.cuda.empty_cache()
    return results, launches


def checksum_inputs(torch, device):
    """(name, tensor) pairs of checksum_check, all on the card."""
    gen = torch.Generator(device).manual_seed(7)
    out = []
    for shape, dt in CHECKSUM_CASES:
        if dt == "int32":
            x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=device,
                              dtype=torch.int32)
        else:
            x = torch.randn(shape, generator=gen, device=device).to(getattr(torch, dt))
        out.append((f"{dt}{list(shape)}", x))
    b8 = torch.randint(0, 256, (4099,), generator=gen, device=device, dtype=torch.uint8)
    out += [(f"uint8[{n}]", b8[:n]) for n in (1, 2, 3, 5, 7)]
    f32 = torch.randn(4099, generator=gen, device=device)
    bf = f32.to(torch.bfloat16)
    out += [("bfloat16[1001]", bf[:1001]),
            ("int32 0-d", torch.tensor(-123456789, dtype=torch.int32, device=device)),
            ("float32[37,53].T", f32[:37 * 53].reshape(37, 53).T),
            ("bfloat16[3:1004] (offset 6 bytes)", bf[3:1004]),
            ("uint8[1:1002] (offset 1 byte)", b8[1:1002]),
            ("float32[1:1001] (offset 4 bytes)", f32[1:1001])]
    return out


def checksum_check(torch, cs_ops, cs_ref, device):
    """The kernel against its plain PyTorch version and the numpy
    digest_ref, bit-exact, and a flipped bit against the kernel."""
    rows = []

    def one(name, x):
        got = cs_ops.checksum_digest(x)
        plain = cs_ref.digest_of(*cs_ref.lanesum32_torch(x))
        host = x.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
        numpy = cs_ref.digest_ref(host.data)
        rows.append({"case": name, "nbytes": host.size, "kernel": got, "plain": plain,
                     "digest_ref": numpy,
                     "max_abs_word_diff": max(abs(int(got[i:i + 8], 16) - int(plain[i:i + 8], 16))
                                              for i in (0, 8))})
        check(got == plain == numpy, f"checksum {name}: kernel {got}, plain {plain}, "
                                     f"digest_ref {numpy}")
        return got

    for name, x in checksum_inputs(torch, device):
        one(name, x)
    # one fp32 buffer above 2 GiB, then one bit flipped in its last words,
    # above byte 2^31
    big = torch.randn(BIG_WORDS, generator=torch.Generator(device).manual_seed(8),
                      device=device)
    d0 = one(f"float32[{BIG_WORDS}] ({BIG_WORDS * 4} bytes)", big)
    word = BIG_WORDS - 1000
    big.view(torch.int32)[word] ^= 1 << 3
    d1 = one(f"float32[{BIG_WORDS}], bit 3 of byte {word * 4} flipped", big)
    check(d1 != d0, "a flipped bit above 2 GiB left the digest unchanged")
    small = torch.randn(4096, generator=torch.Generator(device).manual_seed(9), device=device)
    d2 = cs_ops.checksum_digest(small)
    small.view(torch.int32)[1234 // 4] ^= 1
    check(cs_ops.checksum_digest(small) != d2, "a flipped bit left the digest unchanged")
    torch.cuda.synchronize()
    emit({"phase": "checksum_check", "ok": True, "cases": rows})
    del big
    torch.cuda.empty_cache()
    return max(r["max_abs_word_diff"] for r in rows)


def checksum_times(torch, cs_kernel, cs_ref, device, largest_leaf):
    """Kernel / plain times and the byte bound for the largest leaf of the
    training state and a 1 GiB buffer.  No single PyTorch call computes
    lanesum32, so there is no library time.  For the largest leaf, also the
    host time of numpy ``digest_ref`` over its bytes, the reference's way
    to digest a checkpoint leaf (on this machine's CPU, one run)."""
    out = []
    gen = torch.Generator(device).manual_seed(10)
    for i, (name, shape, dt) in enumerate((largest_leaf, ("1 GiB", (2**28,), torch.float32))):
        x = torch.randn(shape, generator=gen, device=device).to(dt)
        acc = torch.zeros(2, dtype=torch.int32, device=device)
        nbytes = x.numel() * x.element_size()
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        ms = time_ms(lambda: cs_kernel.lanesum32_into(x, acc), torch)
        out.append({"buffer": name, "shape": list(shape), "dtype": str(dt), "bytes": nbytes,
                    "ms": ms, "kernel_ms": ms,
                    "plain_ms": time_ms(lambda: cs_ref.lanesum32_torch(x), torch),
                    "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
                    "share_of_bound": bound / ms})
        if i == 0:
            host = x.reshape(-1).view(torch.uint8).cpu().numpy()
            t0 = time.perf_counter()
            cs_ref.digest_ref(host.data)
            out[-1]["host_digest_ref_ms"] = (time.perf_counter() - t0) * 1e3
        del x
    emit({"phase": "checksum_times", "rows": out})
    return out


def ssm_inputs(case, dtype, seed, device, torch):
    """q, k, v in ``dtype``; g, s0, u fp32; distributed as tests/test_kernels.py's
    ``_ssm_inputs`` draws them (``strong``: log decays about -4.5 a step;
    ``harsh``: about -20 a step; ``scalar``: one log decay per (b, t, h),
    broadcast over K)."""
    B, T, H, K, V, use_u, _, _, kind = case
    gen = torch.Generator(device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v = randn(B, T, H, K) * 0.5, randn(B, T, H, K) * 0.5, randn(B, T, H, V) * 0.5
    shift = {"strong": -1.5, "harsh": -3.0}.get(kind, 1.5)
    g = -torch.exp(randn(B, T, H, 1 if kind == "scalar" else K) - shift).expand(B, T, H, K)
    s0, u = randn(B, H, K, V) * 0.3, randn(H, K) * 0.5
    return q.to(dtype), k.to(dtype), v.to(dtype), g, s0, (u if use_u else None)


def scan_errors(torch, y, s_fin, want_y, want_s, dt, tol, name, row, held=True, what=""):
    """The scan's y and final state against ``want``: the largest absolute
    error and share of the limit ``atol + rtol * |want|`` of each go into
    ``row``; with ``held``, a share above 1 fails.  fp32 and the state:
    rtol = atol = ``tol``; bf16 y: rtol SSM_BF16_RTOL and an atol of 3e-5
    times the mean |want| of each (b, t, h) row.  Returns the largest
    absolute error held (0 when not held)."""
    worst = 0.0
    for out, got, want in (("y", y.float(), want_y.float()), ("s_fin", s_fin, want_s)):
        err = (got - want).abs()
        if out == "y" and dt == "bfloat16":
            rtol, atol = SSM_BF16_RTOL, 3e-5 * want.abs().mean(dim=-1, keepdim=True)
        else:
            rtol, atol = tol, torch.full_like(want[..., :1], tol)
        share = err / (atol + rtol * want.abs())
        key = f"{out}_{name}"
        row.update({f"max_abs_err_{key}": err.max().item(),
                    f"max_err_share_of_limit_{key}": share.max().item()})
        if held:
            check(row[f"max_err_share_of_limit_{key}"] <= 1.0,
                  f"ssm kernel vs {name}, {out}: {what}: {row}")
            worst = max(worst, row[f"max_abs_err_{key}"])
    return worst


def ssm_check(torch, ssm_ops, ssm_kernel, ssm_ref, device):
    """The scan kernel (through ``ops.ssm_scan``) against the plain chunked
    version, the step recurrence ``ssm_scan_ref`` and ``ssm_scan_blocked``
    (the kernel's own blocking in plain PyTorch) on the card, y and the
    final state.

    The limit is ``atol + rtol * |want|``.  fp32: rtol = atol = SSM_TOL, the
    reference's own (the step form and the chunked form add their fp32 terms
    in other orders).  bf16 (same bf16 inputs, fp32 inside): y has rtol
    SSM_BF16_RTOL for the two roundings to bf16, and an atol of 3e-5 times
    the mean |want| of each (b, t, h) row for the fp32 order of sums, which
    scales with the row's outputs; the fp32 state keeps 3e-5.  The served
    shapes are checked with no initial state, as prefill calls them; the
    others with one.  Under the ``harsh`` decay (about -20 a step) the
    plain chunked version's cumulative log decay reaches about -1000 in a
    chunk, and its fp32 rounding puts that version itself 2.8e-4 from the
    step recurrence (on the CPU, at the harsh K 64 case), beyond SSM_TOL: its
    distance is recorded there but the kernel is held to ``ssm_scan_ref``
    and ``ssm_scan_blocked``."""
    rows, worst = [], 0.0
    cases = [(c, "float32") for c in SSM_SMALL_CASES]
    cases += [(c, dt) for c in SSM_EDGE_CASES + SSM_WIDE_CASES + SSM_MAIN_CASES
              for dt in ("float32", "bfloat16")]
    for i, (case, dt) in enumerate(cases):
        q, k, v, g, s0, u = ssm_inputs(case, getattr(torch, dt), 200 + i, device, torch)
        if case in SSM_MAIN_CASES:
            s0 = None
        chunk, sub, kind = case[6:]
        before = ssm_kernel.launches
        # a scalar decay goes in as mamba's (B, T, H, 1), broadcast over K
        y, s_fin = ssm_ops.ssm_scan(q, k, v, g[..., :1] if kind == "scalar" else g, u, s0,
                                    chunk=chunk, subchunk=sub)
        torch.cuda.synchronize()
        check(ssm_kernel.launches == before + 1, f"ssm case {case}: the kernel did not launch")
        check(y.dtype == q.dtype and s_fin.dtype == torch.float32, f"ssm case {case}: dtypes")
        row = {"case": list(case), "dtype": dt}
        for name, (want_y, want_s) in (
                ("plain", ssm_ref.ssm_scan_chunked(q, k, v, g, u, s0, chunk=chunk,
                                                    subchunk=sub)),
                ("ssm_scan_ref", ssm_ref.ssm_scan_ref(q, k, v, g, u, s0)),
                ("blocked", ssm_ref.ssm_scan_blocked(q, k, v, g, u, s0))):
            # under the harsh decay the plain form is off itself: recorded, not held
            err = scan_errors(torch, y, s_fin, want_y, want_s, dt, SSM_TOL[kind], name, row,
                              held=not (kind == "harsh" and name == "plain"),
                              what=f"case {case} {dt}")
            worst = max(worst, err)
        rows.append(row)
        del q, k, v, g, s0, u, y, s_fin
    emit({"phase": "ssm_check", "ok": True, "cases": rows})
    return worst


def ssm_work(B, T, H, K, V, elem_bytes, layout="rwkv"):
    """(bytes, flops) the scan must move and do at prefill: q, k, v read and y
    written in ``elem_bytes``, g read in fp32, u read, the final state written
    in fp32; the step form's two multiply-adds per (t, k, v), 4 K V
    operations per (token, head).  ``layout="mamba"``: q and k are one row
    per (b, t) for every head, g one value per (b, t, h), and no u."""
    if layout == "mamba":
        nbytes = (elem_bytes * B * T * (2 * K + 2 * H * V) + 4 * B * T * H
                  + 4 * B * H * K * V)
    else:
        nbytes = (elem_bytes * B * T * H * (2 * K + 2 * V) + 4 * B * T * H * K
                  + 4 * H * K + 4 * B * H * K * V)
    return nbytes, 4 * K * V * B * T * H


def mamba_scan_inputs(torch, B, T, H, K, V, dtype, seed, device):
    """mamba's scan operands: q and k, (B, T, K) rows expanded over the
    heads (views), v, and g of one log decay per (b, t, h), (B, T, H, 1),
    drawn as the layer's are about: dt about 0.01, A from 1 to 16."""
    gen = torch.Generator(device).manual_seed(seed)
    c, b = (torch.randn((B, T, K), generator=gen, device=device).to(dtype) for _ in range(2))
    v = (torch.randn((B, T, H, V), generator=gen, device=device) * 0.01).to(dtype)
    a = torch.linspace(1.0, 16.0, H, device=device)
    g = (-a * 0.01 * torch.exp(torch.randn((B, T, H), generator=gen, device=device) * 0.5))
    return (c[:, :, None].expand(B, T, H, K), b[:, :, None].expand(B, T, H, K), v,
            g[..., None])


def ssm_times(torch, ssm_kernel, ssm_ref, device, plain=True, cases=SSM_MAIN_CASES):
    """Kernel / plain times and the bound at the served shapes, in bf16 as
    served: CUDA-event time over a loop of calls (``ms``) and the device
    time per launch of the kernel's records under torch.profiler over
    PROFILED_CALLS calls (``device_ms``), which a loop of events bound by
    the enqueue would not show (the mean over the records it keeps, at least
    half of them).  The bound is the larger of the bytes' and
    the step form's operations' times, both reported.  No single PyTorch
    call computes this recurrence, so there is no library time.  Without
    ``plain`` the plain version is not timed.  ``cases`` of kind "mamba"
    take mamba's layout (``mamba_scan_inputs``), in place, and the plain
    form's scalar-decay path."""
    out = []
    for i, case in enumerate(cases):
        B, T, H, K, V, _, chunk, sub, kind = case
        layout = "mamba" if kind == "mamba" else "rwkv"
        if layout == "mamba":
            q, k, v, g = mamba_scan_inputs(torch, B, T, H, K, V, torch.bfloat16, 310 + i, device)
            u = None
        else:
            q, k, v, g, _, u = ssm_inputs(case, torch.bfloat16, 300 + i, device, torch)
        nbytes, flops = ssm_work(B, T, H, K, V, elem_bytes=2, layout=layout)
        t_mem, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
        call = lambda: ssm_kernel.ssm_scan_fwd(q, k, v, g, u, None)
        ms = time_ms(call, torch)
        # the mean over the launches the profiler recorded: at mamba's shapes it
        # kept 18 of 20 records in five runs of one call (H100, torch 2.11)
        kernels, records, _, _, _ = profile_device(
            torch, lambda: [call() for _ in range(PROFILED_CALLS)],
            complete=lambda counts: bool(counts) and all("ssm_scan_kernel" in n for n in counts)
            and sum(counts.values()) >= PROFILED_CALLS // 2)
        device_ms = sum(kernels.values()) / records
        bound = max(t_mem, t_ops)
        out.append({"B": B, "T": T, "H": H, "K": K, "V": V, "dtype": "bfloat16",
                    "layout": layout, "bytes": nbytes, "flops": flops, "ms": ms,
                    "kernel_ms": ms, "device_ms": device_ms, "profiled_records": records,
                    "plain_ms": time_ms(lambda: ssm_ref.ssm_scan_chunked(
                        q, k, v, g, u, None, chunk=chunk, subchunk=sub,
                        scalar_decay=layout == "mamba"), torch, min_s=0.5)
                    if plain else None,
                    "bound_ms": bound, "bound_by": "bytes" if t_mem >= t_ops else "operations",
                    "bytes_ms": t_mem, "operations_ms": t_ops, "library_ms": None,
                    "share_of_bound": bound / ms, "device_share_of_bound": bound / device_ms})
        del q, k, v, g, u
    emit({"phase": "ssm_times", "rows": out})
    return out


def profile_device(torch, fn, spans=(), complete=None):
    """torch.profiler over one call of ``fn``: ({kernel name: device ms},
    kernel launches, {span: device ms}, {span: device ms as key_averages
    books it}, {span: kernel ms inside it}) for the record_function ranges
    named in ``spans``, which are kept out of the kernels.  A span's device
    ms is its extent on the device's timeline, idle gaps included; the
    kernel ms inside it sums the kernels that start within that extent
    (one stream), its busy time.  The device's busy time is the sum of the
    kernels'.  The profiler can drop kernel records of a run; with
    ``complete``, a predicate on {kernel name: records}, the run is repeated
    until the records pass it, PROFILE_TRIES times at most."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        kernels, counts, span_ms = {}, {}, {r: 0.0 for r in spans}
        extents, starts = {r: [] for r in spans}, []
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                ms = ev.time_range.elapsed_us() / 1e3
                if ev.name in span_ms:
                    span_ms[ev.name] += ms
                    extents[ev.name].append((ev.time_range.start, ev.time_range.end))
                else:
                    kernels[ev.name] = kernels.get(ev.name, 0.0) + ms
                    counts[ev.name] = counts.get(ev.name, 0) + 1
                    starts.append((ev.time_range.start, ms))
        if complete is None or complete(counts):
            break
    else:
        raise SmokeFailure(f"torch.profiler missed kernel records in {PROFILE_TRIES} runs: "
                           f"{counts}")
    cpu_side = {avg.key: getattr(avg, "device_time_total",
                                 getattr(avg, "cuda_time_total", 0.0)) / 1e3
                for avg in prof.key_averages() if avg.key in span_ms}
    busy_in = {r: sum(ms for at, ms in starts if any(a <= at < b for a, b in extents[r]))
               for r in spans}
    return kernels, sum(counts.values()), span_ms, cpu_side, busy_in


def wall_ms(torch, fn, reps):
    """Host wall ms of each of ``reps`` calls, each ended by a synchronise."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


@contextlib.contextmanager
def plain_scan(ssm_ops, ssm_ref):
    """The plain chunked scan in place of ``ops.ssm_scan`` for the block, as
    a test's monkeypatch would swap it in."""
    def scan(q, k, v, log_decay, u=None, initial_state=None, *, chunk, subchunk, io_dtype,
             shard_constrain, scalar_decay=False):
        return ssm_ref.ssm_scan_chunked(q, k, v, log_decay, u=u, initial_state=initial_state,
                                        chunk=chunk, subchunk=min(subchunk, chunk),
                                        scalar_decay=scalar_decay, io_dtype=io_dtype,
                                        shard_constrain=shard_constrain)

    kernel_scan, ssm_ops.ssm_scan = ssm_ops.ssm_scan, scan
    try:
        yield
    finally:
        ssm_ops.ssm_scan = kernel_scan


def serve_rwkv(torch, serve, build, kernels, ssm_ops, ssm_ref, device):
    """The rwkv6 serving path: full-width, full-depth rwkv6-7b through
    repro_torch.launch.serve, its scan on the kernel; one profiled prefill
    and decode step; then the same prefill in fp32 compute (the same bf16
    weights) through the kernel, through the plain chunked scan swapped in
    (as a test's monkeypatch would), and through the kernel with the
    reference's ``ssm_bf16_io`` (q, k, v rounded to bf16 at the scan), and
    the bf16 prefill through the plain scan.

    In fp32 the kernel path must give the plain path's greedy first token on
    every request and logits within FP32_LOGIT_LIMIT of it; the bf16-input
    scan must land beyond that limit, so the limit tells a scan that loses
    precision from a sound one.  In bf16 the logits must be within
    LOGIT_SLACK of the plain bf16 prefill's error against fp32; the bf16
    first tokens are printed, not compared: two sound bf16 paths differ by
    bf16 noise through 32 random-weight layers, more than some requests'
    top-2 margins."""
    from repro_torch.models.convert import flatten
    from repro_torch.runtime.steps import make_serve_step
    fa_kernel, cs_kernel, ssm_kernel = kernels
    results, launches = [], 0
    for B, S, gen_len in RWKV_WORKLOADS:
        args = serve.parse_args(["--arch", RWKV_ARCH, "--no-scaled-down", "--requests", str(B),
                                 "--prompt-len", str(S), "--gen-len", str(gen_len),
                                 "--device", str(device), "--seed", "0"])
        api, params, tokens = serve.setup(args)
        cfg = api.cfg
        check(cfg == serve.get_config(RWKV_ARCH), f"not the full-width config: {cfg}")
        n_params = sum(t.numel() for t in flatten(params).values())
        serve.serve(api, params, tokens, 2)  # warm-up: first-call set-up is not timed
        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        res = serve.serve(api, params, tokens, gen_len)
        n = ssm_kernel.launches
        launches += n
        fa_counts = flash_counts(fa_kernel)
        check(n == cfg.n_layers, f"{n} scan launches in one prefill and {gen_len - 1} decode "
                                 f"steps, want {cfg.n_layers} (one per layer, none in decode)")
        check(fa_counts == (0, 0, 0, 0) and cs_kernel.launches == 0,
              f"rwkv serving launched flash {fa_counts} (all, TMA, mma.sync, fp32) / checksum "
              f"{cs_kernel.launches} times")
        logits = res["logits"]
        check(tuple(logits.shape) == (B, 1, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        toks = res["tokens"]
        check(tuple(toks.shape) == (B, gen_len) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, f"generated tokens {tuple(toks.shape)}")
        peak_mem = torch.cuda.max_memory_allocated(device)

        # one prefill and one decode step: launches, wall time, device busy time
        step = make_serve_step(api)

        def prefill():
            return api.prefill(params, {"tokens": tokens})

        with torch.inference_mode():
            ssm_kernel.launches = 0
            lg, cache, _ = prefill()
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            n_pre = ssm_kernel.launches
            step(params, cache, tok, S)
            n_dec = ssm_kernel.launches - n_pre
            check(n_pre == cfg.n_layers and n_dec == 0,
                  f"scan launches: {n_pre} in a prefill, {n_dec} in a decode step")
            pre_wall = statistics.median(wall_ms(torch, prefill, 3))
            by_name, pre_n, _, _, _ = profile_device(
                torch, prefill, complete=lambda counts: sum(
                    c for name, c in counts.items() if "ssm_scan_kernel" in name) == cfg.n_layers)
            pre_busy = sum(by_name.values())
            pre_ssm = sum(ms for name, ms in by_name.items() if "ssm_scan_kernel" in name)
            dec_wall = statistics.median(wall_ms(torch, lambda: step(params, cache, tok, S), 8))
            by_name, dec_n, _, _, _ = profile_device(torch, lambda: step(params, cache, tok, S))
            dec_busy = sum(by_name.values())
            del lg, cache

        # the same prefill in fp32 compute through the kernel (also with the
        # scan's inputs rounded to bf16), then through the plain scan in bf16
        # and in fp32
        exact = build(dataclasses.replace(cfg, compute_dtype="float32"), device)
        bf16_io = build(dataclasses.replace(cfg, compute_dtype="float32", ssm_bf16_io=True),
                        device)
        ssm_kernel.launches = 0
        with torch.inference_mode():
            logits_exact_kernel, _, _ = exact.prefill(params, {"tokens": tokens})
            logits_bf16_io, _, _ = bf16_io.prefill(params, {"tokens": tokens})
        check(ssm_kernel.launches == 2 * cfg.n_layers,
              f"{ssm_kernel.launches} scan launches in two fp32 prefills")
        ssm_kernel.launches = 0
        with plain_scan(ssm_ops, ssm_ref), torch.inference_mode():
            logits_plain, _, _ = api.prefill(params, {"tokens": tokens})
            logits_exact, _, _ = exact.prefill(params, {"tokens": tokens})
        check(ssm_kernel.launches == 0, "the plain-scan prefill launched the kernel")
        diff = (logits - logits_plain).abs().max().item()
        err = (logits - logits_exact).abs().max().item()
        err_plain = (logits_plain - logits_exact).abs().max().item()
        diff32 = (logits_exact_kernel - logits_exact).abs().max().item()
        diff_bf16_io = (logits_bf16_io - logits_exact).abs().max().item()
        first, first_plain = logits[:, -1].argmax(-1), logits_plain[:, -1].argmax(-1)
        first32, first32_plain = (logits_exact_kernel[:, -1].argmax(-1),
                                  logits_exact[:, -1].argmax(-1))
        top2_32 = logits_exact[:, -1].topk(2, dim=-1).values
        row = {"arch": RWKV_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "heads": cfg.d_model // cfg.ssm.head_dim, "head_dim": cfg.ssm.head_dim,
               "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": n_params,
               "requests": B, "prompt_len": S, "gen_len": gen_len,
               "kernel_launches": n, "flash_mma_sync_launches": fa_counts[2],
               "kernel_launches_per_prefill": n_pre,
               "kernel_launches_per_decode_step": n_dec,
               "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
               "prefill_tok_s": res["prefill_tok_s"], "decode_tok_s": res["decode_tok_s"],
               "max_memory_allocated": peak_mem,
               "prefill_profile": {"wall_ms_unprofiled": pre_wall, "device_busy_ms": pre_busy,
                                   "idle_share": 1.0 - pre_busy / pre_wall, "kernels": pre_n,
                                   "ssm_kernel_ms": pre_ssm,
                                   "ssm_kernel_share_of_busy": pre_ssm / pre_busy},
               "decode_step_profile": {"wall_ms_unprofiled": dec_wall,
                                       "device_busy_ms": dec_busy,
                                       "idle_share": 1.0 - dec_busy / dec_wall,
                                       "kernels": dec_n},
               "fp32_max_abs_logit_diff_kernel_vs_plain": diff32,
               "fp32_logit_limit": FP32_LOGIT_LIMIT,
               "fp32_share_of_limit": diff32 / FP32_LOGIT_LIMIT,
               "fp32_bf16_io_max_abs_logit_diff_vs_plain": diff_bf16_io,
               "fp32_first_tokens": first32.tolist(),
               "fp32_first_tokens_plain": first32_plain.tolist(),
               "fp32_top2_margin_plain": (top2_32[:, 0] - top2_32[:, 1]).tolist(),
               "max_abs_logit_diff_vs_plain": diff,
               "max_abs_logit_err_vs_fp32": err,
               "plain_max_abs_logit_err_vs_fp32": err_plain,
               "logit_err_ratio": err / err_plain,
               "bf16_first_tokens": first.tolist(),
               "bf16_first_tokens_plain": first_plain.tolist(),
               "sample_tokens": toks[0, :8].tolist()}
        emit({"phase": "serve_rwkv", **row})
        check(bool((first32 == first32_plain).all()),
              f"fp32 greedy first tokens {first32.tolist()}, plain {first32_plain.tolist()}")
        check(diff32 <= FP32_LOGIT_LIMIT,
              f"fp32 logits {diff32} from the plain scan's, limit {FP32_LOGIT_LIMIT}")
        check(diff_bf16_io > FP32_LOGIT_LIMIT,
              f"the bf16-input scan's fp32 logits are {diff_bf16_io} from the plain "
              f"scan's, within the limit {FP32_LOGIT_LIMIT}: the limit tells nothing apart")
        check(err <= LOGIT_SLACK * err_plain,
              f"logits {err} from the fp32 prefill; the plain bf16 one is {err_plain}")
        results.append(row)
        del api, params, tokens, res, logits, logits_plain, logits_exact, exact, bf16_io
        del logits_exact_kernel, logits_bf16_io
        torch.cuda.empty_cache()
    return results, launches


@contextlib.contextmanager
def routing_recorder(tf, moe):
    """Records, in call order, the experts each MoE layer of the block routes
    each token to (the sorted top-k indices of the router's fp32 softmax),
    by wrapping the model's ``moe_apply``."""
    calls = []

    def apply(p, x, cfg):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"]["w"].float()
        calls.append(logits.softmax(-1).topk(cfg.moe.top_k, dim=-1).indices.sort(-1).values)
        return moe.moe_apply(p, x, cfg)

    kernel_apply, tf.moe_apply = tf.moe_apply, apply
    try:
        yield calls
    finally:
        tf.moe_apply = kernel_apply


def routing_diff(a, b):
    """(token-layer routing decisions whose expert sets differ, decisions)."""
    return (sum(int((x != y).any(-1).sum()) for x, y in zip(a, b)),
            sum(x.shape[0] for x in a))


@contextlib.contextmanager
def bf16_attention_inputs(layers):
    """The attention kernel fed q, k, v rounded to bf16, for the block: what
    an attention kernel that loses fp32 precision on its inputs gives."""
    kernel_attention = layers.flash_attention_auto
    layers.flash_attention_auto = lambda q, k, v, **kw: kernel_attention(
        *(t.bfloat16().to(t.dtype) for t in (q, k, v)), **kw)
    try:
        yield
    finally:
        layers.flash_attention_auto = kernel_attention


def serve_moe(torch, serve, build, kernels, device):
    """The MoE serving path: full-width, full-depth granite-moe-1b-a400m
    through repro_torch.launch.serve, attention on the flash kernel (TMA
    path), the experts as batched products; one profiled prefill.  Then the
    same prefill in fp32 compute (the same bf16 weights) through the kernel
    (flash's fp32 path), through plain attention, and through the kernel
    fed bf16-rounded q, k, v; and the bf16 prefill through plain attention.

    In fp32 the kernel path must give the plain path's greedy first token on
    every request and logits within MOE_FP32_LOGIT_LIMIT of it, and the
    bf16-input kernel must land beyond that limit.  In bf16 nothing is held
    to the plain path: top-k routing turns bf16 noise into other experts, so
    the largest logit error against fp32 and the count of routing decisions
    that differ from the plain run are printed."""
    from repro_torch.models import layers, moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.convert import flatten
    fa_kernel, cs_kernel, ssm_kernel = kernels
    results, launches, sync = [], 0, 0
    for B, S, gen_len in MOE_WORKLOADS:
        args = serve.parse_args(["--arch", MOE_ARCH, "--no-scaled-down", "--requests", str(B),
                                 "--prompt-len", str(S), "--gen-len", str(gen_len),
                                 "--device", str(device), "--seed", "0"])
        api, params, tokens = serve.setup(args)
        cfg = api.cfg
        check(cfg == serve.get_config(MOE_ARCH), f"not the full-width config: {cfg}")
        leaves = flatten(params).values()
        n_params = sum(t.numel() for t in leaves)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        serve.serve(api, params, tokens, 2)  # warm-up: first-call set-up is not timed
        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        res = serve.serve(api, params, tokens, gen_len)
        n, n_tma, n_sync, n_f32 = flash_counts(fa_kernel)
        launches, sync = launches + n, sync + n_sync
        check(n == cfg.n_layers, f"{n} flash launches in one prefill, want {cfg.n_layers}")
        check(n_tma == n, f"MoE serving took the mma.sync path {n_sync} / the fp32 path "
                          f"{n_f32} times")
        check(cs_kernel.launches == 0 and ssm_kernel.launches == 0,
              f"MoE serving launched checksum {cs_kernel.launches} / scan "
              f"{ssm_kernel.launches} times")
        logits, toks = res["logits"], res["tokens"]
        check(tuple(logits.shape) == (B, 1, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        check(tuple(toks.shape) == (B, gen_len) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, f"generated tokens {tuple(toks.shape)}")
        peak_mem = torch.cuda.max_memory_allocated(device)

        def prefill():
            return api.prefill(params, {"tokens": tokens})

        with torch.inference_mode():
            reset_flash_counts(fa_kernel)
            pre_wall = statistics.median(wall_ms(torch, prefill, 3))
            pre_all, pre_tma, pre_sync, _ = flash_counts(fa_kernel)  # 3 prefills
            by_name, pre_n, _, _, _ = profile_device(
                torch, prefill, complete=lambda counts: sum(
                    c for name, c in counts.items() if "attn_fwd_bf16_tma" in name) == cfg.n_layers)
        check(pre_all == pre_tma == 3 * cfg.n_layers and pre_sync == 0,
              f"3 prefills: {pre_all} launches, {pre_tma} TMA and {pre_sync} mma.sync")
        sync += pre_sync
        pre_busy = sum(by_name.values())
        pre_fa = sum(ms for name, ms in by_name.items() if "attn_fwd_bf16_tma" in name)
        check(pre_fa > 0, "the profiled prefill shows no attn_fwd_bf16_tma kernel")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

        plain = build(dataclasses.replace(cfg, attn_impl="full"), device)
        exact = build(dataclasses.replace(cfg, compute_dtype="float32"), device)
        exact_plain = build(dataclasses.replace(cfg, attn_impl="full", compute_dtype="float32"),
                            device)
        before = flash_counts(fa_kernel)
        batch = {"tokens": tokens}
        with torch.inference_mode():
            with routing_recorder(tf, moe) as r_k:
                lg_k, _, _ = api.prefill(params, batch)
            with routing_recorder(tf, moe) as r_p:
                lg_p, _, _ = plain.prefill(params, batch)
            with routing_recorder(tf, moe) as r32_k:
                lg32_k, _, _ = exact.prefill(params, batch)
            with routing_recorder(tf, moe) as r32_p:
                lg32_p, _, _ = exact_plain.prefill(params, batch)
            with bf16_attention_inputs(layers):
                lg32_bf16_in, _, _ = exact.prefill(params, batch)
        took = tuple(a - b for a, b in zip(flash_counts(fa_kernel), before))
        check(took == (3 * cfg.n_layers, cfg.n_layers, 0, 2 * cfg.n_layers),
              f"flash launches (all, TMA, mma.sync, fp32) {took} in a bf16 and two fp32 kernel "
              "prefills and two plain ones")
        diff32 = (lg32_k - lg32_p).abs().max().item()
        diff_bf16_in = (lg32_bf16_in - lg32_p).abs().max().item()
        err = (lg_k - lg32_p).abs().max().item()
        err_plain = (lg_p - lg32_p).abs().max().item()
        first32, first32_plain = lg32_k[:, -1].argmax(-1), lg32_p[:, -1].argmax(-1)
        top2_32 = lg32_p[:, -1].topk(2, dim=-1).values
        flips, decisions = routing_diff(r_k, r_p)
        flips32, _ = routing_diff(r32_k, r32_p)
        row = {"arch": MOE_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
               "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k, "d_ff": cfg.d_ff,
               "vocab": cfg.vocab_size, "params": n_params, "param_bytes": n_bytes,
               "requests": B, "prompt_len": S, "gen_len": gen_len,
               "kernel_launches": n, "flash_mma_sync_launches": n_sync + pre_sync,
               "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
               "prefill_tok_s": res["prefill_tok_s"], "decode_tok_s": res["decode_tok_s"],
               "max_memory_allocated": peak_mem,
               "prefill_profile": {"wall_ms_unprofiled": pre_wall, "device_busy_ms": pre_busy,
                                   "idle_share": 1.0 - pre_busy / pre_wall, "kernels": pre_n,
                                   "flash_kernel_ms": pre_fa,
                                   "flash_kernel_share_of_busy": pre_fa / pre_busy,
                                   "flash_tma_launches": pre_tma // 3,
                                   "top_kernels_ms": {k[:80]: v for k, v in top}},
               "fp32_max_abs_logit_diff_kernel_vs_plain": diff32,
               "fp32_logit_limit": MOE_FP32_LOGIT_LIMIT,
               "fp32_share_of_limit": diff32 / MOE_FP32_LOGIT_LIMIT,
               "fp32_bf16_inputs_max_abs_logit_diff_vs_plain": diff_bf16_in,
               "fp32_first_tokens": first32.tolist(),
               "fp32_first_tokens_plain": first32_plain.tolist(),
               "fp32_top2_margin_plain": (top2_32[:, 0] - top2_32[:, 1]).tolist(),
               "fp32_routing_decisions_differing": flips32,
               "routing_decisions": decisions,
               "bf16_routing_decisions_differing": flips,
               "max_abs_logit_err_vs_fp32": err,
               "plain_max_abs_logit_err_vs_fp32": err_plain,
               "bf16_first_tokens": lg_k[:, -1].argmax(-1).tolist(),
               "bf16_first_tokens_plain": lg_p[:, -1].argmax(-1).tolist(),
               "sample_tokens": toks[0, :8].tolist()}
        emit({"phase": "serve_moe", **row})
        check(bool(torch.isfinite(lg32_k).all()), "non-finite fp32 logits")
        check(bool((first32 == first32_plain).all()),
              f"fp32 greedy first tokens {first32.tolist()}, plain {first32_plain.tolist()}")
        check(diff32 <= MOE_FP32_LOGIT_LIMIT,
              f"fp32 logits {diff32} from plain attention's, limit {MOE_FP32_LOGIT_LIMIT}")
        check(diff_bf16_in > MOE_FP32_LOGIT_LIMIT,
              f"the bf16-input kernel's fp32 logits are {diff_bf16_in} from plain attention's, "
              f"within the limit {MOE_FP32_LOGIT_LIMIT}: the limit tells nothing apart")
        results.append(row)
        del api, params, tokens, res, logits, plain, exact, exact_plain, lg_k, lg_p, lg32_k
        del lg32_p, lg32_bf16_in, r_k, r_p, r32_k, r32_p
        torch.cuda.empty_cache()
    return results, launches, sync


@contextlib.contextmanager
def capture_scan(ssm_ops):
    """Records (args, kwargs, result) of every ``ops.ssm_scan`` call in the
    block; the calls still run the op."""
    calls = []

    def scan(*args, **kw):
        out = kernel_scan(*args, **kw)
        calls.append((args, kw, out))
        return out

    kernel_scan, ssm_ops.ssm_scan = ssm_ops.ssm_scan, scan
    try:
        yield calls
    finally:
        ssm_ops.ssm_scan = kernel_scan


def growth_bytes(torch, device, fn):
    """(peak device bytes allocated during ``fn()`` above what was allocated
    before it, fn's result)."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - base, out


def mamba_scan_errors(torch, ssm_ref, q, k, v, g, y, s_fin, dt, chunks, row, what):
    """The mamba layer's scan (y, s_fin from the kernel) against the step
    recurrence and the plain scalar-decay chunked form at chunk 128 /
    subchunk 16, both held at the SSM_TOL (fp32) / SSM_BF16_RTOL (bf16)
    limits; and against the plain form at the layer's own chunks (512 /
    128), recorded, not held: there the cumulative log decay of a chunk
    reaches about -80, and the plain form's fp32 differences of it leave
    that form itself further from the step recurrence than the kernel is
    (against it alone the kernel's bf16 y exceeded the limit at B1 T5120
    on an H100, share 1.19, where it read 0.50 against the other two)."""
    worst, tag = 0.0, "" if dt == "bfloat16" else "_fp32"
    for name, held, fn in (
            ("ssm_scan_ref", True, lambda: ssm_ref.ssm_scan_ref(q, k, v, g.expand(q.shape))),
            ("plain", True, lambda: ssm_ref.ssm_scan_chunked(
                q, k, v, g, chunk=128, subchunk=16, scalar_decay=True)),
            ("plain_layer_chunks", False, lambda: ssm_ref.ssm_scan_chunked(q, k, v, g, **chunks))):
        want_y, want_s = fn()
        worst = max(worst, scan_errors(torch, y, s_fin, want_y, want_s, dt, SSM_TOL["random"],
                                       name + tag, row, held=held, what=f"{what} {dt}"))
        del want_y, want_s
    return worst


def mamba_layer(torch, kernels, ssm_ops, ssm_ref, device):
    """One jamba mamba mixer at full width (random bf16 weights from a seed)
    at each of MAMBA_SHAPES: a prefill through ``mamba_apply`` (one scan
    launch), then MAMBA_DECODE_STEPS steps through ``mamba_decode`` (none).
    Its scan, as the layer called it, is held to the step recurrence and
    the plain scalar-decay chunked form on the same operands
    (``mamba_scan_errors``): bf16 as the layer runs, and fp32 (the same
    layer on an fp32 input) at SSM_TOL; bit for bit to the kernel
    on contiguous copies of q, k and the expanded g; and the op's call may
    grow device memory by y and the state only (ALLOC_SLACK each).  One
    decode step after the fp32 prefill must give the last position of an
    fp32 prefill one token longer.  A profiled prefill gives the scan's
    share of the layer's device time; the copying call's extra memory and
    time are printed, not claimed."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.convert import flatten
    fa_kernel, cs_kernel, ssm_kernel = kernels
    cfg = get_config(HYBRID_ARCH)
    d_inner, H = tf._mamba_dims(cfg)
    K, V = cfg.ssm.d_state, cfg.ssm.head_dim
    gen = torch.Generator(device).manual_seed(0)
    p = tf.mamba_init(gen, cfg, torch.bfloat16)
    leaves = flatten(p).values()
    head = {"arch": HYBRID_ARCH, "d_model": cfg.d_model, "d_inner": d_inner, "heads": H,
            "d_state": K, "head_dim": V, "d_conv": cfg.ssm.d_conv, "chunk": cfg.ssm.chunk,
            "subchunk": cfg.ssm.subchunk, "params": sum(t.numel() for t in leaves),
            "param_bytes": sum(t.numel() * t.element_size() for t in leaves)}
    rows, launches, worst = [], 0, 0.0
    for B, T in MAMBA_SHAPES:
        x = torch.randn((B, T, cfg.d_model), generator=gen, device=device).bfloat16()
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        with torch.inference_mode(), capture_scan(ssm_ops) as calls:
            out, state = tf.mamba_apply(p, x, cfg)
            torch.cuda.synchronize()
            n_pre = ssm_kernel.launches
            for _ in range(MAMBA_DECODE_STEPS):
                xt = torch.randn((B, 1, cfg.d_model), generator=gen, device=device).bfloat16()
                o, state = tf.mamba_decode(p, xt, cfg, state)
            torch.cuda.synchronize()
        n_dec = ssm_kernel.launches - n_pre
        launches += ssm_kernel.launches
        check(n_pre == 1 and n_dec == 0 and len(calls) == 1,
              f"scan launches: {n_pre} in a prefill, {n_dec} in {MAMBA_DECODE_STEPS} decode steps")
        check(flash_counts(fa_kernel) == (0, 0, 0, 0) and cs_kernel.launches == 0,
              "the mamba layer launched flash or checksum")
        check(bool(torch.isfinite(out).all() and torch.isfinite(o).all()
                   and torch.isfinite(state[0]).all()), "non-finite mamba layer outputs")
        (q, k, v, g), kw, (y, s_fin) = calls[0][0][:4], calls[0][1], calls[0][2]
        check(q.stride(2) == 0 and k.stride(2) == 0 and tuple(g.shape) == (B, T, H, 1)
              and kw["scalar_decay"], f"the scan's operands: q {q.stride()}, k {k.stride()}, "
                                      f"g {tuple(g.shape)}, {kw}")
        row = {**head, "B": B, "T": T, "scan_launches_per_prefill": n_pre,
               "scan_launches_per_decode_step": n_dec / MAMBA_DECODE_STEPS}
        chunks = dict(chunk=kw["chunk"], subchunk=kw["subchunk"], scalar_decay=True)
        with torch.inference_mode():
            worst = max(worst, mamba_scan_errors(torch, ssm_ref, q, k, v, g, y, s_fin,
                                                 "bfloat16", chunks, row, f"mamba B{B} T{T}"))
            # bit for bit what the kernel gives on contiguous copies
            y_c, s_c = ssm_kernel.ssm_scan_fwd(q.contiguous(), k.contiguous(), v,
                                               g.expand(B, T, H, K).contiguous())
            check(torch.equal(y_c, y) and torch.equal(s_c, s_fin),
                  f"mamba B{B} T{T}: the copy-free call differs from the copying one")
            del y_c, s_c
            # device memory: the op's call against the copying call's
            free, _ = growth_bytes(torch, device, lambda: ssm_ops.ssm_scan(q, k, v, g, **chunks))
            copying, _ = growth_bytes(torch, device, lambda: ssm_kernel.ssm_scan_fwd(
                q.contiguous(), k.contiguous(), v, g.expand(B, T, H, K).contiguous()))
            limit = y.numel() * y.element_size() + s_fin.numel() * 4 + 2 * ALLOC_SLACK
            row["memory"] = {"copy_free_growth_bytes": free, "limit_bytes": limit,
                             "copying_growth_bytes": copying,
                             "copying_extra_bytes": copying - free}
            check(free <= limit, f"mamba B{B} T{T}: the scan grew device memory by {free} bytes, "
                                 f"more than y and the state ({limit})")
            row["call_ms"] = {"copy_free": time_ms(lambda: ssm_kernel.ssm_scan_fwd(q, k, v, g),
                                                   torch),
                              "copying": time_ms(lambda: ssm_kernel.ssm_scan_fwd(
                                  q.contiguous(), k.contiguous(), v,
                                  g.expand(B, T, H, K).contiguous()), torch)}

            # fp32: the same layer on the fp32 input, its scan at SSM_TOL
            x32 = x.float()
            with capture_scan(ssm_ops) as calls32:
                out32, (s32, conv32) = tf.mamba_apply(p, x32, cfg)
            (q, k, v, g), _, (y, s_fin) = calls32[0][0][:4], calls32[0][1], calls32[0][2]
            worst = max(worst, mamba_scan_errors(torch, ssm_ref, q, k, v, g, y, s_fin,
                                                 "float32", chunks, row, f"mamba B{B} T{T}"))
            del calls32
            # one decode step carries the prefill's ssm and conv state on
            xt = torch.randn((B, 1, cfg.d_model), generator=gen, device=device)
            o_dec, _ = tf.mamba_decode(p, xt, cfg, (s32, conv32))
            o_ext, _ = tf.mamba_apply(p, torch.cat([x32, xt], dim=1), cfg)
            dec_err = (o_dec[:, 0] - o_ext[:, -1]).abs().max().item()
            dec_scale = o_ext[:, -1].abs().max().item()
            row["fp32_decode_vs_longer_prefill"] = {"max_abs_diff": dec_err, "max_abs": dec_scale}
            check(dec_err <= 1e-3 * dec_scale, f"mamba B{B} T{T}: a decode step after the "
                                               f"prefill is {dec_err} from a longer prefill's "
                                               f"last position (max |out| {dec_scale})")
            del x32, out32, s32, conv32, o_dec, o_ext, q, k, v, g, y, s_fin, calls

            # the layer's prefill: wall time, device busy time, the scan's share
            layer = lambda: tf.mamba_apply(p, x, cfg)
            wall = statistics.median(wall_ms(torch, layer, 3))
            by_name, n_kernels, _, _, _ = profile_device(
                torch, layer, complete=lambda counts: sum(
                    c for n, c in counts.items() if "ssm_scan_kernel" in n) == 1)
        busy = sum(by_name.values())
        scan_ms = sum(ms for n, ms in by_name.items() if "ssm_scan_kernel" in n)
        row["prefill_profile"] = {"wall_ms_unprofiled": wall, "device_busy_ms": busy,
                                  "idle_share": 1.0 - busy / wall, "kernels": n_kernels,
                                  "scan_kernel_ms": scan_ms,
                                  "scan_kernel_share_of_busy": scan_ms / busy,
                                  "tokens_per_s": B * T / wall * 1e3}
        emit({"phase": "mamba_layer", **row})
        rows.append(row)
        del x, out, state, o
        torch.cuda.empty_cache()
    times = ssm_times(torch, ssm_kernel, ssm_ref, device, cases=MAMBA_MAIN_CASES)
    del p
    torch.cuda.empty_cache()
    return rows, times, launches, worst


def serve_hybrid(torch, serve, build, kernels, ssm_ops, ssm_ref, device):
    """The hybrid serving path: jamba scaled down (fp32) through
    repro_torch.launch.serve, its mamba layers' scan on the scan kernel and
    its attention layers on flash's fp32 path, MoE every second layer.  Then
    the prefill and the decode steps of the served tokens (teacher-forced)
    through the kernels, through plain attention and the plain scan, and
    through the kernels with the scan's inputs rounded to bf16
    (``ssm_bf16_io``): the kernel path's logits within
    HYBRID_FP32_LOGIT_LIMIT of the plain path's at every step and its
    first tokens the same; the bf16-input path beyond the limit."""
    from repro_torch.runtime.steps import make_serve_step
    fa_kernel, cs_kernel, ssm_kernel = kernels
    results, launches = [], {"scan": 0, "flash": 0}
    for B, S, gen_len in HYBRID_WORKLOADS:
        args = serve.parse_args(["--arch", HYBRID_ARCH, "--requests", str(B), "--prompt-len",
                                 str(S), "--gen-len", str(gen_len), "--device", str(device),
                                 "--seed", "0"])
        api, params, tokens = serve.setup(args)
        cfg = api.cfg
        check(cfg == serve.get_config(HYBRID_ARCH).scaled_down(), f"not scaled down: {cfg}")
        kinds = cfg.block_pattern() * cfg.n_blocks
        n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
        serve.serve(api, params, tokens, 2)  # warm-up
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        res = serve.serve(api, params, tokens, gen_len)
        fa = flash_counts(fa_kernel)
        launches["scan"] += ssm_kernel.launches
        launches["flash"] += fa[0]
        check(ssm_kernel.launches == n_mamba, f"{ssm_kernel.launches} scan launches in a prefill "
                                              f"and {gen_len - 1} decode steps, want {n_mamba}")
        check(fa == (n_attn, 0, 0, n_attn), f"flash launches (all, TMA, mma.sync, fp32) {fa}, "
                                            f"want {n_attn} on the fp32 path")
        check(cs_kernel.launches == 0, "hybrid serving launched the checksum kernel")
        toks = res["tokens"]
        check(bool(torch.isfinite(res["logits"]).all()) and tuple(toks.shape) == (B, gen_len),
              f"logits finite, tokens {tuple(toks.shape)}")

        def run(model):
            """Prefill logits, then each decode step's on the served tokens."""
            lg, cache, _ = model.prefill(params, {"tokens": tokens}, pad_to=S + gen_len)
            out, step = [lg], make_serve_step(model, greedy=False)
            for i in range(gen_len - 1):
                lg, cache = step(params, cache, toks[:, i:i + 1], S + i)
                out.append(lg)
            return torch.cat(out, dim=1)

        plain = build(dataclasses.replace(cfg, attn_impl="full"), device)
        bf16_io = build(dataclasses.replace(cfg, ssm_bf16_io=True), device)
        with torch.inference_mode():
            ssm_kernel.launches = 0
            lg_k = run(api)
            lg_b = run(bf16_io)
            check(ssm_kernel.launches == 2 * n_mamba, f"{ssm_kernel.launches} scan launches")
            with plain_scan(ssm_ops, ssm_ref):
                lg_p = run(plain)
            check(ssm_kernel.launches == 2 * n_mamba, "the plain run launched the scan kernel")
        diff = (lg_k - lg_p).abs().amax(dim=(0, 2))  # per position
        diff_b = (lg_b - lg_p).abs().max().item()
        first, first_plain = lg_k[:, 0].argmax(-1), lg_p[:, 0].argmax(-1)
        row = {"arch": HYBRID_ARCH, "scaled_down": True, "n_layers": cfg.n_layers,
               "mamba_layers": n_mamba, "attention_layers": n_attn,
               "moe_layers": sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.attn_every))
               * cfg.n_blocks, "d_model": cfg.d_model, "requests": B, "prompt_len": S,
               "gen_len": gen_len, "scan_launches": n_mamba, "flash_launches": fa[0],
               "prefill_tok_s": res["prefill_tok_s"], "decode_tok_s": res["decode_tok_s"],
               "fp32_max_abs_logit_diff_by_step": diff.tolist(),
               "fp32_logit_limit": HYBRID_FP32_LOGIT_LIMIT,
               "fp32_share_of_limit": diff.max().item() / HYBRID_FP32_LOGIT_LIMIT,
               "fp32_bf16_io_max_abs_logit_diff_vs_plain": diff_b,
               "first_tokens": first.tolist(), "first_tokens_plain": first_plain.tolist(),
               "sample_tokens": toks[0].tolist()}
        emit({"phase": "serve_hybrid", **row})
        check(bool((first == first_plain).all()),
              f"greedy first tokens {first.tolist()}, plain {first_plain.tolist()}")
        check(diff.max().item() <= HYBRID_FP32_LOGIT_LIMIT,
              f"logits {diff.tolist()} from the plain path's, limit {HYBRID_FP32_LOGIT_LIMIT}")
        check(diff_b > HYBRID_FP32_LOGIT_LIMIT,
              f"the bf16-input scan's logits are {diff_b} from the plain path's, within the "
              f"limit {HYBRID_FP32_LOGIT_LIMIT}: the limit tells nothing apart")
        results.append(row)
        del api, params, tokens, res, plain, bf16_io, lg_k, lg_b, lg_p
        torch.cuda.empty_cache()
    return results, launches


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def token_losses(api, params, batch, torch):
    """Per-token xent of the batch (the terms whose mean is the loss), and
    the logsumexp, gold logit and logit variance beside it."""
    from repro_torch.models.transformer import final_hidden
    with torch.no_grad():
        x, _, _ = final_hidden(params, batch, api.cfg)
        logits = (x @ params["lm_head"]["w"].to(x.dtype)).float()
        labels = batch["labels"]
        valid = labels >= 0
        gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0][valid]
        lse = torch.logsumexp(logits, dim=-1)[valid]
        return lse - gold, {"lse": lse.mean().item(), "gold": gold.mean().item(),
                            "logit_var": logits.var().item()}


def train_numerics(torch, s, params, batch, fa_kernel, device):
    """The kernel-path loss and gradients of the first batch against an fp32
    plain-attention step of the same weights, beside a bf16 plain-attention
    step.  Per gradient leaf, and for the per-token losses, the kernel
    path's relative L2 error may be LOGIT_SLACK times the plain bf16 one's;
    the mean loss may be off by LOGIT_SLACK times the plain bf16 path's RMS
    per-token error (a mean of errors is at most their RMS)."""
    from repro_torch.models.convert import flatten, unflatten
    from repro_torch.models.registry import build
    from repro_torch.runtime.steps import value_and_grad
    cfg = s.api.cfg
    plain = build(dataclasses.replace(cfg, attn_impl="full"), device)
    exact = build(dataclasses.replace(cfg, attn_impl="full", compute_dtype="float32"), device)
    params32 = unflatten(params, {k: v.float() for k, v in flatten(params).items()})
    reset_flash_counts(fa_kernel)
    loss_k, _, g_k = value_and_grad(s.api, params, batch)
    counts = flash_counts(fa_kernel)
    check(counts == (2 * cfg.n_layers, 2 * cfg.n_layers, 0, 0),
          f"flash launches (all, TMA, mma.sync, fp32) {counts} in one loss and gradient, "
          f"want {2 * cfg.n_layers} on the TMA path (forward, then the remat recompute)")
    loss_p, _, g_p = value_and_grad(plain, params, batch)
    loss_e, _, g_e = value_and_grad(exact, params32, batch)
    check(flash_counts(fa_kernel) == counts,
          f"a plain-attention step launched the kernel: {flash_counts(fa_kernel)}")
    (tok_k, _), (tok_p, _), (tok_e, terms) = (
        token_losses(api, p, batch, torch)
        for api, p in ((s.api, params), (plain, params), (exact, params32)))
    leaves = {}
    g_k, g_p = flatten(g_k), flatten(g_p)
    for path, ge in flatten(g_e).items():
        rk, rp = rel_l2(g_k[path], ge), rel_l2(g_p[path], ge)
        leaves[path] = {"kernel": rk, "plain_bf16": rp, "ratio": rk / rp}
    tok_rk, tok_rp = rel_l2(tok_k, tok_e), rel_l2(tok_p, tok_e)
    rms_p = (tok_p - tok_e).pow(2).mean().sqrt().item()
    # the loss is held to the fp32 step's alone: untrained, it is not ln V
    # (the logits' variance and the labels' gold logits add to it), so
    # ln V and the fp32 path's terms are printed, not checked
    row = {"flash_launches": counts[0], "flash_mma_sync_launches": counts[2],
           "loss_kernel": loss_k.item(), "loss_plain_bf16": loss_p.item(),
           "loss_fp32": loss_e.item(), "ln_vocab": math.log(cfg.vocab_size),
           "loss_terms_fp32": terms,
           "loss_err_kernel": abs(loss_k.item() - loss_e.item()),
           "loss_err_plain_bf16": abs(loss_p.item() - loss_e.item()),
           "token_loss_rms_err_plain_bf16": rms_p,
           "token_loss_rel_l2": {"kernel": tok_rk, "plain_bf16": tok_rp,
                                 "ratio": tok_rk / tok_rp},
           "max_grad_ratio": max(v["ratio"] for v in leaves.values()),
           "grad_rel_l2": leaves}
    emit({"phase": "train_numerics", **row})
    check(tok_rk <= LOGIT_SLACK * tok_rp, f"per-token losses: {row['token_loss_rel_l2']}")
    check(row["loss_err_kernel"] <= LOGIT_SLACK * rms_p,
          f"loss {row['loss_kernel']} vs fp32 {row['loss_fp32']}; plain bf16 RMS {rms_p}")
    for path, v in leaves.items():
        check(v["kernel"] <= LOGIT_SLACK * v["plain_bf16"], f"gradient of {path}: {v}")
    del g_k, g_p, g_e, params32, plain, exact
    torch.cuda.empty_cache()
    return row


def read_object(root, meta):
    """The bytes of one manifest entry as written on disk."""
    with open(os.path.join(root, meta["object"]), "rb") as f:
        f.seek(meta.get("offset", 0))
        return f.read(meta["length"]) if "length" in meta else f.read()


def train_full_width(torch, launch_train, fa_kernel, cs_kernel, ssm_kernel, device):
    """The training path: full-width training through repro_torch.launch.train,
    an injected failure, a restart, and the checkpoints' integrity."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.core.errors import IntegrityError
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.kernels.checksum.ref import digest_ref
    from repro_torch.models.convert import flatten
    from repro_torch.runtime.steps import make_train_state
    from repro_torch.runtime.train import InjectedFailure, run_training

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        emit({"phase": "train_disk", "dir": tmp, "free_bytes": shutil.disk_usage(tmp).free})
        argv = ["--arch", ARCH, "--no-scaled-down", "--n-layers", str(TRAIN_LAYERS),
                "--batch-size", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
                "--steps", str(TRAIN_STEPS), "--ckpt-every", str(CKPT_EVERY), "--retain", "2",
                "--data-records", "64", "--log-every", "1", "--device", str(device),
                "--seed", "0", "--ckpt-dir", tmp]
        s = launch_train.setup(launch_train.parse_args(argv + ["--fail-at-step", str(FAIL_AT)]))
        cfg = s.api.cfg
        check(cfg == dataclasses.replace(launch_train.get_config(ARCH), n_layers=TRAIN_LAYERS),
              f"not the full-width config cut to {TRAIN_LAYERS} layers: {cfg}")
        state = make_train_state(s.api, s.opt, torch.Generator(device).manual_seed(0))
        check(flatten(state)["opt/m/lm_head/w"].dtype == torch.float32
              and flatten(state)["params/lm_head/w"].dtype == torch.bfloat16,
              "want bf16 parameters and fp32 moments")
        n_leaves = len(flatten(state))
        state_bytes = sum(t.numel() * t.element_size() for t in flatten(state).values())
        first = next(ShardedTokenDataset(s.data.connector, s.data.base, s.data.cfg).batches())
        batch = {k: torch.tensor(v, device=device) for k, v in first.items()}
        numerics = train_numerics(torch, s, state["params"], batch, fa_kernel, device)

        # run 1: steps 1-4, checkpoints at 2 and 4, an injected failure before step 5
        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        try:
            run_training(s.api, s.opt, s.loop, s.data, ckpt_mgr=s.ckpt, state=state)
            check(False, "run 1 did not stop at the injected failure")
        except InjectedFailure as exc:
            run1 = exc.result
        fa1, cs1, sync1 = fa_kernel.launches, cs_kernel.launches, fa_kernel.sync_launches
        check(ssm_kernel.launches == 0, "dense training launched the scan kernel")
        check(fa_kernel.tma_launches == fa1, f"training took the mma.sync flash path {sync1} / "
                                             f"the fp32 path {fa_kernel.f32_launches} times")
        saves1 = list(s.ckpt.timings)
        check(run1.steps_run == FAIL_AT - 1 and int(state["opt"]["step"]) == FAIL_AT - 1,
              f"run 1 ran {run1.steps_run} steps")
        check(fa1 == 2 * cfg.n_layers * run1.steps_run,
              f"{fa1} flash launches in {run1.steps_run} steps, want 2 x {cfg.n_layers} per step")
        root = os.path.join(tmp, "ckpt", f"step_{FAIL_AT - 1}")
        with open(os.path.join(root, "manifest.json"), "rb") as f:
            manifest = json.loads(f.read())
        check(len(saves1) == 2 and all(t["leaves"] == n_leaves for t in saves1),
              f"saves of run 1: {saves1}")
        check(all(t["verified"] == len(manifest["objects"]) for t in saves1),
              f"post-write verification of run 1: {saves1}")
        check(cs1 == sum(t["leaves"] + t["verified"] for t in saves1),
              f"{cs1} checksum launches for {saves1}")

        # the digests on disk, recomputed on the host by numpy
        on_disk = {}
        for path, meta in (("params/embed/table", manifest["objects"]["params/embed/table"]),
                           ("opt/m/lm_head/w", manifest["objects"]["opt/m/lm_head/w"]),
                           ("params/final_norm/scale",
                            manifest["bundles"]["params/final_norm/scale"])):
            dig = digest_ref(read_object(root, meta))
            on_disk[path] = {"dtype": meta["dtype"], "manifest": meta["checksum"], "numpy": dig}
            check(dig == meta["checksum"], f"{path} on disk: numpy {dig}, manifest {meta}")

        # the restored state is byte for byte the state saved at step 4
        t0 = time.perf_counter()
        restored, step = s.ckpt.restore_latest(state)
        torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t0
        check(step == FAIL_AT - 1, f"latest checkpoint is step {step}")
        for path, want in flatten(state).items():
            got = flatten(restored)[path]
            check(got.dtype == want.dtype and got.shape == want.shape and got.device == want.device
                  and torch.equal(got.reshape(-1).view(torch.uint8),
                                  want.reshape(-1).view(torch.uint8)),
                  f"restored {path} differs from the state saved at step {step}")
        del restored
        torch.cuda.empty_cache()

        # the restart, as after a preemption: fresh objects, restore, steps
        # 5-6; its save at step 6 is replicated to an emulated object store
        s2 = launch_train.setup(launch_train.parse_args(
            argv + ["--replicate-to", MIRROR_PROVIDER]))
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        run2 = run_training(s2.api, s2.opt, s2.loop, s2.data, ckpt_mgr=s2.ckpt,
                            replicator=s2.replicator)
        fa2, cs2, sync2 = fa_kernel.launches, cs_kernel.launches, fa_kernel.sync_launches
        check(ssm_kernel.launches == 0, "the restart launched the scan kernel")
        check(fa_kernel.tma_launches == fa2, f"the restart took the mma.sync flash path {sync2} "
                                             f"/ the fp32 path {fa_kernel.f32_launches} times")
        saves2 = list(s2.ckpt.timings)
        peak_mem = torch.cuda.max_memory_allocated(device)
        check(run2.restored_from == FAIL_AT - 1 and run2.steps_run == TRAIN_STEPS - FAIL_AT + 1,
              f"restart: restored_from {run2.restored_from}, steps_run {run2.steps_run}")
        check(fa2 == 2 * cfg.n_layers * run2.steps_run, f"{fa2} flash launches in the restart")
        check(cs2 == n_leaves + sum(t["leaves"] + t["verified"] for t in saves2),
              f"{cs2} checksum launches in the restart: {n_leaves} restored, {saves2}")
        logged = run1.losses + run2.losses + run1.grad_norms + run2.grad_norms
        check(len(run1.losses) + len(run2.losses) == TRAIN_STEPS
              and all(math.isfinite(v) for _, v in logged), f"losses and grad norms {logged}")
        check(abs(run1.losses[0][1] - numerics["loss_kernel"]) <= 1e-3 * numerics["loss_kernel"],
              f"first step's loss {run1.losses[0][1]} vs {numerics['loss_kernel']}")

        # the replica of step 6, before the byte flipped on disk below
        cs_kernel.launches = 0
        replication = mirror_check(torch, s2, state, os.path.join(tmp, "ckpt", f"step_{TRAIN_STEPS}"),
                                   n_leaves, cs_kernel)
        mirror_cs = cs_kernel.launches

        # a flipped byte in a written object fails the restore
        latest = os.path.join(tmp, "ckpt", f"step_{TRAIN_STEPS}")
        obj = os.path.join(latest, "params.embed.table.bin")
        with open(obj, "r+b") as f:
            f.seek(12345)
            byte = f.read(1)
            f.seek(12345)
            f.write(bytes([byte[0] ^ 0x10]))
        try:
            restore_checkpoint(state, s2.ckpt.connector, "ckpt", TRAIN_STEPS)
            check(False, "restore of a corrupted checkpoint did not raise")
        except IntegrityError as exc:
            corrupt = str(exc)
        check("params/embed/table" in corrupt, f"corruption reported as {corrupt!r}")

        # no step's time holds a save; the first of each run holds set-up
        step_s = run1.step_seconds[1:] + run2.step_seconds[1:]
        med = statistics.median(step_s)
        row = {"arch": ARCH, "reduced": {
                   "n_layers": [launch_train.get_config(ARCH).n_layers, TRAIN_LAYERS],
                   "why": "checkpoint bytes on disk (three checkpoints of the 2-layer "
                          "state are 17 GB) and the smoke's time limit"},
               "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
               "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
               "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "state_leaves": n_leaves,
               "state_bytes": state_bytes,
               "run1": {"steps_run": run1.steps_run, "losses": run1.losses,
                        "grad_norms": run1.grad_norms, "flash_launches": fa1,
                        "checksum_launches": cs1},
               "restart": {"restored_from": run2.restored_from, "steps_run": run2.steps_run,
                           "losses": run2.losses, "grad_norms": run2.grad_norms,
                           "flash_launches": fa2, "checksum_launches": cs2},
               "step_seconds": run1.step_seconds + run2.step_seconds,
               "median_step_s_after_first": med, "steps_in_median": len(step_s),
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
               "saves": saves1 + saves2, "restore_s": restore_s,
               "replication": replication,
               "max_memory_allocated": peak_mem, "digests_on_disk": on_disk,
               "corruption": corrupt}
        emit({"phase": "train", **row})
        prof = train_profile(torch, s2, state, batch, fa_kernel)
        return fa1 + fa2, cs1 + cs2, mirror_cs, {
            "train_numerics": numerics["flash_mma_sync_launches"], "train": sync1 + sync2,
            "train_profile": prof["flash_mma_sync_launches"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mirror_check(torch, s, state, root, n_leaves, cs_kernel):
    """The replica the restart's replicator made of the save in ``root``:
    one task, for step TRAIN_STEPS, SUCCEEDED with integrity on; each
    leaf's lanesum32 at the destination (the service's verified per-file
    digest for a leaf with an object of its own, the host hasher over its
    slice of the mirrored bundle otherwise) equal to the manifest digest
    the card took at save time; the mirror restored onto the card (each
    leaf digested there again) byte for byte equal to the leaves on disk;
    and one byte flipped in the mirror failing the restore of its leaf."""
    from repro_torch.ckpt import get_bytes, put_bytes, restore_checkpoint
    from repro_torch.core.errors import IntegrityError
    from repro_torch.core.integrity import checksum_bytes
    from repro_torch.models.convert import flatten
    rep = s.replicator
    check([step for step, _, _ in rep.done] == [TRAIN_STEPS],
          f"replicated steps {[step for step, _, _ in rep.done]}, want [{TRAIN_STEPS}]")
    _, task, wall_s = rep.done[0]
    with open(os.path.join(root, "manifest.json"), "rb") as f:
        manifest_raw = f.read()
    manifest = json.loads(manifest_raw)
    n_files = len(os.listdir(root))
    check(task.status == task.SUCCEEDED, f"replication {task.status}: {task.events[-5:]}")
    check(task.stats.integrity_failures == 0 and all(f.ok and f.checksum for f in task.files)
          and task.stats.files_done == task.stats.files_total == n_files,
          f"replication files: {task.stats}")
    by_file = {os.path.basename(f.dst): f.checksum for f in task.files}
    conn, base = rep.mirror.connector, f"{rep.mirror.path}/step_{TRAIN_STEPS}"
    cred = rep.service.creds.lookup(rep.mirror.endpoint_id)
    session = conn.start(cred)
    try:
        check(get_bytes(conn, session, f"{base}/manifest.json") == manifest_raw,
              "the mirror's manifest differs from the one on disk")
        at_dst = {path: by_file[meta["object"]] for path, meta in manifest["objects"].items()}
        at_dst.update({path: checksum_bytes(get_bytes(
            conn, session, f"{base}/{meta['object']}", offset=meta["offset"],
            length=meta["length"]), "lanesum32") for path, meta in manifest["bundles"].items()})
    finally:
        conn.destroy(session)
    entries = {**manifest["objects"], **manifest["bundles"]}
    check(len(at_dst) == n_leaves and all(at_dst[p] == m["checksum"] for p, m in entries.items()),
          f"destination digests differ from the card's: "
          f"{ {p: (at_dst[p], m['checksum']) for p, m in entries.items() if at_dst[p] != m['checksum']} }")

    before = cs_kernel.launches
    t0 = time.perf_counter()
    restored, step = restore_checkpoint(state, conn, rep.mirror.path, TRAIN_STEPS, credential=cred)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_cs = cs_kernel.launches - before
    check(step == TRAIN_STEPS, f"restored step {step} from the mirror")
    check(restore_cs == n_leaves, f"{restore_cs} checksum launches restoring the mirror, "
                                  f"want {n_leaves}")
    for path, got in flatten(restored).items():
        want = torch.frombuffer(bytearray(read_object(root, entries[path])), dtype=torch.uint8)
        check(got.device == flatten(state)[path].device
              and torch.equal(got.reshape(-1).view(torch.uint8).cpu(), want),
              f"{path} restored from the mirror differs from the leaf on disk")
    del restored

    # a byte flipped in the mirror fails the restore of its leaf
    path = "params/embed/table"
    obj = f"{base}/{manifest['objects'][path]['object']}"
    session = conn.start(cred)
    try:
        data = bytearray(get_bytes(conn, session, obj))
        data[12345] ^= 0x10
        put_bytes(conn, session, obj, bytes(data))
    finally:
        conn.destroy(session)
    del data
    try:
        restore_checkpoint({"params": {"embed": {"table": flatten(state)[path]}}}, conn,
                           rep.mirror.path, TRAIN_STEPS, credential=cred)
        check(False, "restore of a corrupted mirror did not raise")
    except IntegrityError as exc:
        corrupt = str(exc)
    check(path in corrupt, f"mirror corruption reported as {corrupt!r}")
    return {"provider": MIRROR_PROVIDER, "step": TRAIN_STEPS, "status": task.status,
            "integrity": True, "checksum_algorithm": "lanesum32", "files": n_files,
            "bytes": task.stats.bytes_done, "replicate_wall_s": wall_s,
            "host_mb_per_s": task.stats.bytes_done / wall_s / 1e6,
            "model_s": task.stats.actual_model_seconds,
            "leaf_digests_checked": len(at_dst),
            "leaves_by_service_digest": len(manifest["objects"]),
            "leaves_by_host_hasher": len(manifest["bundles"]),
            "restore_s": restore_s, "restore_checksum_launches": restore_cs,
            "corruption": corrupt}


def train_profile(torch, s, state, batch, fa_kernel):
    """The training rate and where a step's time goes: WARM_STEPS warm
    steps timed one by one without the profiler, then torch.profiler over
    one step, device time per kernel name and under the step's
    record_function ranges, and the plain attention backward timed alone.
    The steps' flash launches must all take the TMA path."""
    from repro_torch.kernels.flash_attention.ops import FlashAttention
    from repro_torch.runtime.steps import make_train_step
    cfg = s.api.cfg
    step_fn = make_train_step(s.api, s.opt)
    reset_flash_counts(fa_kernel)
    step_fn(state, batch)
    torch.cuda.synchronize()
    walls = [ms / 1e3 for ms in wall_ms(torch, lambda: step_fn(state, batch), WARM_STEPS)]
    wall = statistics.median(walls)
    ranges = ("train_step/loss_and_grad", "train_step/adamw", "flash_attention/plain_backward")
    kernels, n_launches, spans, cpu_side, busy_in = profile_device(
        torch, lambda: step_fn(state, batch), ranges)
    fa_counts = flash_counts(fa_kernel)
    want = 2 * cfg.n_layers * (WARM_STEPS + 2)
    check(fa_counts == (want, want, 0, 0),
          f"flash launches (all, TMA, mma.sync, fp32) {fa_counts} in {WARM_STEPS + 2} steps, "
          f"want {want} on the TMA path")
    busy = sum(kernels.values())
    # the attention of one layer at the step's shape: kernel forward, plain backward
    case = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            True, cfg.swa_window)
    q, k, v = (t.requires_grad_() for t in attn_inputs(case, torch.bfloat16, 11,
                                                        s.api.device, torch))
    do = torch.randn_like(q)
    chunk = min(cfg.attn_chunk, TRAIN_SEQ)
    fwd = lambda: FlashAttention.apply(q, k, v, True, cfg.swa_window, chunk)
    o = fwd()
    with torch.no_grad():
        fwd_ms = time_ms(fwd, torch)
    bwd_ms = time_ms(lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True), torch)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    row = {"warm_steps": len(walls), "warm_step_s": walls, "median_step_s": wall,
           "min_step_s": min(walls), "max_step_s": max(walls),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
           "wall_ms_unprofiled": wall * 1e3, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (wall * 1e3), "kernels": len(kernels),
           "kernel_launches": n_launches, "flash_launches": fa_counts[0],
           "flash_mma_sync_launches": fa_counts[2],
           "device_ms_in_range": spans, "device_ms_in_range_cpu_side": cpu_side,
           "device_busy_ms_in_range": busy_in,
           "attention_layer_ms": {"kernel_forward": fwd_ms, "plain_backward": bwd_ms},
           "top_kernels_ms": {name[:80]: ms for name, ms in top}}
    emit({"phase": "train_profile", **row})
    return row


def rwkv_numerics(torch, s, params, batch, kernels, ssm_ops, ssm_ref, device):
    """The kernel-path loss and gradients of the first batch, in bf16 and
    in fp32 compute, against an fp32 step through the plain chunked scan,
    beside a bf16 step through the plain scan.  As train_numerics does for
    dense: per gradient leaf, and for the per-token losses, each kernel
    path's relative L2 error may be LOGIT_SLACK times the plain bf16 one's;
    its mean loss may be off by LOGIT_SLACK times the plain bf16 path's RMS
    per-token error."""
    from repro_torch.models.convert import flatten, unflatten
    from repro_torch.models.registry import build
    from repro_torch.runtime.steps import value_and_grad
    fa_kernel, cs_kernel, ssm_kernel = kernels
    cfg = s.api.cfg
    exact = build(dataclasses.replace(cfg, compute_dtype="float32"), device)
    params32 = unflatten(params, {k: v.float() for k, v in flatten(params).items()})
    reset_flash_counts(fa_kernel)
    cs_kernel.launches = ssm_kernel.launches = 0
    loss_k, _, g_k = value_and_grad(s.api, params, batch)
    n_k = ssm_kernel.launches
    loss_k32, _, g_k32 = value_and_grad(exact, params32, batch)
    n_k32 = ssm_kernel.launches - n_k
    check(n_k == n_k32 == 2 * cfg.n_layers,
          f"scan launches {n_k} (bf16) / {n_k32} (fp32) in one loss and gradient, want "
          f"{2 * cfg.n_layers} (forward, then the remat recompute)")
    check(flash_counts(fa_kernel) == (0, 0, 0, 0) and cs_kernel.launches == 0,
          f"rwkv training launched flash {flash_counts(fa_kernel)} / checksum "
          f"{cs_kernel.launches} times")
    tok_k, _ = token_losses(s.api, params, batch, torch)
    tok_k32, _ = token_losses(exact, params32, batch, torch)
    ssm_kernel.launches = 0
    with plain_scan(ssm_ops, ssm_ref):
        loss_p, _, g_p = value_and_grad(s.api, params, batch)
        loss_e, _, g_e = value_and_grad(exact, params32, batch)
        tok_p, _ = token_losses(s.api, params, batch, torch)
        tok_e, terms = token_losses(exact, params32, batch, torch)
    check(ssm_kernel.launches == 0, "a plain-scan step launched the kernel")
    g_k, g_k32, g_p = flatten(g_k), flatten(g_k32), flatten(g_p)
    leaves = {}
    for path, ge in flatten(g_e).items():
        rk, rk32, rp = (rel_l2(g[path], ge) for g in (g_k, g_k32, g_p))
        check(all(math.isfinite(r) for r in (rk, rk32, rp)), f"gradient of {path}: not finite")
        leaves[path] = {"kernel": rk, "kernel_fp32": rk32, "plain_bf16": rp,
                        "ratio": rk / rp, "ratio_fp32": rk32 / rp}
    toks = {"kernel": rel_l2(tok_k, tok_e), "kernel_fp32": rel_l2(tok_k32, tok_e),
            "plain_bf16": rel_l2(tok_p, tok_e)}
    rms_p = (tok_p - tok_e).pow(2).mean().sqrt().item()
    row = {"scan_launches": n_k, "scan_launches_fp32": n_k32,
           "loss_kernel": loss_k.item(), "loss_kernel_fp32": loss_k32.item(),
           "loss_plain_bf16": loss_p.item(), "loss_fp32": loss_e.item(),
           "ln_vocab": math.log(cfg.vocab_size), "loss_terms_fp32": terms,
           "loss_err_kernel": abs(loss_k.item() - loss_e.item()),
           "loss_err_kernel_fp32": abs(loss_k32.item() - loss_e.item()),
           "loss_err_plain_bf16": abs(loss_p.item() - loss_e.item()),
           "token_loss_rms_err_plain_bf16": rms_p, "token_loss_rel_l2": toks,
           "max_grad_ratio": max(v["ratio"] for v in leaves.values()),
           "max_grad_ratio_fp32": max(v["ratio_fp32"] for v in leaves.values()),
           "grad_rel_l2": leaves}
    emit({"phase": "train_rwkv_numerics", **row})
    for key in ("kernel", "kernel_fp32"):
        check(toks[key] <= LOGIT_SLACK * toks["plain_bf16"], f"per-token losses: {toks}")
        check(row[f"loss_err_{key}"] <= LOGIT_SLACK * rms_p,
              f"loss ({key}) {row}; plain bf16 RMS {rms_p}")
        for path, v in leaves.items():
            check(v[key] <= LOGIT_SLACK * v["plain_bf16"], f"gradient of {path}: {v}")
    del g_k, g_k32, g_p, g_e, params32, exact
    torch.cuda.empty_cache()
    return row


def train_rwkv(torch, launch_train, kernels, ssm_ops, ssm_ref, device):
    """The rwkv6 training path: full-width rwkv6-7b cut to TRAIN_LAYERS
    layers through repro_torch.launch.train, TRAIN_BATCH x TRAIN_SEQ tokens
    a step, no checkpoint (the dense run covers that path): the numerics of
    one step, RWKV_TRAIN_STEPS steps of run_training, then the warm rate
    and a profiled step as train_profile does, with the step's device time
    split into the scan kernel, the plain scan backward (its
    record_function range), AdamW and the rest."""
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.models.convert import flatten
    from repro_torch.runtime.steps import make_train_state, make_train_step
    from repro_torch.runtime.train import run_training
    fa_kernel, cs_kernel, ssm_kernel = kernels
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rwkv_")
    try:
        argv = ["--arch", RWKV_ARCH, "--no-scaled-down", "--n-layers", str(TRAIN_LAYERS),
                "--batch-size", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
                "--steps", str(RWKV_TRAIN_STEPS), "--data-records", "64", "--log-every", "1",
                "--device", str(device), "--seed", "0", "--ckpt-dir", tmp]
        s = launch_train.setup(launch_train.parse_args(argv))
        cfg = s.api.cfg
        check(cfg == dataclasses.replace(launch_train.get_config(RWKV_ARCH), n_layers=TRAIN_LAYERS),
              f"not the full-width config cut to {TRAIN_LAYERS} layers: {cfg}")
        state = make_train_state(s.api, s.opt, torch.Generator(device).manual_seed(0))
        leaves = flatten(state)
        nbytes = lambda prefix: sum(t.numel() * t.element_size() for p, t in leaves.items()
                                    if p.startswith(prefix))
        params = {p: t for p, t in leaves.items() if p.startswith("params/")}
        sizes = {"params": sum(t.numel() for t in params.values()),
                 "params_in_blocks": sum(t.numel() for p, t in params.items()
                                         if p.startswith("params/blocks/")),
                 "params_embed_and_head": sum(t.numel() for p, t in params.items()
                                              if p in ("params/embed/table", "params/lm_head/w")),
                 "param_bytes": nbytes("params/"),
                 "moment_bytes": nbytes("opt/m/") + nbytes("opt/v/"),
                 "state_bytes": nbytes(""), "state_leaves": len(leaves)}
        check(leaves["opt/m/lm_head/w"].dtype == torch.float32
              and leaves["params/lm_head/w"].dtype == torch.bfloat16,
              "want bf16 parameters and fp32 moments")
        first = next(ShardedTokenDataset(s.data.connector, s.data.base, s.data.cfg).batches())
        batch = {k: torch.tensor(v, device=device) for k, v in first.items()}
        numerics = rwkv_numerics(torch, s, state["params"], batch, kernels, ssm_ops, ssm_ref,
                                 device)

        # the run: RWKV_TRAIN_STEPS steps through run_training, no checkpoint
        torch.cuda.reset_peak_memory_stats(device)
        reset_flash_counts(fa_kernel)
        cs_kernel.launches = ssm_kernel.launches = 0
        run = run_training(s.api, s.opt, s.loop, s.data, state=state)
        n_ssm, fa_run, cs_run = ssm_kernel.launches, flash_counts(fa_kernel), cs_kernel.launches
        check(run.steps_run == RWKV_TRAIN_STEPS, f"rwkv training ran {run.steps_run} steps")
        check(n_ssm == 2 * cfg.n_layers * run.steps_run,
              f"{n_ssm} scan launches in {run.steps_run} steps, want 2 x {cfg.n_layers} a step")
        check(fa_run == (0, 0, 0, 0) and cs_run == 0,
              f"rwkv training launched flash {fa_run} / checksum {cs_run} times")
        logged = run.losses + run.grad_norms
        check(len(run.losses) == RWKV_TRAIN_STEPS and all(math.isfinite(v) for _, v in logged),
              f"losses and grad norms {logged}")
        check(abs(run.losses[0][1] - numerics["loss_kernel"]) <= 1e-3 * numerics["loss_kernel"],
              f"first step's loss {run.losses[0][1]} vs {numerics['loss_kernel']}")

        # the warm rate and one profiled step
        step_fn = make_train_step(s.api, s.opt)
        ssm_kernel.launches = 0
        step_fn(state, batch)
        torch.cuda.synchronize()
        walls = [ms / 1e3 for ms in wall_ms(torch, lambda: step_fn(state, batch), WARM_STEPS)]
        wall = statistics.median(walls)
        warm_ssm = ssm_kernel.launches
        check(warm_ssm == 2 * cfg.n_layers * (WARM_STEPS + 1),
              f"{warm_ssm} scan launches in {WARM_STEPS + 1} steps")
        ranges = ("train_step/loss_and_grad", "train_step/adamw", "ssm_scan/plain_backward")
        by_name, n_launches, spans, cpu_side, busy_in = profile_device(
            torch, lambda: step_fn(state, batch), ranges, complete=lambda counts: sum(
                c for n, c in counts.items() if "ssm_scan_kernel" in n) == 2 * cfg.n_layers)
        prof_ssm = ssm_kernel.launches - warm_ssm
        check(prof_ssm > 0 and prof_ssm % (2 * cfg.n_layers) == 0,
              f"{prof_ssm} scan launches in the profiled steps")
        check(all(math.isfinite(t.float().sum().item()) for t in flatten(state).values()),
              "non-finite training state after the warm steps")
        peak_mem = torch.cuda.max_memory_allocated(device)
        busy = sum(by_name.values())
        scan_ms = sum(ms for n, ms in by_name.items() if "ssm_scan_kernel" in n)
        bwd_ms, adamw_ms = busy_in["ssm_scan/plain_backward"], busy_in["train_step/adamw"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        row = {"arch": RWKV_ARCH, "reduced": {
                   "n_layers": [launch_train.get_config(RWKV_ARCH).n_layers, TRAIN_LAYERS],
                   "why": "as the dense training run: the smoke's time limit"},
               "d_model": cfg.d_model, "heads": cfg.d_model // cfg.ssm.head_dim,
               "head_dim": cfg.ssm.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
               **sizes, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
               "run": {"steps_run": run.steps_run, "losses": run.losses,
                       "grad_norms": run.grad_norms, "scan_launches": n_ssm,
                       "step_seconds": run.step_seconds},
               "warm_steps": len(walls), "warm_step_s": walls, "median_step_s": wall,
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
               "profile": {"wall_ms_unprofiled": wall * 1e3, "device_busy_ms": busy,
                           "idle_share": 1.0 - busy / (wall * 1e3), "kernels": len(by_name),
                           "kernel_launches": n_launches,
                           "scan_kernel_ms": scan_ms, "plain_scan_backward_ms": bwd_ms,
                           "adamw_ms": adamw_ms, "rest_ms": busy - scan_ms - bwd_ms - adamw_ms,
                           "device_ms_in_range": spans, "device_ms_in_range_cpu_side": cpu_side,
                           "device_busy_ms_in_range": busy_in,
                           "top_kernels_ms": {n[:80]: ms for n, ms in top}},
               "max_memory_allocated": peak_mem}
        emit({"phase": "train_rwkv", **row})
        return n_ssm, fa_run[2], row
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.checksum import kernel as cs_kernel
    from repro_torch.kernels.checksum import ops as cs_ops
    from repro_torch.kernels.checksum import ref as cs_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan import ref as ssm_ref
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi[:1],
          "peak_bytes_per_s": PEAK_BYTES_PER_S, "peak_bf16_flops": PEAK_BF16_FLOPS,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:  # one nvcc per source
        logs = dict(zip(_build.SOURCES, pool.map(_build.build, _build.SOURCES)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {src: [ln.strip() for ln in log.splitlines()
                          if any(w in ln for w in ("entry function", "registers", "spill",
                                                   "arning"))]
                    for src, log in logs.items()}})
    cfg = serve.get_config(ARCH)
    largest_leaf = ("largest training leaf, opt/m/lm_head/w", (cfg.d_model, cfg.vocab_size),
                    torch.float32)
    kernels = (fa_kernel, cs_kernel, ssm_kernel)
    try:
        worst = kernel_check(torch, fa_kernel, fa_ref, device)
        cs_worst = checksum_check(torch, cs_ops, cs_ref, device)
        ssm_worst = ssm_check(torch, ssm_ops, ssm_kernel, ssm_ref, device)
        times = kernel_times(torch, fa_kernel, fa_ref, F, device)
        cs_times = checksum_times(torch, cs_kernel, cs_ref, device, largest_leaf)
        s_times = ssm_times(torch, ssm_kernel, ssm_ref, device)
        serve_rows, serve_fa = serve_full_width(torch, serve, build, fa_kernel, cs_kernel,
                                                ssm_kernel, device)
        rwkv_rows, rwkv_ssm = serve_rwkv(torch, serve, build, kernels, ssm_ops, ssm_ref, device)
        _, moe_fa, moe_sync = serve_moe(torch, serve, build, kernels, device)
        _, mamba_times, mamba_ssm, mamba_worst = mamba_layer(torch, kernels, ssm_ops, ssm_ref,
                                                             device)
        ssm_worst = max(ssm_worst, mamba_worst)
        _, hybrid = serve_hybrid(torch, serve, build, kernels, ssm_ops, ssm_ref, device)
        train_fa, train_cs, mirror_cs, train_sync = train_full_width(
            torch, launch_train, fa_kernel, cs_kernel, ssm_kernel, device)
        torch.cuda.empty_cache()
        rwkv_train_ssm, rwkv_train_sync, _ = train_rwkv(
            torch, launch_train, kernels, ssm_ops, ssm_ref, device)
    except SmokeFailure as exc:
        emit({"ok": False, "error": str(exc)})
        return 1
    keys = ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    sync_by_run = {"serve": sum(r["flash_mma_sync_launches"] for r in serve_rows),
                   "serve_rwkv": sum(r["flash_mma_sync_launches"] for r in rwkv_rows),
                   "serve_moe": moe_sync, **train_sync, "train_rwkv": rwkv_train_sync}
    fa_by_path = {"serve": serve_fa, "serve_rwkv": 0, "serve_moe": moe_fa, "mamba_layer": 0,
                  "serve_hybrid": hybrid["flash"], "train": train_fa, "train_rwkv": 0}
    cs_by_path = {"serve": 0, "serve_rwkv": 0, "serve_moe": 0, "mamba_layer": 0,
                  "serve_hybrid": 0, "train": train_cs, "train_mirror_restore": mirror_cs,
                  "train_rwkv": 0}
    ssm_by_path = {"serve": 0, "serve_rwkv": rwkv_ssm, "serve_moe": 0, "mamba_layer": mamba_ssm,
                   "serve_hybrid": hybrid["scan"], "train": 0, "train_rwkv": rwkv_train_ssm}
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "kernel": "attn_fwd_bf16_tma (TMA, wgmma); attn_fwd_f32 on serve_hybrid's fp32 path",
        "launches": sum(fa_by_path.values()), "launches_by_path": fa_by_path,
        # read in each run of each main path, and checked to be 0 there
        "mma_sync_path_launches_by_run": sync_by_run,
        "mma_sync_path_launches": sum(sync_by_run.values()),
        "max_abs_err": worst, **{k: times[0][k] for k in keys}, "shapes": times}, {
        "name": "lanesum32", "route": "cuda",
        "source": "src/repro_torch/kernels/checksum/csrc/checksum.cu",
        "replaces": "src/repro/kernels/checksum/kernel.py:32",
        "launches": sum(cs_by_path.values()), "launches_by_path": cs_by_path,
        "max_abs_err": cs_worst, **{k: cs_times[0][k] for k in keys}, "shapes": cs_times}, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:27",
        "launches": sum(ssm_by_path.values()), "launches_by_path": ssm_by_path,
        "max_abs_err": ssm_worst, **{k: s_times[0][k] for k in keys},
        "device_ms": s_times[0]["device_ms"], "shapes": s_times + mamba_times}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
