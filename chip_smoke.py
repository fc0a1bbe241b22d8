#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``src/repro_torch`` (``nvcc``);
3. holds each kernel against its plain PyTorch version on the card;
4. serves full-width h2o-danube-3-4b (24 layers, bf16, random weights from
   a seed) through ``repro_torch.launch.serve``: 4 requests x 512-token
   prompts to 32 tokens, then 1 request x a 5120-token prompt to 8 tokens,
   and checks finite logits, 24 kernel launches per prefill, the same
   greedy first token through the plain attention, and logits about as
   close to an fp32 prefill as the plain bf16 prefill's;
5. prints one JSON line of per-kernel launches, times and bounds, then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero.  Without CUDA, or without the repository
around it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

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
]
MAIN_CASES = [(4, 512, 512, 32, 8, 120, True, 4096),
              (1, 5120, 5120, 32, 8, 120, True, 4096)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # rtol = atol, as tests/test_kernels.py
#: served logits may be this many times further from an fp32 prefill than
#: the plain-attention bf16 prefill's logits are
LOGIT_SLACK = 1.5

#: H100 SXM data sheet, dense: memory bytes/s, bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12


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


def attn_inputs(case, dtype, seed, device, torch):
    B, Sq, Skv, H, KV, dh, _, _ = case
    gen = torch.Generator(device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((B, Sq, H, dh), (B, Skv, KV, dh), (B, Skv, KV, dh))]


def kernel_check(torch, fa_kernel, fa_ref, device):
    """Kernel against the plain chunked version and attention_ref on the card.

    The limit is ``atol + rtol * |want|`` with rtol = TOL.  On CHECK_CASES
    atol = TOL too, as in tests/test_kernels.py.  On MAIN_CASES a row mixes
    up to 4096 keys, so its outputs are about 0.03 and an atol of 2e-2
    would hide a fault: there atol is TOL times the mean |want| of each
    (b, q, h) row, the scale of that row's outputs and of its rounding."""
    rows, worst = [], 0.0
    cases = [(c, dt) for c in CHECK_CASES for dt in ("float32", "bfloat16")]
    cases += [(c, "bfloat16") for c in MAIN_CASES]
    for i, (case, dt) in enumerate(cases):
        *_, causal, window = case
        q, k, v = attn_inputs(case, getattr(torch, dt), i, device, torch)
        got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal, window=window).float()
        torch.cuda.synchronize()
        row = {"case": list(case), "dtype": dt}
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
    """kernel / plain / library times and the bound at the main-path shapes.
    The library call is SDPA with ``is_causal`` where the window does not
    cut, else with the causal-and-window band as a boolean mask."""
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

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa)

        row["library_ms"] = time_ms(lib, torch)
        row["library_max_abs_err"] = (lib().transpose(1, 2).float() - fa_ref.chunked_attention(
            q, k, v, causal=causal, window=window).float()).abs().max().item()
        row["kernel_ms"] = row["ms"]
        out.append(row)
        del q, k, v, qt, kt, vt, sdpa
    emit({"phase": "kernel_times", "rows": out})
    return out


def serve_full_width(torch, serve, build, fa_kernel, device):
    """The main path: full-width serving through repro_torch.launch.serve."""
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
        fa_kernel.launches = 0
        res = serve.serve(api, params, tokens, gen_len)
        n = fa_kernel.launches
        launches += n
        check(n == cfg.n_layers, f"{n} kernel launches in one prefill, want {cfg.n_layers}")
        logits = res["logits"]
        check(tuple(logits.shape) == (B, 1, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        toks = res["tokens"]
        check(tuple(toks.shape) == (B, gen_len) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, f"generated tokens {tuple(toks.shape)}")
        peak_mem = torch.cuda.max_memory_allocated(device)

        # the same prefill through plain attention, in bf16 and in fp32
        plain = build(dataclasses.replace(cfg, attn_impl="full"), device)
        exact = build(dataclasses.replace(cfg, attn_impl="full", compute_dtype="float32"),
                      device)
        with torch.inference_mode():
            logits_plain, _, _ = plain.prefill(params, {"tokens": tokens})
            logits_exact, _, _ = exact.prefill(params, {"tokens": tokens})
        check(fa_kernel.launches == n, "the plain-attention prefill launched the kernel")
        diff = (logits - logits_plain).abs().max().item()
        err = (logits - logits_exact).abs().max().item()
        err_plain = (logits_plain - logits_exact).abs().max().item()
        first, first_plain = logits[:, -1].argmax(-1), logits_plain[:, -1].argmax(-1)
        top2 = logits_plain[:, -1].topk(2, dim=-1).values
        row = {"requests": B, "prompt_len": S, "gen_len": gen_len,
               "kernel_launches": n, "prefill_s": res["prefill_s"],
               "decode_s": res["decode_s"], "prefill_tok_s": res["prefill_tok_s"],
               "decode_tok_s": res["decode_tok_s"], "max_memory_allocated": peak_mem,
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
        del api, params, tokens, res, logits, logits_plain, logits_exact, plain, exact
        torch.cuda.empty_cache()
    return results, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch import serve
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
    logs = {src: _build.build(src) for src in _build.SOURCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {src: [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln]
                    for src, log in logs.items()}})

    try:
        worst = kernel_check(torch, fa_kernel, fa_ref, device)
        times = kernel_times(torch, fa_kernel, fa_ref, F, device)
        served, launches = serve_full_width(torch, serve, build, fa_kernel, device)
    except SmokeFailure as exc:
        emit({"ok": False, "error": str(exc)})
        return 1
    main_row = times[0]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "launches": launches, "max_abs_err": worst,
        **{k: main_row[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
        "shapes": times}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
