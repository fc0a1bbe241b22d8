#!/usr/bin/env python3
"""Where serving time goes on one GPU, for the PyTorch port.

    python3 scripts/trace_serve_torch.py --requests 4 --prompt-len 512 --steps 8

Serves full-width h2o-danube-3-4b (random weights from --seed) through
``repro_torch.launch.serve``, warms up, then takes, for one prefill and for
``--steps`` greedy decode steps: the host wall time per call without the
profiler, the device busy time per call (the sum of kernel times that
``torch.profiler`` records), the device's idle share, and the kernels with
the most device time.  Prints one JSON line per phase.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def device_kernels(prof, torch):
    """({kernel name: total device microseconds}, kernel count) of a profile."""
    out, n = defaultdict(float), 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name] += ev.time_range.elapsed_us()
            n += 1
    return out, n


def report(phase, wall_s, traced, calls, torch):
    kernels, n = traced
    busy_us = sum(kernels.values()) / calls
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "phase": phase, "device": torch.cuda.get_device_name(0),
        "wall_ms_per_call": wall_s * 1e3, "device_busy_ms_per_call": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "kernels_per_call": n / calls,
        "top_kernels_ms_per_call": {name[:80]: us / calls / 1e3 for name, us in top},
    }), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("trace_serve_torch: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.runtime.steps import make_serve_step

    api, params, tokens = serve.setup(serve.parse_args(
        ["--arch", args.arch, "--no-scaled-down", "--requests", str(args.requests),
         "--prompt-len", str(args.prompt_len), "--seed", str(args.seed)]))
    serve.serve(api, params, tokens, 2)  # warm-up
    S = tokens.shape[1]
    step = make_serve_step(api)

    def prefill():
        logits, cache, _ = api.prefill(params, {"tokens": tokens}, pad_to=S + args.steps)
        return logits[:, -1].argmax(-1).to(torch.int32)[:, None], cache

    def decode(tok, cache):
        for i in range(args.steps):
            tok, cache = step(params, cache, tok, S + i)
        return tok, cache

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = prefill()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode(tok, cache)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tok, cache = prefill()
            torch.cuda.synchronize()
        report("prefill", t1 - t0, device_kernels(prof, torch), 1, torch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            decode(tok, cache)
            torch.cuda.synchronize()
        report("decode_step", (t2 - t1) / args.steps, device_kernels(prof, torch),
               args.steps, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
