#!/usr/bin/env python3
"""Where the flash-attention backward kernel's time goes, on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/flash_bwd_ablation_torch.py [--calls 30] [--rounds 3]

Builds the backward kernels of ``src/repro_torch/kernels/flash_attention/
csrc/flash_attention.cu`` as they are (``full``) and changed copies of the
source, one ``nvcc`` each, all at once, each without one step of the main
kernel's (``attn_bwd_main``) loop over q tiles:

* ``no_atomics``: the partial dQ is not added to the fp32 accumulator in
  device memory (a store the compiler cannot drop stands in for the adds);
* ``no_dq``: no dQ = dS K product and no adds;
* ``no_exp``: P = the scaled score minus the lse, without ``ex2``;
* ``no_bar``: the consumer warpgroups do not wait for each other's dS
  before the dQ product.

Only ``full`` computes the gradients: it is held against the plain
backward (``ops.plain_backward``) within ``chip_smoke.py``'s BWD_REL_L2 on
every shape; the changed copies exist to be timed.  Each runs through the
wrapper (``kernel.load_variant``) and is timed by the device time per
backward of its three kernels (``attn_bwd_`` in the name: prep, main, dQ
pass), which torch.profiler takes over ``--calls`` calls after a warm-up;
``--rounds`` rounds alternate the variants' order so that drift of the
clock falls on all alike.  Shapes: granite-moe's training step (B2 S4096,
16 / 8 heads of 64: the 64-wide instance) and a dense one at dh 128 (B2
S2048, 32 / 8 heads: the 128-wide instance), causal.  Prints the card's
name and power limit, then one JSON line a shape with each variant's
median ms.  Exits non-zero without CUDA or when ``full`` disagrees with
the plain backward.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

from flash_ablation_torch import build, smi  # noqa: E402

#: B, S, H, KV, dh (causal, no window)
SHAPES = [(2, 4096, 16, 8, 64), (2, 2048, 32, 8, 128)]
KERNELS = "attn_bwd_"  # the kernels whose records are timed
#: runs of a profile that lost kernel records before the script fails
PROFILE_TRIES = 5
#: chip_smoke.py's limit: relative L2 error of each gradient against the
#: plain backward's
BWD_REL_L2 = 1e-2

#: variant -> [(pattern, replacement, matches the source must have)]
EDITS = {
    "no_atomics": [
        (r"atomicAdd\(reinterpret_cast<float2\*>\(dst \+ 8 \* n\), "
         r"make_float2\(acc\[4 \* n\], acc\[4 \* n \+ 1\]\)\);",
         "if (acc[4 * n] == 12345.f) dst[0] = acc[4 * n + 1];", 1),
        (r"atomicAdd\(reinterpret_cast<float2\*>\(dst \+ 8 \* 64 \* DH2 \+ 8 \* n\),\s*"
         r"make_float2\(acc\[4 \* n \+ 2\], acc\[4 \* n \+ 3\]\)\);",
         "if (acc[4 * n + 2] == 12345.f) dst[1] = acc[4 * n + 3];", 1)],
    "no_dq": [(r"if \(DH2 == 2 \|\| \(it & 1\) == cw\) \{", "if (false) {", 1)],
    "no_exp": [(r": exp2_ftz\(e\);", ": e;", 1)],
    "no_bar": [(r"bar_sync\(1, 256\);  // both", "if (false) bar_sync(1, 256);  // both", 1)],
}


def variants(src: str) -> dict[str, str]:
    """The kernel source and its changed copies.  Fails if the source no
    longer has the statements a variant changes, as often as it expects."""
    out = {"full": src}
    for name, edits in EDITS.items():
        text = src
        for pat, repl, want in edits:
            text, n = re.subn(pat, repl, text)
            if n != want:
                raise SystemExit(f"flash_bwd_ablation: {name}: {pat!r} matches {n} times, "
                                 f"want {want}")
        out[name] = text
    return out


def device_ms(torch, call, calls: int) -> float:
    """Mean device ms per call of the KERNELS over ``calls`` calls, from
    torch.profiler's kernel records; a profile that lost records is run
    again."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA and KERNELS in ev.name]
        if len(us) == 3 * calls:
            return sum(us) / 1e3 / calls
    raise SystemExit(f"flash_bwd_ablation: {len(us)} {KERNELS} records of {calls} calls "
                     f"in {PROFILE_TRIES} profiles")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ablation: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ops import plain_backward

    card = smi("name,power.limit")
    print(card, flush=True)
    build_dir = _build.BUILD_DIR / "ablation"
    build_dir.mkdir(parents=True, exist_ok=True)
    texts = variants((_build.PKG_DIR / kernel.SOURCE).read_text())
    with ThreadPoolExecutor(len(texts)) as pool:  # one nvcc per variant
        libs = dict(zip(texts, pool.map(lambda kv: build(*kv, build_dir), texts.items())))
    dev = torch.device("cuda", 0)
    failed = []
    for B, S, H, KV, dh in SHAPES:
        gen = torch.Generator(dev).manual_seed(0)
        q, k, v, do = (torch.randn(B, S, n, dh, generator=gen, device=dev).bfloat16()
                       for n in (H, KV, KV, H))
        kernel.load_variant(libs["full"])
        o, lse = kernel.flash_attention_fwd(q, k, v, causal=True, window=None, with_lse=True)
        call = lambda: kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=None)
        want = plain_backward(q, k, v, do, causal=True, window=None, chunk=min(1024, S))
        rel = [float((g.float() - w.float()).norm() / w.float().norm())
               for g, w in zip(call(), want)]
        if not max(rel) <= BWD_REL_L2:
            failed.append((B, S, dh, rel))
        del want
        ms = {name: [] for name in libs}
        order = list(libs)
        for r in range(args.rounds):
            for name in order if r % 2 == 0 else order[::-1]:
                kernel.load_variant(libs[name])
                ms[name].append(device_ms(torch, call, args.calls))
        kernel.load_variant(None)
        print(json.dumps({"B": B, "S": S, "H": H, "KV": KV, "dh": dh, "card": card,
                          "full_rel_l2_dq_dk_dv": rel, "round_ms": ms,
                          "ms": {n: statistics.median(t) for n, t in ms.items()}}), flush=True)
        del q, k, v, do, o, lse
    if failed:
        print(f"flash_bwd_ablation: the kernel disagrees with the plain backward "
              f"(B, S, dh, relative L2 of dq, dk, dv): {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
