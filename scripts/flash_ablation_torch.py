#!/usr/bin/env python3
"""Where the bf16 flash-attention kernel's time goes, and what each of its
design steps is worth, on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/flash_ablation_torch.py [--calls 200] [--rounds 2]
        [--source NAME=PATH ...]

Builds the TMA / wgmma kernel of ``src/repro_torch/kernels/flash_attention/
csrc/flash_attention.cu`` as it is (``full``) and changed copies of it, one
``nvcc`` each, all at once:

* ``exp2f``: ``exp2f`` in place of ``ex2.approx.ftz``;
* ``one_chain``: the softmax's maxima and sums as one chain a row, not four;
* ``no_pingpong``: the two consumer warpgroups issue their products
  without taking turns on named barriers;
* ``box_past_dh``: the second 64-column box runs to column 128 (TMA fills
  the columns past dh with zeros), not to dh;
* ``grid_per_item``: one block per (q tile, head, batch) item, not one
  persistent block per SM;
* ``no_softmax``: without the online softmax (P is the raw scores);
* ``loads_only``: without the softmax and both wgmma products, so what is
  left is the TMA ring, the barriers and the epilogue;

and any whole source given with ``--source NAME=PATH`` (a copy of the
kernel source under the git-ignored ``build/``, say).  The first five
changed copies take one design step back each.  They, ``full`` and the
``--source`` ones compute attention, so each is held against the plain
chunked version at ``chip_smoke.py``'s limit on every shape; ``no_softmax``
and ``loads_only`` exist to be timed.  Each variant runs
through the wrapper (``kernel.load_variant``) and is timed by the device
time per call of its ``attn_fwd_bf16_tma`` kernel records, which
torch.profiler takes over ``--calls`` calls after a warm-up (a loop timed
by CUDA events would time the wrapper's enqueue at the smallest shape);
``--rounds`` rounds alternate the variants' order (forwards, backwards,
...) so that drift of the clock falls on all alike.  Shapes: the main-path shapes of ``chip_smoke.py`` (head dim
120) and the training step's at head dims 128 and 64.  Prints the card's
name and power limit, then one JSON line per variant and shape with the SM
clock and power draw under load.  Exits non-zero without CUDA or when a
variant that computes attention disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: B, S, H, KV, dh (causal, window 4096): the main-path shapes, then the
#: training step's at aligned head dims
SHAPES = [(4, 512, 32, 8, 120), (1, 5120, 32, 8, 120), (2, 2048, 32, 8, 120),
          (2, 2048, 32, 8, 128), (2, 2048, 32, 8, 64)]
WINDOW = 4096
KERNEL = "attn_fwd_bf16_tma"  # the kernel whose records are timed
#: runs of a profile that lost kernel records before the script fails
PROFILE_TRIES = 5
#: chip_smoke.py's bf16 limit on its main shapes: |err| <= TOL * (mean |want|
#: of the row + |want|)
TOL = 2e-2

#: variant -> [(pattern, replacement, matches the source must have)]; the
#: first five compute attention
EDITS = {
    "exp2f": [(r"exp2_ftz\(fmaf\(", "exp2f(fmaf(", 4)],
    "one_chain": [(r"\[n % 4\]", "[0]", 6)],
    "no_pingpong": [(r"bar_sync\(3 \+ cw, 256\);", ";", 3),
                    (r"bar_arrive\(4 - cw, 256\);", ";", 3),
                    (r"if \(cw == 1\) bar_arrive\(3, 256\);", ";", 1)],
    "box_past_dh": [(r"p\.col2 = dh > 64 && dh < 128 \? dh - 64 : 64;", "p.col2 = 64;", 1)],
    "grid_per_item": [(r"n_items < sms \? n_items : sms", "n_items", 1)],
    "no_softmax": [(r"online_softmax\([^;{]*\);", ";", 2)],
    "loads_only": [(r"online_softmax\([^;{]*\);", ";", 2), (r"wgmma_ss\(sc,[^;]*;", ";", 1),
                   (r"wgmma_rs\(o,[^;]*;", ";", 1)],
}
TIMED_ONLY = {"no_softmax", "loads_only"}


def variants(src: str) -> dict[str, str]:
    """The kernel source and its changed copies.  Fails if the source no
    longer has the statements a variant changes, as often as it expects."""
    out = {"full": src}
    for name, edits in EDITS.items():
        text = src
        for pat, repl, want in edits:
            text, n = re.subn(pat, repl, text)
            if n != want:
                raise SystemExit(f"flash_ablation: {name}: {pat!r} matches {n} times, "
                                 f"want {want}")
        out[name] = text
    return out


def build(name: str, text: str, build_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    src, lib = build_dir / f"{name}-{digest}.cu", build_dir / f"{name}-{digest}.so"
    if not lib.exists():
        src.write_text(text)
        proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the {name} variant:\n{proc.stdout}")
    return ctypes.CDLL(str(lib))


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def device_ms(torch, call, calls: int) -> float:
    """Mean device ms of KERNEL per call over ``calls`` calls, from
    torch.profiler's kernel records; a profile that lost records is run
    again."""
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA and KERNEL in ev.name]
        if len(us) == calls:
            return sum(us) / 1e3 / calls
    raise SystemExit(f"flash_ablation: {len(us)} {KERNEL} records of {calls} calls "
                     f"in {PROFILE_TRIES} profiles")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                    help="also build and time this whole kernel source")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_ablation: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel, ref

    card = smi("name,power.limit")
    print(card, flush=True)
    build_dir = _build.BUILD_DIR / "ablation"
    build_dir.mkdir(parents=True, exist_ok=True)
    texts = variants((_build.PKG_DIR / kernel.SOURCE).read_text())
    for spec in args.source:
        name, _, path = spec.partition("=")
        texts[name] = Path(path).read_text()
    with ThreadPoolExecutor(len(texts)) as pool:  # one nvcc per variant
        libs = dict(zip(texts, pool.map(lambda kv: build(*kv, build_dir), texts.items())))
    dev = torch.device("cuda", 0)
    failed = []
    for B, S, H, KV, dh in SHAPES:
        gen = torch.Generator(dev).manual_seed(0)
        q, k, v = (torch.randn(B, S, n, dh, generator=gen, device=dev).bfloat16()
                   for n in (H, KV, KV))
        call = lambda: kernel.flash_attention_fwd(q, k, v, causal=True, window=WINDOW)
        want = ref.chunked_attention(q, k, v, causal=True, window=WINDOW).float()
        limit = TOL * (want.abs().mean(dim=-1, keepdim=True) + want.abs())
        rows = {name: {"variant": name, "B": B, "S": S, "H": H, "KV": KV, "dh": dh,
                       "window": WINDOW, "round_ms": []} for name in libs}
        for name, lib in libs.items():
            if name in TIMED_ONLY:
                continue
            kernel.load_variant(lib)
            before = kernel.tma_launches
            err_share = ((call().float() - want).abs() / limit).max().item()
            torch.cuda.synchronize()
            rows[name]["max_err_share_of_limit"] = err_share
            if kernel.tma_launches != before + 1 or not err_share <= 1.0:
                failed.append((name, B, S, dh, err_share))
        del want, limit
        order = list(libs)
        for r in range(args.rounds):
            for name in order if r % 2 == 0 else order[::-1]:
                kernel.load_variant(libs[name])
                rows[name]["round_ms"].append(device_ms(torch, call, args.calls))
        for name, lib in libs.items():
            kernel.load_variant(lib)
            for _ in range(int(200 / rows[name]["round_ms"][0])):  # ~0.2 s to read the clock
                call()
            rows[name]["clocks_sm_power_draw"] = smi("clocks.sm,power.draw")
            torch.cuda.synchronize()
            rows[name]["ms"] = statistics.median(rows[name]["round_ms"])
            print(json.dumps({**rows[name], "card": card}), flush=True)
        kernel.load_variant(None)
        del q, k, v
    if failed:
        print(f"flash_ablation: variants that disagree with the plain version "
              f"(name, B, S, dh, error share of the limit): {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
