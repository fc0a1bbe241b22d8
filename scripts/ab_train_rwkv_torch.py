#!/usr/bin/env python3
"""Times chip_smoke.py's rwkv6 training phase on two trees in turns, on one
NVIDIA GPU, with a host-side probe of each warm step.

    git archive <parent commit> | tar -x -C build/parent
    python3 scripts/ab_train_rwkv_torch.py --parent build/parent [--order pcsscppc]

Runs ``chip_smoke.train_rwkv`` (full-width rwkv6-7b cut to 2 layers, 2 x
2048 tokens a step: a step's numerics, 3 steps of ``run_training``, 12 warm
steps timed one by one, one profiled step) in a fresh process for each
letter of ``--order``: ``p`` from the tree under ``--parent``, ``c`` from
this one, ``s`` from this one with the sharding layer's calls on the
model's path (``logical_constraint`` in the model modules) made the
identity without a lookup of the rules.  Each process builds its tree's
kernels first (into that tree's git-ignored ``build/``).

The warm steps are timed by this script (``chip_smoke.wall_ms`` swapped for
a probe): each step's host wall up to the return of the step function (the
enqueue) and to the device synchronise, with the CPU time the main thread
and the whole process (autograd runs the backward on a thread of its own,
and CUDA keeps threads of its own) spent over the step; the garbage collector's
time in the warm steps (``gc.callbacks``); and the last of the 12 steps
under ``cProfile``, whose Python call counts are read and whose wall is
left out of the median (11 steps).  Equal call counts and CPU time with
unequal walls point at the host's load, not at the code.

The phase is host-bound, so its step time follows the host's clock more
than the card: compare trees only within one call, in turns.  Prints the
card's name and power limit, then one JSON line per run: the median warm
step, each warm step, tokens/s, the profiled step's device busy ms, idle
share and kernel launches, and the probe's ``host`` dict.  Exits non-zero
without CUDA or when a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r'''
import cProfile, gc, json, os, pstats, statistics, sys, time
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
import torch
sys.path.insert(0, cs.SRC)
if os.environ.get("AB_STUB") == "1":
    from repro_torch.models import layers, ssm as ssm_model, transformer
    for mod in (layers, ssm_model, transformer):
        mod.logical_constraint = lambda x, *axes: x
host = {}
gc_t = {"s": 0.0, "n": 0, "t0": 0.0}


def on_gc(phase, info):
    if phase == "start":
        gc_t["t0"] = time.perf_counter()
    else:
        gc_t["s"] += time.perf_counter() - gc_t["t0"]
        gc_t["n"] += 1


def probe_wall_ms(torch, fn, reps):
    enq_wall, enq_cpu, walls, proc_cpu = [], [], [], []
    gc.callbacks.append(on_gc)
    for _ in range(reps - 1):
        c0, p0, t0 = time.thread_time(), time.process_time(), time.perf_counter()
        fn()
        c1, t1 = time.thread_time(), time.perf_counter()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        proc_cpu.append((time.process_time() - p0) * 1e3)
        enq_wall.append((t1 - t0) * 1e3)
        enq_cpu.append((c1 - c0) * 1e3)
    gc.callbacks.remove(on_gc)
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    host.update({
        "enqueue_wall_ms": enq_wall, "enqueue_cpu_ms": enq_cpu,
        "median_enqueue_wall_ms": statistics.median(enq_wall),
        "median_enqueue_cpu_ms": statistics.median(enq_cpu),
        "process_cpu_ms": proc_cpu, "median_process_cpu_ms": statistics.median(proc_cpu),
        "median_step_wall_ms": statistics.median(walls),
        "gc_ms_per_step": gc_t["s"] * 1e3 / len(walls), "gc_collections": gc_t["n"],
        "python_calls_per_step": sum(v[1] for v in stats.values()),
        "repro_torch_calls_per_step": sum(v[1] for k, v in stats.items()
                                          if "repro_torch" in k[0]),
        "sharding_calls_per_step": {f"{k[2]}": v[1] for k, v in stats.items()
                                    if "sharding" in k[0]},
        "gc_objects": len(gc.get_objects()), "modules": len(sys.modules)})
    return walls


cs.wall_ms = probe_wall_ms
from repro_torch.kernels import _build
from repro_torch.kernels.checksum import kernel as cs_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan import ops as ssm_ops, ref as ssm_ref
from repro_torch.launch import train as launch_train
torch.backends.cuda.matmul.allow_tf32 = False
with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
    list(pool.map(_build.build, _build.SOURCES))
_, _, row = cs.train_rwkv(torch, launch_train, (fa_kernel, cs_kernel, ssm_kernel), ssm_ops,
                          ssm_ref, torch.device("cuda", 0))
print("ROW " + json.dumps({
    "median_step_s": row["median_step_s"], "warm_step_s": row["warm_step_s"],
    "tokens_per_s": row["tokens_per_s"], "device_busy_ms": row["profile"]["device_busy_ms"],
    "idle_share": row["profile"]["idle_share"],
    "kernel_launches": row["profile"]["kernel_launches"], "host": host}), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the other tree's root")
    ap.add_argument("--order", default="pccp",
                    help="p: the parent tree, c: this one, s: this one with the model's "
                         "logical_constraint calls stubbed")
    args = ap.parse_args()
    trees = {"p": os.path.abspath(args.parent), "c": ROOT, "s": ROOT}
    names = {"p": "parent", "c": "change", "s": "change_stubbed"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    for i, which in enumerate(args.order):
        t0 = time.perf_counter()
        env = {**os.environ, "AB_STUB": "1" if which == "s" else "0"}
        out = subprocess.run([sys.executable, "-c", RUN], cwd=trees[which], capture_output=True,
                             text=True, timeout=900, env=env)
        rows = [ln[4:] for ln in out.stdout.splitlines() if ln.startswith("ROW ")]
        if out.returncode != 0 or not rows:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps({"run": i, "tree": names[which],
                          "process_s": time.perf_counter() - t0, **json.loads(rows[0])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
