"""Training traffic: a closed loop of training steps through
``runtime/steps.py::make_train_step``, fed as ``launch/train.py`` feeds
them: token records written from the seed as raw shard files, read through
``data/pipeline.py::ShardedTokenDataset`` over ``connectors/posix.py``,
each batch a host array copied to the device.

Set-up builds one train state and drives it through ``check_steps`` steps
of the window's own call and feed (rows that all differ), keeping each
step's loss, each leaf's first gradient as the optimizer holds it (the
first moment after one step over 1 - b1) and each leaf's change over those
steps; the window then trains the same state on.  The check runs the
reference over the same weights and rows and compares the three.
"""

from __future__ import annotations

import math
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import counts, weights
from ..profiling import Trace
from ..reference import model as ref
from .common import check_layout, port_config

#: records a shard file holds
RECORDS_PER_SHARD = 64
#: leaves whose first reference gradient is below this share of the median
#: leaf's move by round-off alone and are left out of the change
STILL_LEAF = 1e-3
#: faults a training step can have, planted in the reference: half of the
#: batch left out (the mean over the rest), the labels one token off
FAULTS = ("half_batch", "labels_off_by_one")


class Bench:
    #: a precision of the reference whose readings the check judges in place
    #: of the program's (the control); None judges the program
    stand_in = None

    def __init__(self, c, seed: int, device):
        import torch

        self.torch, self.c, self.seed, self.device = torch, c, seed, device
        self.cfg, self.t = c.cfg, c.traffic
        self.attempted = self.failed = 0
        self.rows = np.random.default_rng(seed).integers(
            0, self.cfg["vocab_size"], (self.t["records"], self.t["seq_len"]), dtype=np.int32)

    def setup(self):
        t0 = time.perf_counter()
        from repro_torch.connectors.posix import PosixConnector
        from repro_torch.data.pipeline import DataPipelineConfig, ShardedTokenDataset
        from repro_torch.models.convert import flatten
        from repro_torch.models.registry import build
        from repro_torch.optim import OptimizerConfig, adamw_init
        from repro_torch.runtime import steps

        torch = self.torch
        B, S = self.t["batch"], self.t["seq_len"]
        self.tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
        (self.tmp / "corpus").mkdir()
        for i in range(0, len(self.rows), RECORDS_PER_SHARD):
            (self.tmp / "corpus" / f"shard_{i // RECORDS_PER_SHARD:05d}.bin").write_bytes(
                self.rows[i:i + RECORDS_PER_SHARD].tobytes())
        ds = ShardedTokenDataset(PosixConnector(str(self.tmp)), "corpus",
                                 DataPipelineConfig(seq_len=S, batch_size=B))
        self.batches = ds.prefetching_batches()

        self.api = build(port_config(self.cfg), self.device)
        flat = dict(weights.draw(torch, self.cfg, self.seed, self.device))
        check_layout(flatten(self.api.abstract_params()), flat)
        params = weights.tree(flat)
        del flat
        self.opt = OptimizerConfig(**self.t["optimizer"])
        self.state = {"params": params, "opt": adamw_init(params, self.opt)}
        self.step_fn = steps.make_train_step(self.api, self.opt)
        t1 = time.perf_counter()

        self.losses = []
        for i in range(self.t["check_steps"]):
            self.losses.append(self.one_step())
            if i == 0:
                # the first gradient as the optimizer holds it, kept on the host
                m = flatten(self.state["opt"]["m"])
                self.grads = {k: (t / (1 - self.opt.b1)).to(torch.bfloat16).cpu()
                              for k, t in m.items()}
                self.grad_norms = {k: float(torch.linalg.vector_norm(t.float()))
                                   / (1 - self.opt.b1) for k, t in m.items()}
        t2 = time.perf_counter()
        now = flatten(self.state["params"])
        self.change_norms = {
            k: float(torch.linalg.vector_norm(now[k].float() - start.float()))
            for k, start in weights.draw(torch, self.cfg, self.seed, self.device)}
        self.phases = {"program import, corpus, model, weights, state": t1 - t0,
                       "checked steps": t2 - t1, "change norms": time.perf_counter() - t2}

    def one_step(self) -> float:
        torch = self.torch
        batch = {k: torch.tensor(v, device=self.device) for k, v in next(self.batches).items()}
        self.state, metrics = self.step_fn(self.state, batch)
        return float(metrics["loss"])

    def window(self, seconds: float) -> dict:
        B, S = self.t["batch"], self.t["seq_len"]
        t0 = time.perf_counter()
        deadline, n = t0 + seconds, 0
        while True:
            loss = self.one_step()
            n += 1
            self.failed += not math.isfinite(loss)
            if time.perf_counter() >= deadline:
                break
        self.window_s = time.perf_counter() - t0
        self.attempted, self.steps = n, n
        self.window_flops = n * counts.train_flops(self.cfg, B, S)
        return {"train_tok_s": n * B * S / self.window_s}

    def profile(self) -> Trace:
        n = self.t["profile_steps"]
        tr = Trace.capture(self.torch, [self.one_step] * n)
        self.traced_calls = [(self.t["batch"], self.t["seq_len"])] * n
        return tr

    def release(self):
        self.batches.close()
        del self.state, self.step_fn, self.api
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, precision="fp32", fault=None) -> dict:
        """The reference's three readings over the same weights and rows;
        with ``fault``, of a broken step (``FAULTS``)."""
        torch = self.torch
        ref.exact_matmuls(torch)
        B, S = self.t["batch"], self.t["seq_len"]
        w = dict(weights.draw(torch, self.cfg, self.seed, self.device, dtype=torch.float32))
        dtypes = {p: getattr(torch, dt) for p, _, dt, _, _ in weights.leaves(self.cfg)}
        batches = []
        for i in range(self.t["check_steps"]):
            rows = torch.tensor(self.rows[i * B:(i + 1) * B], device=self.device).long()
            labels = torch.cat([rows[:, 1:], torch.full((B, 1), -1, device=self.device)], 1)
            if fault == "half_batch":
                rows, labels = rows[: B // 2], labels[: B // 2]
            elif fault == "labels_off_by_one":
                labels = labels.roll(1, dims=1)
            batches.append((rows, labels))
        return ref.train(w, batches, self.cfg, self.t["optimizer"], dtypes, precision)

    def check(self) -> dict:
        shutil.rmtree(self.tmp, ignore_errors=True)
        got = ({"losses": self.losses, "grads": self.grads, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms} if self.stand_in is None
               else self.reference(self.stand_in))
        self.want = self.reference()
        return compare(got, self.want)

    def faults(self) -> dict:
        """The check's numbers with the reference broken by each of
        ``FAULTS`` in the program's place (after ``check``)."""
        return {fault: compare(self.reference(fault=fault), self.want) for fault in FAULTS}


def worst_leaf(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    keys = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def grad_errors(prog: dict, want: dict) -> dict:
    """Each leaf's norm of the difference between the two first gradients."""
    return {k: float((prog["grads"][k].to(g.device, g.dtype) - g).norm())
            for k, g in want["grads"].items()}


def compare(prog: dict, want: dict) -> dict:
    """``loss_gap``: the widest relative gap of a step's loss; ``grad_gap``
    and ``change_gap``: ``worst_leaf`` of the first gradient's and of the
    change's norms, the change over the leaves the reference's first
    gradient moves (``STILL_LEAF``); ``grad_err``: the worst leaf's norm of
    the first gradients' difference, over the reference's norm of that
    leaf or of the median leaf.  The norms' gaps average rounding away
    (an fp8 reference reads about what the bf16 program does); the
    difference keeps it."""
    g = want["grad_norms"]
    med = statistics.median(g.values())
    moved = {k for k, v in g.items() if v >= STILL_LEAF * med}
    err = grad_errors(prog, want)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"])),
            "grad_gap": worst_leaf(prog["grad_norms"], g),
            "change_gap": worst_leaf(prog["change_norms"], want["change_norms"], moved),
            "grad_err": max(e / max(g[k], med) for k, e in err.items())}
