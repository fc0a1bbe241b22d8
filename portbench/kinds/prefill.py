"""Prefill traffic: a closed loop in which one client submits a batch of
``batch`` prompts of one length and waits for their first tokens: the
prefill through ``runtime/steps.py::make_prefill_step``, the argmax of
each prompt's last logits, a synchronise.  The lengths cycle through the
mix's ladder, each cycle in an order drawn from the seed, and the window
ends at the end of a cycle, so every run serves the same mix.  A batch's
token ids are drawn on the device from the seed and its index.

Set-up warms one batch of each length of the ladder.  The check samples
whole batches of the window's, drawn from the seed (one of the longest
always among them), until they hold ``check_requests`` requests, runs the
reference over each, and reads the widest gap by which a served token's
logit lies below the reference's best.  With ``stand_in`` set to a
precision, the reference computed in it is put in the program's place: its
first tokens on the same sampled batches are judged by the same check (the
control).
"""

from __future__ import annotations

import time

import numpy as np

from .. import counts, weights
from ..profiling import Trace
from ..reference import model as ref
from .common import check_layout, port_config

#: batch indices of the warm-up and the profiled stretch start here, past
#: any window's
SPARE = 1 << 30


def batch_seed(seed: int, i: int) -> int:
    return (seed * 1_000_003 + i) % (1 << 63)


class Bench:
    #: a precision of the reference whose first tokens the check judges in
    #: place of the program's (the control); None judges the program
    stand_in = None

    def __init__(self, c, seed: int, device):
        import torch

        self.torch, self.c, self.seed, self.device = torch, c, seed, device
        self.cfg, self.t = c.cfg, c.traffic
        self.attempted = self.failed = 0

    def setup(self):
        t0 = time.perf_counter()
        from repro_torch.models.convert import flatten
        from repro_torch.models.registry import build
        from repro_torch.runtime import steps

        torch = self.torch
        self.api = build(port_config(self.cfg), self.device)
        flat = dict(weights.draw(torch, self.cfg, self.seed, self.device))
        check_layout(flatten(self.api.abstract_params()), flat)
        self.params = weights.tree(flat)
        del flat
        self.prefill = steps.make_prefill_step(self.api)
        t1 = time.perf_counter()
        for j, L in enumerate(self.t["lengths"]):
            self.serve(self.tokens(SPARE + j, L))
        self.phases = {"program import, model, weights": t1 - t0, "warm-up": time.perf_counter() - t1}

    def tokens(self, i: int, L: int):
        torch = self.torch
        gen = torch.Generator(self.device).manual_seed(batch_seed(self.seed, i))
        return torch.randint(0, self.cfg["vocab_size"], (self.t["batch"], L), generator=gen,
                             device=self.device)

    def serve(self, tokens):
        """(first tokens (B,), host seconds into the prefill step, seconds
        to the first tokens on the host)."""
        t0 = time.perf_counter()
        logits, cache = self.prefill(self.params, {"tokens": tokens})
        host = time.perf_counter() - t0
        first = self.torch.argmax(logits[:, -1], dim=-1)
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        return first, host, time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        B, ladder = self.t["batch"], self.t["lengths"]
        rng = np.random.default_rng(self.seed)
        self.served = []                       # (batch index, length, first tokens)
        self.host_s, ttft = [], []
        t0 = time.perf_counter()
        deadline, i = t0 + seconds, 0
        while time.perf_counter() < deadline:
            for L in rng.permutation(ladder):
                tokens = self.tokens(i, int(L))
                first, host, wait = self.serve(tokens)
                self.served.append((i, int(L), first))
                self.host_s.append(host)
                ttft += [wait] * B
                i += 1
        self.window_s = time.perf_counter() - t0
        self.attempted = i * B
        lengths = [L for _, L, _ in self.served]
        self.window_flops = sum(counts.prefill_flops(self.cfg, B, L) for L in lengths)
        return {"prefill_tok_s": B * sum(lengths) / self.window_s,
                "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3}

    def profile(self) -> Trace:
        ladder = self.t["lengths"]
        batches = [self.tokens(SPARE + len(ladder) + j, L) for j, L in enumerate(ladder)]
        tr = Trace.capture(self.torch, [lambda t=t: self.serve(t) for t in batches])
        self.traced_calls = [(self.t["batch"], L) for L in ladder]
        return tr

    def release(self):
        del self.params, self.prefill, self.api
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def sample(self) -> list:
        """Indices of whole window batches, drawn from the seed, one of the
        longest first, until they hold ``check_requests`` requests."""
        rng = np.random.default_rng([self.seed, 1])
        longest = max(L for _, L, _ in self.served)
        tops = [j for j, (_, L, _) in enumerate(self.served) if L == longest]
        first = int(rng.choice(tops))
        rest = [int(j) for j in rng.permutation(len(self.served)) if j != first]
        n = -(-self.t["check_requests"] // self.t["batch"])
        return [first] + rest[: n - 1]

    def check(self) -> dict:
        torch = self.torch
        ref.exact_matmuls(torch)
        w = dict(weights.draw(torch, self.cfg, self.seed, self.device, dtype=torch.float32))
        widest, self.checked = 0.0, 0
        for j in self.sample():
            i, L, first = self.served[j]
            tokens = self.tokens(i, L).long()
            logits = ref.last_logits(w, tokens, self.cfg)
            if self.stand_in is not None:
                first = ref.last_logits(w, tokens, self.cfg, self.stand_in).argmax(-1)
            gap = logits.amax(-1) - logits.gather(-1, first.long()[:, None])[:, 0]
            widest = max(widest, float(gap.max()))
            self.checked += len(first)
        return {"logit_gap": widest}
