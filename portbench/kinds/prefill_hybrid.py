"""Prefill traffic on a hybrid Mamba-1 / attention / MoE model (the
``jamba`` model type): the closed loop of ``kinds/prefill.py`` (one client,
a batch of one length at a time, the ladder cycled in a seeded order, the
window ending at a cycle's end) over a model whose weights, reference and
counts are this module's, ``reference/jamba.py`` and ``counts_hybrid.py``.

Set-up builds the program's configuration before anything else: a program
without the hybrid's settings (a Mamba-1 mixer, attention placed in the
block, no RoPE, unrenormalised gates) fails there, at once.  The weights
are drawn from the seed on the device, leaf by leaf (``leaves``, ``draw``),
in the types they are served in, and handed to the program; the check
draws them again and the reference upcasts each where it uses it.

The check samples whole window batches as ``kinds/prefill.py`` does (one of
the longest first) until they hold ``check_requests`` requests, runs the
reference over each and reads two numbers of each request's last-position
logits: ``logit_gap``, the widest gap by which a served first token's logit
lies below the reference's best, and ``logit_err``, the median over the
checked requests of ||l_prog - l_ref|| / ||l_ref - mean(l_ref)||, which a
routing flip at a few positions cannot dominate.  ``logit_gap`` is printed
and not judged: the last position is the last (token, choice) pair of every
expert's queue, so a few earlier tokens routed otherwise in bf16 can move it
across an expert's capacity, and one request's logits then differ from the
reference's by a whole expert's output, which the widest gap over four
requests cannot tell from a fault.  A third number,
``mamba_err``, holds layer 0's Mamba mixer to the
reference's over the longest checked request: a fault of the scan (one
decay row for every channel, a carry lost) moves it at once, where it
reaches the logits only through 16 layers.  With ``stand_in`` set to a
precision, the reference computed in it takes the program's place (the
control).  Only the numbers in ``JUDGED`` are returned for judging.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from .. import counts_hybrid, weights
from ..reference import jamba as ref
from ..reference.model import exact_matmuls
from .common import check_layout
from .prefill import SPARE, Bench as _Prefill

#: spread of the RMSNorm scales and of D about 1
NORM_SPREAD = 0.1
#: the check's numbers that are judged (``limits/<cell>.json``)
JUDGED = ("logit_err", "mamba_err")


def port_config(cfg: dict):
    """The program's ``ArchConfig`` of the hybrid ``cfg``."""
    from repro_torch.models.common import ArchConfig, MoEConfig, SSMConfig

    n = ref.dims(cfg)
    if (cfg["expert_layer_offset"] != cfg["expert_layer_period"] - 1 or not cfg["mamba_conv_bias"]
            or cfg["mamba_proj_bias"] or cfg["hidden_act"] != "silu"):
        raise ValueError("the program's hybrid has experts last in each period of "
                         "expert_layer_period, a conv bias, no projection bias and SiLU")
    return ArchConfig(
        arch_id=cfg["name"], family="hybrid", n_layers=n["L"], d_model=n["d"], n_heads=n["H"],
        n_kv_heads=n["KV"], d_ff=n["f"], vocab_size=n["V"], d_head=n["dh"],
        tie_embeddings=cfg["tie_word_embeddings"], swa_window=cfg["sliding_window"],
        norm_eps=n["eps"], attn_every=n["period"], attn_offset=cfg["attn_layer_offset"],
        use_rope=False,
        moe=MoEConfig(n_experts=n["E"], top_k=n["K"], capacity_factor=cfg["capacity_factor"],
                      moe_every=cfg["expert_layer_period"], router_dtype=cfg["router_dtype"],
                      renormalize=False),
        ssm=SSMConfig(kind="mamba1", d_state=n["N"], expand=cfg["mamba_expand"],
                      d_conv=n["conv"], dt_rank=n["R"]),
        param_dtype=cfg["param_dtype"], compute_dtype=cfg["compute_dtype"], remat="none")


def leaves(cfg: dict) -> list:
    """[(path, shape, dtype name, kind, arg)] of the program's parameter tree
    in drawing order: blocks of ``attn_layer_period`` layers stacked on a
    leading axis, linear weights ``(d_in, d_out)``.  ``kind`` is "normal"
    (mean 0, std ``arg``), "norm" (mean 1, std ``arg``), "a_log" (log(1..N)
    plus a uniform draw of width ``arg`` a channel) or "dt_bias" (softplus
    of it log-uniform in the range ``arg``)."""
    n = ref.dims(cfg)
    d, di, N, R, f, E = n["d"], n["di"], n["N"], n["R"], n["f"], n["E"]
    H, KV, dh, L = n["H"], n["KV"], n["dh"], n["L"]
    nb, pd = L // n["period"], cfg["param_dtype"]
    sd = 1 / math.sqrt(d)
    out = [("embed/table", (n["V"], d), pd, "normal", sd),
           ("final_norm/scale", (d,), pd, "norm", NORM_SPREAD),
           ("lm_head/w", (d, n["V"]), pd, "normal", sd)]
    for j in range(n["period"]):
        mixer, ffn = ref.layer_kind(cfg, j)
        lay = f"blocks/layers/{j}/"
        out += [(lay + "norm1/scale", (nb, d), pd, "norm", NORM_SPREAD),
                (lay + "norm2/scale", (nb, d), pd, "norm", NORM_SPREAD)]
        if mixer == "attn":
            out += [(lay + "attn/wq/w", (nb, d, H * dh), pd, "normal", sd),
                    (lay + "attn/wk/w", (nb, d, KV * dh), pd, "normal", sd),
                    (lay + "attn/wv/w", (nb, d, KV * dh), pd, "normal", sd),
                    (lay + "attn/wo/w", (nb, H * dh, d), pd, "normal",
                     1 / math.sqrt(H * dh * 2 * L))]
        else:
            m = lay + "mamba/"
            out += [(m + "in_proj/w", (nb, d, 2 * di), pd, "normal", sd),
                    (m + "conv_w", (nb, n["conv"], di), pd, "normal", 0.5),
                    (m + "conv_b", (nb, di), pd, "normal", 0.25),
                    (m + "x_proj/w", (nb, di, R + 2 * N), pd, "normal", 1 / math.sqrt(di)),
                    (m + "dt_norm/scale", (nb, R), pd, "norm", NORM_SPREAD),
                    (m + "b_norm/scale", (nb, N), pd, "norm", NORM_SPREAD),
                    (m + "c_norm/scale", (nb, N), pd, "norm", NORM_SPREAD),
                    (m + "dt_proj/w", (nb, R, di), pd, "normal", 1 / math.sqrt(R)),
                    (m + "dt_bias", (nb, di), "float32", "dt_bias", tuple(cfg["dt_range"])),
                    (m + "A_log", (nb, di, N), "float32", "a_log", cfg["a_log_spread"]),
                    (m + "D", (nb, di), "float32", "norm", NORM_SPREAD),
                    (m + "out_proj/w", (nb, di, d), pd, "normal", 1 / math.sqrt(di * 2 * L))]
        wo_std = 1 / math.sqrt(f * 2 * L)
        if ffn == "moe":
            out += [(lay + "moe/router/w", (nb, d, E), cfg["router_dtype"], "normal", sd),
                    (lay + "moe/wi", (nb, E, d, f), pd, "normal", sd),
                    (lay + "moe/wg", (nb, E, d, f), pd, "normal", sd),
                    (lay + "moe/wo", (nb, E, f, d), pd, "normal", wo_std)]
        else:
            out += [(lay + "mlp/wi/w", (nb, d, f), pd, "normal", sd),
                    (lay + "mlp/wg/w", (nb, d, f), pd, "normal", sd),
                    (lay + "mlp/wo/w", (nb, f, d), pd, "normal", wo_std)]
    return out


def draw(torch, cfg: dict, seed: int, device):
    """Yields (path, tensor) of ``leaves(cfg)`` in order, in its served
    type, drawn from one generator on ``device`` seeded with ``seed``: the
    same seed gives the same tensors whenever they are drawn again."""
    gen = torch.Generator(device).manual_seed(seed)
    for path, shape, dt, kind, arg in leaves(cfg):
        dtype = getattr(torch, dt)
        if kind == "a_log":
            spread = torch.rand((*shape[:-1], 1), generator=gen, device=device) - 0.5
            t = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device))
            t = (t + arg * spread).to(dtype)
        elif kind == "dt_bias":
            lo, hi = math.log(arg[0]), math.log(arg[1])
            dt_ = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen, device=device))
            t = (dt_ + torch.log(-torch.expm1(-dt_))).to(dtype)   # softplus(t) = dt_
        else:
            t = torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(arg)
            if kind == "norm":
                t.add_(1.0)
        yield path, t


def mamba_err(torch, w: dict, cfg: dict, tokens, stand_in=None) -> float:
    """||m_prog - m_ref|| / ||m_ref|| of layer 0's Mamba-1 mixer over
    ``tokens`` (B, S), both fed that layer's input (the embedding's RMSNorm,
    the reference's, in the served type; no earlier layer can differ): the
    program's ``mamba1_apply`` on the weights ``w`` as served, against the
    reference's fp32 ``mamba``.  With ``stand_in``, the reference in that
    precision takes the program's place."""
    from repro_torch.models.transformer import mamba1_apply

    if ref.layer_kind(cfg, 0)[0] != "mamba":
        raise ValueError("mamba_err reads layer 0, which must be a Mamba layer")
    p = ref.layer_params(w, cfg, 0)
    h = ref.rmsnorm(w["embed/table"][tokens].float(), p["norm1/scale"].float(),
                    cfg["rms_norm_eps"])
    h = h.to(getattr(torch, cfg["compute_dtype"])).float()
    want = ref.mamba(h, p, cfg, "fp32")
    if stand_in is not None:
        got = ref.mamba(h, p, cfg, stand_in)
    else:
        mixer = weights.tree({k[len("mamba/"):]: t for k, t in p.items()
                              if k.startswith("mamba/")})
        with torch.no_grad():
            got, _ = mamba1_apply(mixer, h.to(getattr(torch, cfg["compute_dtype"])),
                                  port_config(cfg))
    return float((got.float() - want).norm() / want.norm())


class Bench(_Prefill):
    """``kinds/prefill.py``'s loop over the hybrid (see the module)."""

    def setup(self):
        t0 = time.perf_counter()
        arch = port_config(self.cfg)   # first: an older program fails here
        from repro_torch.models.convert import flatten
        from repro_torch.models.registry import build
        from repro_torch.runtime import steps

        self.api = build(arch, self.device)
        flat = dict(draw(self.torch, self.cfg, self.seed, self.device))
        check_layout(flatten(self.api.abstract_params()), flat)
        self.params = weights.tree(flat)
        del flat
        self.prefill = steps.make_prefill_step(self.api)
        t1 = time.perf_counter()
        for j, L in enumerate(self.t["lengths"]):
            self.serve(self.tokens(SPARE + j, L))
        self.phases = {"program import, model, weights": t1 - t0,
                       "warm-up": time.perf_counter() - t1}

    def serve(self, tokens):
        """As ``kinds/prefill.py``'s; the last-position logits are kept in
        ``self.last`` for the check."""
        t0 = time.perf_counter()
        logits, cache = self.prefill(self.params, {"tokens": tokens})
        host = time.perf_counter() - t0
        self.last = logits[:, -1]
        first = self.torch.argmax(self.last, dim=-1)
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        return first, host, time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        B, ladder = self.t["batch"], self.t["lengths"]
        rng = np.random.default_rng(self.seed)
        self.served = []                       # (batch index, length, last logits)
        self.host_s, ttft = [], []
        t0 = time.perf_counter()
        deadline, i = t0 + seconds, 0
        while time.perf_counter() < deadline:
            for L in rng.permutation(ladder):
                _, host, wait = self.serve(self.tokens(i, int(L)))
                self.served.append((i, int(L), self.last))
                self.host_s.append(host)
                ttft += [wait] * B
                i += 1
        self.window_s = time.perf_counter() - t0
        self.attempted = i * B
        lengths = [L for _, L, _ in self.served]
        self.window_flops = sum(counts_hybrid.prefill_flops(self.cfg, B, L) for L in lengths)
        return {"prefill_tok_s": B * sum(lengths) / self.window_s,
                "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3}

    def check(self) -> dict:
        torch = self.torch
        exact_matmuls(torch)
        w = dict(draw(torch, self.cfg, self.seed, self.device))
        widest, errs, self.checked = 0.0, [], 0
        for j in self.sample():
            i, L, got = self.served[j]
            tokens = self.tokens(i, L).long()
            want = ref.last_logits(w, tokens, self.cfg)
            if self.stand_in is not None:
                got = ref.last_logits(w, tokens, self.cfg, self.stand_in)
            got = got.float()
            first = got.argmax(-1)
            gap = want.amax(-1) - want.gather(-1, first[:, None])[:, 0]
            widest = max(widest, float(gap.max()))
            spread = (want - want.mean(-1, keepdim=True)).norm(dim=-1)
            errs += ((got - want).norm(dim=-1) / spread).tolist()
            self.checked += len(first)
        i, L, _ = self.served[self.sample()[0]]          # one of the longest
        readings = {"logit_gap": widest, "logit_err": float(np.median(errs)),
                    "mamba_err": mamba_err(torch, w, self.cfg, self.tokens(i, L).long(),
                                           self.stand_in)}
        for k in readings.keys() - set(JUDGED):
            print(f"{k} {readings[k]!r} (not judged)", file=sys.stderr, flush=True)
        return {k: readings[k] for k in JUDGED}
