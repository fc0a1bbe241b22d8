"""AdamW with a configurable state-dtype policy, ported from
``repro/optim/adamw.py``.

The reference's update is functional.  Here ``adamw_update`` writes the
new parameters, moments and step counter into the given tensors in place
(it saves a second copy of the state in device memory) and returns the
same trees.  A caller that must keep a state, such as a checkpoint
snapshot, copies it before the next update.  The update math is the
reference's: fp32 bias correction, the ``1e-9`` floor of the global-norm
clip, weight decay inside the update, and moments kept in
``cfg.state_dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.convert import flatten, unflatten
from .schedule import cosine_schedule


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "bfloat16"   # bf16 moments at production scale


def _map(fn, tree):
    return unflatten(tree, {k: fn(v) for k, v in flatten(tree).items()})


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in flatten(tree).values()))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def adamw_init(params, cfg: OptimizerConfig):
    """Zero moments in ``cfg.state_dtype``, each in its parameter's layout
    (a ``DTensor`` parameter's moments take its placements), and a step
    counter beside the first parameter."""
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt, memory_format=torch.contiguous_format)
    device = next(iter(flatten(params).values())).device
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: OptimizerConfig, lr=None):
    """One AdamW step, in place (see the module docstring).  Returns
    (params, opt_state, {"grad_norm", "lr"})."""
    opt_state["step"].add_(1)
    step = opt_state["step"]
    if lr is None:
        lr = cosine_schedule(step, peak_lr=cfg.peak_lr,
                             warmup_steps=cfg.warmup_steps,
                             total_steps=cfg.total_steps)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    # bias correction in fp32
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(*(flatten(t).values() for t in (
            params, grads, opt_state["m"], opt_state["v"]))):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        mhat = m32 / c1
        vhat = v32 / c2
        p32 = p.float()
        p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * p32)
        p.copy_(p32)
        m.copy_(m32)
        v.copy_(v32)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
