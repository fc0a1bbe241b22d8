"""Train, prefill and serve steps, ported from ``repro/runtime/steps.py``.

``train_step`` is the (state, batch) -> (state, metrics) update: loss,
gradients, global-norm clip, AdamW.  PyTorch runs eagerly, so there is no
compile step, and the state is updated in place (``optim/adamw.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.convert import flatten, unflatten
from ..models.registry import ModelApi
from ..optim import OptimizerConfig, adamw_init, adamw_update


def make_train_state(api: ModelApi, opt_cfg: OptimizerConfig,
                     gen: torch.Generator | None = None):
    """{"params", "opt"} on ``api.device``; parameters drawn from ``gen``
    (default: a generator on the device seeded with 0)."""
    if gen is None:
        gen = torch.Generator(api.device).manual_seed(0)
    params = api.init(gen)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def value_and_grad(api: ModelApi, params, batch):
    """(loss, metrics, grads) of ``api.loss`` at ``params``; grads have the
    structure and dtypes of ``params``.  ``params`` themselves record no
    graph: autograd runs on detached aliases of them."""
    leaves = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
    loss, metrics = api.loss(unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(params, dict(zip(leaves, grads)))


def make_train_step(api: ModelApi, opt_cfg: OptimizerConfig,
                    accum_steps: int = 1) -> Callable:
    def train_step(state, batch):
        with torch.profiler.record_function("train_step/loss_and_grad"):
            if accum_steps == 1:
                loss, metrics, grads = value_and_grad(api, state["params"], batch)
            else:
                # gradient accumulation over microbatches (leading split),
                # summed in fp32 as the reference's scan does
                grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for k, p in flatten(state["params"]).items()}
                loss = 0.0
                for i in range(accum_steps):
                    mb = {k: v.reshape((accum_steps, -1) + tuple(v.shape[1:]))[i]
                          for k, v in batch.items()}
                    l, _, g = value_and_grad(api, state["params"], mb)
                    for k, gk in flatten(g).items():
                        grads[k] += gk
                    loss = loss + l
                grads = unflatten(state["params"],
                                  {k: g / accum_steps for k, g in grads.items()})
                loss = loss / accum_steps
                metrics = {}
        with torch.profiler.record_function("train_step/adamw"):
            params, opt, om = adamw_update(state["params"], grads,
                                           state["opt"], opt_cfg)
        metrics = dict(metrics, loss=loss, **om)
        return {"params": params, "opt": opt}, metrics

    return train_step


def make_prefill_step(api: ModelApi, pad_to: int | None = None) -> Callable:
    def prefill_step(params, batch):
        logits, cache, pos = api.prefill(params, batch, pad_to=pad_to)
        return logits, cache

    return prefill_step


def make_serve_step(api: ModelApi, greedy: bool = True) -> Callable:
    """(params, cache, token, pos) -> (next token (B, 1) int32 or logits,
    cache); the cache is updated in place."""
    def serve_step(params, cache, token, pos):
        logits, cache = api.decode(params, cache, token, pos)
        if greedy:
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return nxt[:, None], cache
        return logits, cache

    return serve_step
