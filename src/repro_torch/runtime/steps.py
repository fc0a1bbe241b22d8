"""Prefill and serve steps, ported from ``repro/runtime/steps.py``.

PyTorch runs eagerly, so these wrap the model functions without a
compile step; the training step comes with the training slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.registry import ModelApi


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
