"""Public model API of the port, after ``repro/models/registry.py``.

``build(cfg, device)`` returns a ``ModelApi`` whose functions run on
``device`` (default ``cuda``).  The port builds the dense, MoE, hybrid
(jamba: mamba2 and attention, with MoE) and ``ssm`` (rwkv6) families; the
encoder-decoder and VLM families raise and name their ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import transformer as tf
from .common import ArchConfig

#: families still to port, with the ROADMAP.md item that ports each
PENDING_FAMILIES = {
    "audio": "ROADMAP A11 (encoder-decoder and VLM)",
    "vlm": "ROADMAP A11 (encoder-decoder and VLM)",
}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; ``cuda`` without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for but CUDA is not "
                               "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    device: torch.device
    init: Callable          # generator -> params
    loss: Callable          # (params, batch) -> (loss, metrics)
    prefill: Callable       # (params, batch, pad_to) -> (logits, cache, pos)
    decode: Callable        # (params, cache, token, pos) -> (logits, cache)

    def make_cache(self, batch: int, max_seq: int):
        return tf.make_decode_cache(self.cfg, batch, max_seq, self.device)


def build(cfg: ArchConfig, device="cuda") -> ModelApi:
    if cfg.family in PENDING_FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_id}: family {cfg.family!r} is not ported yet; "
            f"see {PENDING_FAMILIES[cfg.family]}")
    dev = resolve_device(device)

    def init(gen: torch.Generator):
        if gen.device != dev:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        return tf.init_params(gen, cfg)

    def loss(params, batch):
        return tf.loss_fn(params, batch, cfg)

    def prefill(params, batch, pad_to=None):
        return tf.prefill(params, batch, cfg, pad_to=pad_to)

    def decode(params, cache, token, pos):
        return tf.decode_step(params, cache, token, pos, cfg)

    return ModelApi(cfg=cfg, device=dev, init=init, loss=loss,
                    prefill=prefill, decode=decode)
