"""Public model API of the port, after ``repro/models/registry.py``.

``build(cfg, device)`` returns a ``ModelApi`` whose functions run on
``device`` (default ``cuda``), for every family of the reference: dense,
MoE, hybrid (jamba: mamba2 and attention, with MoE), ``ssm`` (rwkv6),
``audio`` (whisper: an encoder and cross-attention; its batches carry
``audio_embeds``) and ``vlm`` (llava: its prefill batches carry
``image_embeds``).  ``train_batch_specs``, ``prefill_batch_specs``,
``decode_specs`` and ``input_specs`` give a cell's inputs as ``meta``
tensors (the reference's ``ShapeDtypeStruct``s): shapes and dtypes, no
storage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import transformer as tf
from .common import SHAPES, ArchConfig, ShapeConfig
from .layers import MetaInit

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

    def abstract_params(self):
        """The parameter tree on ``meta``: every leaf's shape and dtype."""
        return tf.init_params(MetaInit(), self.cfg)

    def make_cache(self, batch: int, max_seq: int, enc_len: int | None = None,
                   abstract: bool = False):
        return tf.make_decode_cache(self.cfg, batch, max_seq,
                                    "meta" if abstract else self.device,
                                    enc_len=enc_len)


def build(cfg: ArchConfig, device="cuda") -> ModelApi:
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


# ---------------------------------------------------------------------------
# input specs per (arch, shape) cell: meta tensors, no allocation
# ---------------------------------------------------------------------------
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((B, S), torch.int32),
             "labels": _meta((B, S), torch.int32)}
    dt = getattr(torch, cfg.compute_dtype)
    if cfg.is_encdec:
        specs["audio_embeds"] = _meta((B, cfg.encdec.n_audio_ctx, cfg.d_model), dt)
    if cfg.vlm is not None:
        specs["image_embeds"] = _meta((B, cfg.vlm.n_image_tokens, cfg.vlm.patch_dim), dt)
    return specs


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    specs = train_batch_specs(cfg, shape)
    specs.pop("labels")
    return specs


def decode_specs(cfg: ArchConfig, shape: ShapeConfig):
    """(token, pos, cache) specs of one decode step: one new token against
    a KV / state cache of ``seq_len``."""
    B, S = shape.global_batch, shape.seq_len
    cache = build(cfg, "meta").make_cache(B, S)
    return _meta((B, 1), torch.int32), _meta((), torch.int32), cache


def input_specs(cfg: ArchConfig, shape_name: str):
    """Every input of one (arch x shape) cell."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    token, pos, cache = decode_specs(cfg, shape)
    return {"token": token, "pos": pos, "cache": cache}
