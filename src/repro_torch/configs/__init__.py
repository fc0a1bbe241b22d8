"""Assigned-architecture configs (one module per arch id) + registry."""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "jamba-1.5-large-398b",
    "dbrx-132b",
    "granite-moe-1b-a400m",
    "granite-20b",
    "h2o-danube-3-4b",
    "qwen1.5-110b",
    "qwen1.5-0.5b",
    "whisper-medium",
    "rwkv6-7b",
    "llava-next-mistral-7b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
