"""What the kinds share: the program's configuration built from the
benchmark's file, and the check that the weights fit the program's
parameter tree."""

from __future__ import annotations

import dataclasses

#: the configuration file's keys that are the program's ``ArchConfig``
#: fields of the same name
ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
             "tie_embeddings", "swa_window", "rope_theta", "norm_eps", "param_dtype",
             "compute_dtype", "remat")


def port_config(cfg: dict):
    """The program's ``ArchConfig`` for ``cfg``: its own configuration of
    ``cfg["arch_id"]`` with every size the benchmark's file states."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import MoEConfig

    fields = {k: cfg[k] for k in ARCH_KEYS}
    fields["d_head"] = cfg["head_dim"]
    moe = cfg.get("moe")
    fields["moe"] = None if moe is None else MoEConfig(
        n_experts=moe["n_experts"], top_k=moe["top_k"],
        capacity_factor=moe["capacity_factor"], router_dtype=cfg["router_dtype"])
    return dataclasses.replace(get_config(cfg["arch_id"]), **fields)


def check_layout(abstract: dict, flat: dict) -> None:
    """Raises unless ``flat`` ({path: tensor}) has every leaf of the
    program's parameter tree ``abstract``, in its shape and dtype."""
    want = {k: (tuple(t.shape), t.dtype) for k, t in abstract.items()}
    got = {k: (tuple(t.shape), t.dtype) for k, t in flat.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the benchmark's weights do not fit the program's tree: {diff}")
