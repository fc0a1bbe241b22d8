"""Qwen1.5-110B: GQA kv=8, QKV bias [hf:Qwen/Qwen1.5-110B]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
)
