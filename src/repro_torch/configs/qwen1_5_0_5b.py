"""Qwen1.5-0.5B: MHA (kv=16), QKV bias, tied embeddings
[hf:Qwen/Qwen1.5-0.5B]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
)
