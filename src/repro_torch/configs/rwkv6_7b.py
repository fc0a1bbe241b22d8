"""RWKV6-7B "Finch": attention-free, data-dependent decay
[arXiv:2404.05892]."""

from repro_torch.models.common import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                         # d_model / head_size(64)
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", d_state=64, head_dim=64, chunk=128,
                  decay_rank=64),
)
