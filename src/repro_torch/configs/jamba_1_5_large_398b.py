"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer (matches the 398B total / 94B active budget)
[arXiv:2403.19887]."""

from repro_torch.models.common import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    attn_every=8,                       # 1 attention : 7 mamba per block
    moe=MoEConfig(n_experts=16, top_k=2, moe_every=2),
    # TPU-native SSD blocking: 512-token chunks, 128-wide MXU sub-chunks
    # (scalar-decay path materializes only (B,R,R,H) — VMEM-safe at 128)
    ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2,
                  d_conv=4, chunk=512, subchunk=128),
)
