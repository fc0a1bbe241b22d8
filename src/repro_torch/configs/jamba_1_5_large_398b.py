"""Jamba-1.5-Large (398B) as the reference has it: Mamba+attention 1:7
interleave, MoE 16e top-2 every other layer (matches the 398B total / 94B
active budget) [arXiv:2403.19887].  Its mixer is the reference's
Mamba-2-style SSD (one scalar decay a head, d_state 64, B and C projected
straight from the input, a gated RMSNorm), not the published Jamba's
Mamba-1 (one decay per channel and state, d_state 16, a dt_rank
bottleneck), and attention sits last in each block of 8, not at offset 4.
The published mixer is the port's ``ssm.kind="mamba1"``."""

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
