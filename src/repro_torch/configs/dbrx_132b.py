"""DBRX (132B total / 36B active): 16-expert top-4 fine-grained MoE
[hf:databricks/dbrx-base]."""

from repro_torch.models.common import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    moe=MoEConfig(n_experts=16, top_k=4),
)
