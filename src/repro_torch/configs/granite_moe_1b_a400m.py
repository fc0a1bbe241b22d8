"""IBM Granite 3.0 1B-A400M: 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""

from repro_torch.models.common import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8),
)
