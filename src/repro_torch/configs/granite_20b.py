"""IBM Granite 20B (code): gpt_bigcode-style — MQA (kv=1), plain GELU
MLP (2-matrix, biased) [arXiv:2405.04324]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    gated_mlp=False,                    # bigcode MLP: wi+gelu+wo with bias
)
