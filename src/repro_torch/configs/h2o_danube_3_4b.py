"""H2O Danube3-4B: llama/mistral mix with sliding-window attention
[arXiv:2401.16818]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    arch_id="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    swa_window=4096,
)
