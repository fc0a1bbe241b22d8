"""LLaVA-NeXT (Mistral-7B backbone): SWA 4096; anyres vision frontend
STUBBED — input_specs() provides pre-extracted patch embeddings
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""

from repro_torch.models.common import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    swa_window=4096,
    vlm=VLMConfig(n_image_tokens=1152, patch_dim=1024),
)
