"""Whisper-medium: 24L encoder + 24L decoder with cross-attention;
conv frontend STUBBED — input_specs() provides precomputed frame
embeddings (B, 1500, 1024) [arXiv:2212.04356]."""

from repro_torch.models.common import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    arch_id="whisper-medium",
    family="audio",
    n_layers=24,                        # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    gated_mlp=False,                    # whisper MLP: GELU, biased
    encdec=EncDecConfig(n_encoder_layers=24, n_audio_ctx=1500),
)
