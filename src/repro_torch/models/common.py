"""Architecture configuration for the model zoo.

One config dataclass covers all ten assigned architectures; family-
specific sub-configs are optional.  Exact full-size configs live in
``repro_torch.configs.<arch_id>``; smoke tests build reduced configs with
``scaled_down``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    moe_every: int = 1          # apply MoE FFN every k-th layer (jamba: 2)
    router_dtype: str = "float32"
    renormalize: bool = True    # top-k gates divided by their sum (AI21 Jamba2: not)


@dataclass(frozen=True)
class SSMConfig:
    """Chunked gated-linear-recurrence family (Mamba-2-style SSD for the
    jamba layers, RWKV6 'Finch' for rwkv).  See DESIGN.md §5 for the
    TPU adaptation rationale.  ``kind="mamba1"`` is the published Jamba
    mixer instead: one decay per (channel, state), dt projected through a
    rank ``dt_rank`` bottleneck (``models/transformer.py::mamba1_apply``);
    it reads ``d_state``, ``expand``, ``d_conv`` and ``dt_rank``."""

    kind: str = "mamba2"        # "mamba2" | "rwkv6" | "mamba1"
    d_state: int = 64           # key dim per head
    head_dim: int = 64          # value dim per head
    expand: int = 2             # d_inner = expand * d_model (mamba)
    d_conv: int = 4             # causal depthwise conv width (mamba)
    chunk: int = 128            # chunked-scan block length
    subchunk: int = 16          # intra-chunk pairwise tile (TPU: 128)
    decay_rank: int = 64        # low-rank data-dependent decay (rwkv6)
    dt_rank: int = 0            # dt projection's inner width (mamba1)


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int
    n_audio_ctx: int = 1500     # whisper: 30 s of 10 ms frames / 2 (conv stub)


@dataclass(frozen=True)
class VLMConfig:
    n_image_tokens: int = 1152  # anyres tiling stub: pre-projected patches
    patch_dim: int = 1024       # frontend embedding dim before projector


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    swa_window: int | None = None
    gated_mlp: bool = True      # SwiGLU vs plain GELU MLP
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # hybrid interleave: one attention layer per `attn_every` layers
    attn_every: int = 1         # jamba: 8 (1 attn : 7 mamba)
    attn_offset: int | None = None  # attention's place in the block (None: last)
    use_rope: bool = True       # rotary embeddings in self-attention (AI21 Jamba2: none)
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    # dtype policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # loss
    logit_chunk: int = 512      # sequence-chunked xent (memory control)
    # implementation toggles
    attn_impl: str = "chunked"  # full | chunked | pallas
    attn_chunk: int = 1024      # KV block for chunked/online-softmax attn
    remat: str = "block"        # none | block | dots
    # dry-run costing: fully unroll inner lax.scans (attention/ssm/xent
    # chunks) so XLA cost_analysis counts all iterations; unroll_blocks
    # additionally unrolls the layer-block scan (used by the 1/2-block
    # extrapolation compiles).  Inner unrolling also avoids XLA's
    # pathological nested-while SPMD compile times for hybrid archs.
    unroll_scans: bool = False
    unroll_blocks: bool = False
    # §Perf iteration: pin q/k/v and the chunked-attention KV blocks to
    # (batch, kv_heads) shardings so scan xs slicing doesn't reshard
    # every iteration (fixes the SPMD 'involuntary full remat' path)
    attn_shard_constraints: bool = False
    # §Perf iteration: carry the online-softmax accumulator/probabilities
    # in bf16 (statistics m/l stay fp32) — halves the attention-chunk
    # intermediate traffic
    attn_accum_bf16: bool = False
    # §Perf iteration: pin ssm-chunk scan operands to (batch, heads)
    # shardings (same involuntary-remat fix as attention)
    ssm_shard_constraints: bool = False
    # §Perf iteration: keep ssm-chunk operands in bf16 in HBM (state and
    # accumulation stay fp32 — the Pallas kernel's VMEM behaviour)
    ssm_bf16_io: bool = False
    # §Perf iteration: pin MoE dispatch buffers — "" (off), "expert"
    # (E over model; kills the replicated-buffer all-reduce but XLA
    # rewrites the scatter densely), or "capacity" (E over model + C
    # over data)
    moe_shard_constraints: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.encdec is not None

    def block_pattern(self) -> list[str]:
        """Per-layer kind within one scan block.

        For homogeneous stacks the block is one layer; for jamba the
        block is ``attn_every`` layers (1 attention at ``attn_offset``,
        last by default, + N-1 mamba), so
        ``lax.scan`` runs over n_layers // attn_every identical blocks.
        """
        if self.family == "ssm":
            return ["rwkv"]
        if self.attn_every == 1:
            return ["attn"]
        pat = ["mamba"] * self.attn_every
        # attention closes each block unless ``attn_offset`` places it
        pat[self.attn_every - 1 if self.attn_offset is None else self.attn_offset] = "attn"
        return pat

    @property
    def n_blocks(self) -> int:
        if self.n_layers % self.attn_every:
            raise ValueError("n_layers must divide by attn_every")
        if self.family == "ssm":
            return self.n_layers
        return self.n_layers // self.attn_every

    def ffn_kind(self, layer_in_block: int, block_idx: int = 0) -> str:
        """'moe' or 'dense' for a given layer position."""
        if self.moe is None:
            return "dense"
        # global layer index = block_idx * attn_every + layer_in_block;
        # inside a scan block the pattern must not depend on block_idx,
        # so moe_every must divide attn_every (or be 1).
        if self.moe.moe_every == 1:
            return "moe"
        return "moe" if (layer_in_block % self.moe.moe_every
                         == self.moe.moe_every - 1) else "dense"

    def scaled_down(self, **overrides) -> "ArchConfig":
        """Reduced config of the same family for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2 * self.attn_every),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            d_ff=256,
            vocab_size=512,
            d_head=32,
            param_dtype="float32",
            compute_dtype="float32",
            logit_chunk=64,
            attn_chunk=64,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2))
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=16, decay_rank=8)
        if self.encdec is not None:
            small["encdec"] = dataclasses.replace(
                self.encdec, n_encoder_layers=2, n_audio_ctx=24)
        if self.vlm is not None:
            small["vlm"] = dataclasses.replace(
                self.vlm, n_image_tokens=16, patch_dim=64)
        if self.swa_window is not None:
            small["swa_window"] = 64
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the assigned input-shape cells."""

    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

#: archs whose long_500k cell is skipped (pure full-attention; see
#: DESIGN.md §3) — sub-quadratic archs run it.
LONG_CONTEXT_OK = {"jamba-1.5-large-398b", "rwkv6-7b", "h2o-danube-3-4b",
                   "llava-next-mistral-7b"}


def cells_for(arch_id: str) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_id in LONG_CONTEXT_OK:
        names.append("long_500k")
    return names
