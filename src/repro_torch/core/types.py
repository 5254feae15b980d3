"""Configuration types (counterpart of ``repro/core/types.py``).

Only what the ported slices read is copied: the enums, ``PruningConfig``,
the fields of ``ModelConfig`` that the decoder (dense, MoE, SSM, hybrid,
VLM), encoder-decoder and crossmodal paths and the planner use, and the
shape cells (``ShapeConfig``/``SHAPES``).
Values and defaults are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    ENCDEC = "encdec"
    VLM = "vlm"
    CROSSMODAL = "crossmodal"  # two-stream co-attention (ViLBERT)


class AttnKind(str, enum.Enum):
    FULL = "full"
    SLIDING = "sliding"
    MLA = "mla"
    NONE = "none"


class ExecutionMode(str, enum.Enum):
    """The paper's three comparison systems."""

    NON_STREAM = "non_stream"      # unfused; every intermediate materialized
    LAYER_STREAM = "layer_stream"  # K/V materialized, then flash attention
    TILE_STREAM = "tile_stream"    # fused K/V generation + attention


@dataclasses.dataclass(frozen=True)
class PruningConfig:
    """DTPU dynamic token pruning: static kept counts, dynamic token choice."""

    enabled: bool = False
    # (layer_fraction_threshold, keep_ratio), Evo-ViT-style progressive.
    keep_schedule: Tuple[Tuple[float, float], ...] = (
        (0.25, 1.0), (0.5, 0.7), (0.75, 0.5), (1.01, 0.35),
    )
    min_tokens: int = 16

    def keep_ratio(self, layer_idx: int, num_layers: int) -> float:
        frac = (layer_idx + 1) / max(num_layers, 1)
        for threshold, ratio in self.keep_schedule:
            if frac <= threshold:
                return ratio
        return self.keep_schedule[-1][1]

    def kept_tokens(self, layer_idx: int, num_layers: int, seq_len: int) -> int:
        n = int(seq_len * self.keep_ratio(layer_idx, num_layers))
        # Multiple of 128 once at least 128, floor at min_tokens.
        n = max(self.min_tokens, (n // 128) * 128 if n >= 128 else n)
        return min(n, seq_len)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int            # query heads
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads
    attn_kind: AttnKind = AttnKind.FULL
    sliding_window: int = 4096
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) splits
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0          # expert hidden size
    first_dense_layers: int = 0  # deepseek-v3: the first k layers are dense
    # --- MLA (deepseek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- MTP (deepseek) ---
    mtp_depth: int = 0
    # --- SSM (mamba2 / hymba) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_expand: int = 2
    conv_kernel: int = 4
    # --- enc-dec (whisper) ---
    num_encoder_layers: int = 0
    encoder_seq: int = 1500    # whisper frame positions after conv stub
    # --- crossmodal (vilbert) ---
    num_coattn_layers: int = 0
    d_model_y: int = 0        # second-stream width (text stream)
    num_heads_y: int = 0
    d_ff_y: int = 0
    seq_y: int = 0
    # --- norm/act ---
    norm_eps: float = 1e-6
    act: str = "silu"         # silu | gelu
    use_bias: bool = False
    # --- paper technique knobs ---
    execution_mode: ExecutionMode = ExecutionMode.TILE_STREAM
    pruning: PruningConfig = dataclasses.field(default_factory=PruningConfig)
    fuse_kv_generation: bool = True
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def group_size(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1) if self.num_kv_heads else 1

    def param_count(self) -> int:
        """Approximate parameter count N (used for MODEL_FLOPS = 6·N·D)."""
        d, f, L, V = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == Family.SSM:
            d_inner = self.ssm_expand * d
            per = (d * (2 * d_inner + 2 * self.ssm_heads)   # in_proj (x,z) + dt/heads
                   + d_inner * (2 * self.ssm_state)          # B,C projections
                   + d_inner * d                             # out_proj
                   + self.conv_kernel * d_inner + 2 * d)
            return emb + L * per
        if self.attn_kind == AttnKind.MLA:
            attn = (d * self.q_lora_rank
                    + self.q_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    + self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
                    + self.num_heads * self.v_head_dim * d)
        else:
            hq, hkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
            attn = d * hd * (hq + 2 * hkv) + hq * hd * d
        if self.family == Family.MOE:
            e_ff = self.moe_d_ff or f
            moe = (self.num_experts + self.num_shared_experts) * 3 * d * e_ff + d * self.num_experts
            dense_ff = 3 * d * f
            per = attn + 2 * d
            total = emb
            for i in range(L):
                total += per + (dense_ff if i < self.first_dense_layers else moe)
            return total
        mlp = 3 * d * f if self.act == "silu" else 2 * d * f
        per = attn + mlp + 2 * d
        if self.family == Family.HYBRID:
            d_inner = self.ssm_expand * d
            per += (d * 2 * d_inner + d_inner * 2 * self.ssm_state + d_inner * d)
        total = emb + L * per
        if self.family == Family.ENCDEC:
            total += self.num_encoder_layers * per + self.num_encoder_layers * 0
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-in experts count)."""
        if self.family != Family.MOE:
            return self.param_count()
        e_ff = self.moe_d_ff or self.d_ff
        full = self.param_count()
        inactive_experts = self.num_experts - self.experts_per_token
        moe_layers = self.num_layers - self.first_dense_layers
        return full - moe_layers * inactive_experts * 3 * self.d_model * e_ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def pad_to(x: int, multiple: int) -> int:
    return int(math.ceil(x / multiple) * multiple)
