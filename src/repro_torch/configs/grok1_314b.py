"""Grok-1 314B [hf:xai-org/grok-1]: MoE, 8 experts top-2, GQA.
Counterpart of ``repro/configs/grok1_314b.py``, with the same values."""
from repro_torch.core.types import Family, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family=Family.MOE,
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    num_experts=8, experts_per_token=2, moe_d_ff=32768,
    rope_theta=10_000.0, act="gelu",
)

SMOKE = ModelConfig(
    name="grok1-smoke", family=Family.MOE,
    num_layers=2, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=24,
    num_experts=4, experts_per_token=2, moe_d_ff=128,
    act="gelu", dtype="float32", param_dtype="float32",
)
