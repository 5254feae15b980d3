"""Qwen3-32B [hf:Qwen/Qwen3-32B]: dense GQA + qk-norm, head_dim 128.
Counterpart of ``repro/configs/qwen3_32b.py``, with the same values."""
from repro_torch.core.types import Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family=Family.DENSE,
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    d_ff=25600, vocab_size=151936, head_dim=128,
    use_qk_norm=True, rope_theta=1_000_000.0, act="silu",
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family=Family.DENSE,
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32,
    use_qk_norm=True, rope_theta=1_000_000.0, act="silu",
    dtype="float32", param_dtype="float32",
)
