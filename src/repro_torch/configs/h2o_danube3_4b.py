"""H2O-Danube3-4B [arXiv:2401.16818]: a llama + mistral mix with
sliding-window attention (window 4096) and head_dim 120 (3840 / 32).
Counterpart of ``repro/configs/h2o_danube3_4b.py``, with the same
values."""
from repro_torch.core.types import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube3-4b", family=Family.DENSE,
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    d_ff=10240, vocab_size=32000, head_dim=120,
    attn_kind=AttnKind.SLIDING, sliding_window=4096,
    rope_theta=10_000.0, act="silu",
)

SMOKE = ModelConfig(
    name="danube3-smoke", family=Family.DENSE,
    num_layers=2, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=24,
    attn_kind=AttnKind.SLIDING, sliding_window=16,
    act="silu", dtype="float32", param_dtype="float32",
)
