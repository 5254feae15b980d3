"""Hymba-1.5B [arXiv:2411.13676; hf]: hybrid parallel attention + SSM
heads, sliding-window attention, ssm_state 16.  Counterpart of
``repro/configs/hymba_1_5b.py``, with the same values."""
from repro_torch.core.types import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family=Family.HYBRID,
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    attn_kind=AttnKind.SLIDING, sliding_window=1024,
    ssm_state=16, ssm_heads=25, ssm_head_dim=128, ssm_expand=2,
    rope_theta=10_000.0, act="silu",
)

SMOKE = ModelConfig(
    name="hymba-smoke", family=Family.HYBRID,
    num_layers=2, d_model=100, num_heads=5, num_kv_heads=5,
    d_ff=192, vocab_size=512, head_dim=20,
    attn_kind=AttnKind.SLIDING, sliding_window=16,
    ssm_state=8, ssm_heads=4, ssm_chunk=16,
    act="silu", dtype="float32", param_dtype="float32",
)
