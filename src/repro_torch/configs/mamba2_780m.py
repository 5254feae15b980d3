"""Mamba2-780m [arXiv:2405.21060]: attention-free SSD.  Counterpart of
``repro/configs/mamba2_780m.py``, with the same values."""
from repro_torch.core.types import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family=Family.SSM,
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, attn_kind=AttnKind.NONE,
    ssm_state=128, ssm_heads=48, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256, act="silu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family=Family.SSM,
    num_layers=2, d_model=96, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=512, attn_kind=AttnKind.NONE,
    ssm_state=16, ssm_heads=4, ssm_chunk=16,
    act="silu", tie_embeddings=True,
    dtype="float32", param_dtype="float32",
)
