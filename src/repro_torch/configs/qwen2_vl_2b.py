"""Qwen2-VL-2B [arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B], the
vision-language backbone with M-RoPE (t/h/w sections 16/24/24 over
head_dim/2 = 64).  Counterpart of ``repro/configs/qwen2_vl_2b.py``, with
the same values.  The vision patch frontend is a stub: the input is token
ids and three position streams."""
from repro_torch.core.types import Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family=Family.VLM,
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    mrope_sections=(16, 24, 24), rope_theta=1_000_000.0, act="silu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke", family=Family.VLM,
    num_layers=2, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=24,
    mrope_sections=(4, 4, 4), act="silu",
    tie_embeddings=True, dtype="float32", param_dtype="float32",
)
