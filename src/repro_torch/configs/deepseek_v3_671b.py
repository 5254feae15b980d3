"""DeepSeek-V3 671B [arXiv:2412.19437; hf]: MLA + 256-expert top-8 MoE
(+1 shared), 3 dense prefix layers, MTP depth 1.  Counterpart of
``repro/configs/deepseek_v3_671b.py``, with the same values.

MLA is the strongest tile-streaming case: K/V only ever exist as latent
decompressions.
"""
from repro_torch.core.types import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family=Family.MOE,
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432,                       # dense-prefix layer hidden
    vocab_size=129280, attn_kind=AttnKind.MLA,
    num_experts=256, num_shared_experts=1, experts_per_token=8,
    moe_d_ff=2048, first_dense_layers=3,
    q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    mtp_depth=1, rope_theta=10_000.0, act="silu",
)

SMOKE = ModelConfig(
    name="deepseekv3-smoke", family=Family.MOE,
    num_layers=3, d_model=96, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=512, attn_kind=AttnKind.MLA,
    num_experts=8, num_shared_experts=1, experts_per_token=2,
    moe_d_ff=64, first_dense_layers=1,
    q_lora_rank=48, kv_lora_rank=32,
    qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16,
    act="silu", dtype="float32", param_dtype="float32",
)
