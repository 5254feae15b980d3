"""StarCoder2-7B [arXiv:2402.19173; hf], smoke size only: the second
parity config of the decoder slice (the one the JAX engine tests use).
Counterpart of ``repro/configs/starcoder2_7b.py``'s ``SMOKE``.  The full
config carries biases (``use_bias=True``), which the port does not
implement yet, so ``CONFIG`` is not copied."""
from repro_torch.core.types import Family, ModelConfig

SMOKE = ModelConfig(
    name="starcoder2-smoke", family=Family.DENSE,
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32,
    rope_theta=1_000_000.0, act="gelu",
    dtype="float32", param_dtype="float32",
)
