"""StarCoder2-7B [arXiv:2402.19173; hf]: dense GQA + RoPE.  Counterpart of
``repro/configs/starcoder2_7b.py``, with the same values.  ``use_bias`` is
carried and, as in the JAX package, read by no model code: the model runs
without biases."""
from repro_torch.core.types import Family, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family=Family.DENSE,
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152, head_dim=128,
    rope_theta=1_000_000.0, act="gelu", use_bias=True,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family=Family.DENSE,
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32,
    rope_theta=1_000_000.0, act="gelu",
    dtype="float32", param_dtype="float32",
)
