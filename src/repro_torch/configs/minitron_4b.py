"""Minitron-4B [arXiv:2407.14679; hf]: pruned Nemotron, vocab 256,000.
Nemotron's squared-ReLU MLP is approximated with GELU (a 2-matrix MLP of
the same FLOP structure), as in the JAX package.  Counterpart of
``repro/configs/minitron_4b.py``, with the same values."""
from repro_torch.core.types import Family, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family=Family.DENSE,
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=9216, vocab_size=256000, head_dim=128,
    rope_theta=10_000.0, act="gelu",
)

SMOKE = ModelConfig(
    name="minitron-smoke", family=Family.DENSE,
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=192, vocab_size=1024, head_dim=16,
    act="gelu", dtype="float32", param_dtype="float32",
)
