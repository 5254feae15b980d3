"""ViLBERT-large, the paper's second model (after arXiv:1908.02265):
BERT-large language stream (1024, 16 heads, 24 layers) with a matched
vision stream; 12 co-TRM blocks.  Counterpart of
``repro/configs/vilbert_large.py``, with the same values."""
from repro_torch.core.types import Family, ModelConfig, PruningConfig

CONFIG = ModelConfig(
    name="vilbert-large", family=Family.CROSSMODAL,
    num_layers=24,
    d_model=1024, num_heads=16, d_ff=4096,     # vision stream
    num_kv_heads=16, vocab_size=30522,
    num_coattn_layers=12,
    d_model_y=1024, num_heads_y=16, d_ff_y=4096, seq_y=4096,
    act="gelu", pruning=PruningConfig(enabled=True),
)

SMOKE = ModelConfig(
    name="vilbert-large-smoke", family=Family.CROSSMODAL,
    num_layers=6, d_model=64, num_heads=4, d_ff=128,
    num_kv_heads=4, vocab_size=512,
    num_coattn_layers=3,
    d_model_y=64, num_heads_y=4, d_ff_y=128, seq_y=64,
    act="gelu", pruning=PruningConfig(enabled=True, min_tokens=8),
    dtype="float32", param_dtype="float32",
)
