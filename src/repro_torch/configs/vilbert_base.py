"""ViLBERT-base [arXiv:1908.02265], the paper's own evaluation model
(VQA v2.0, N_X = N_Y = 4096 tokens).  Counterpart of
``repro/configs/vilbert_base.py``, with the same values.

Language stream = BERT-base (768, 12 heads); vision stream 1024/8 heads;
6 text-only layers then 6 co-TRM blocks; DTPU pruning on its default
schedule."""
from repro_torch.core.types import Family, ModelConfig, PruningConfig

CONFIG = ModelConfig(
    name="vilbert-base", family=Family.CROSSMODAL,
    num_layers=12,            # language-stream depth (6 pre + 6 co-TRM)
    d_model=1024, num_heads=8, d_ff=1024,      # vision stream
    num_kv_heads=8, vocab_size=30522,
    num_coattn_layers=6,
    d_model_y=768, num_heads_y=12, d_ff_y=3072, seq_y=4096,
    act="gelu", pruning=PruningConfig(enabled=True),
)

SMOKE = ModelConfig(
    name="vilbert-smoke", family=Family.CROSSMODAL,
    num_layers=4, d_model=64, num_heads=4, d_ff=128,
    num_kv_heads=4, vocab_size=512,
    num_coattn_layers=2,
    d_model_y=48, num_heads_y=4, d_ff_y=96, seq_y=64,
    act="gelu", pruning=PruningConfig(enabled=True, min_tokens=8),
    dtype="float32", param_dtype="float32",
)
