"""Whisper-base [arXiv:2212.04356], the encoder-decoder audio backbone.
Counterpart of ``repro/configs/whisper_base.py``, with the same values.
The conv frontend is a stub: the input is (B, 1500, 512) frame
embeddings.  The learned decoder position table has 32768 rows (the
published model has 448)."""
from repro_torch.core.types import Family, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family=Family.ENCDEC,
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    num_encoder_layers=6, encoder_seq=1500,
    tie_embeddings=True, act="gelu",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family=Family.ENCDEC,
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    num_encoder_layers=2, encoder_seq=48,
    tie_embeddings=True, act="gelu",
    dtype="float32", param_dtype="float32",
)
