"""Training: AdamW, the train step, checkpoints and the loop (counterpart
of ``repro/train``)."""
