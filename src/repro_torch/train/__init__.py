"""Training (port of ``repro.train``): AdamW, the train step and
checkpoints, on tensors."""
