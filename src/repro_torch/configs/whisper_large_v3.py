"""Whisper-large-v3 backbone [arXiv:2212.04356; unverified]. Enc-dec,
32+32 layers; conv/audio frontend is a STUB (input_specs provides 1500
precomputed frame embeddings)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, enc_len=1500,
)
