"""InternVL2-76B backbone [arXiv:2404.16821; unverified]. InternLM2-76B-like
LM; InternViT frontend is a STUB (input_specs provides 256 patch
embeddings)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, n_img_tokens=256,
)
