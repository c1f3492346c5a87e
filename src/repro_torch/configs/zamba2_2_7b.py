"""Zamba2-2.7B [arXiv:2411.15242; hf]. Mamba2 backbone + weight-tied shared
attention block every 6 layers (simplified from per-use LoRA — DESIGN.md).
Sub-quadratic backbone -> runs long_500k."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000,
    d_state=64, expand=2, ssm_head_dim=64, ssm_chunk=256, attn_every=6,
    subquadratic=True,
)
