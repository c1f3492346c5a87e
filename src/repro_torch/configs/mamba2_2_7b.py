"""Mamba2-2.7B [arXiv:2405.21060; unverified]. SSD, attention-free,
state=128. Sub-quadratic decode -> runs long_500k."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, d_ff=0, vocab=50280,
    d_state=128, expand=2, ssm_head_dim=64, ssm_chunk=256,
    subquadratic=True,
)
