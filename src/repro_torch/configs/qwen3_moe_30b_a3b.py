"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]. GQA kv=4, 128 experts top-8,
QK-norm, head_dim=128."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe_gqa",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    n_experts=128, top_k=8, d_ff_expert=768, qk_norm=True,
)
