"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf]. MLA kv_lora=512, 64 routed
+ 2 shared experts top-6, first layer dense. (Assignment line also said
"160 routed" — see DESIGN.md §2 for the discrepancy note.)"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe_mla",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400,
    n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408,
    first_k_dense=1, d_ff_dense=10944,
    kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
)
