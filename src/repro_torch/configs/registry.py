"""Architecture registry + assigned input shapes (port of
``repro.configs.registry``; the arch files are the reference's).

Every arch is selectable via --arch <id>; each (arch x shape) cell defines
one dry-run compile. ``long_500k`` runs only for sub-quadratic archs
(SSM/hybrid) per the assignment rules — skips documented in DESIGN.md §3.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = [
    "deepseek_v2_lite_16b", "qwen3_moe_30b_a3b", "stablelm_1_6b",
    "deepseek_67b", "mistral_nemo_12b", "internlm2_1_8b", "mamba2_2_7b",
    "zamba2_2_7b", "whisper_large_v3", "internvl2_76b",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def cells(include_multipod: bool = False):
    """All live (arch, shape) dry-run cells, applying assignment skips."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in ["train_4k", "prefill_32k", "decode_32k", "long_500k"]:
            if s == "long_500k" and not cfg.subquadratic:
                continue  # needs sub-quadratic attention (DESIGN.md §3)
            out.append((a, s))
    return out


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=max(2, cfg.attn_every or 0),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.kv_heads, 4) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128,
        vocab=256,
    )
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=2, d_ff_expert=32,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_k_dense=min(cfg.first_k_dense, 1), d_ff_dense=128)
    if cfg.kv_lora_rank:
        kw.update(kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16,
                  v_head_dim=16, head_dim=0, n_kv_heads=0)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(d_state=16, ssm_head_dim=16, ssm_chunk=16, n_layers=4)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=2, enc_len=32)
    if cfg.n_img_tokens:
        kw.update(n_img_tokens=8)
    return dataclasses.replace(cfg, **kw)
