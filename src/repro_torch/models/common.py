"""Model configuration shared across all architecture families (port of
``repro.models.common``).

`dtype` and `cache_dtype` keep the reference's strings; `jdtype` and
`cache_jdtype` are the matching ``torch.dtype``s."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe_mla | moe_gqa | ssm | hybrid
                               # | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int = 0        # 0 -> = n_heads (MHA)
    head_dim: int = 0          # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0
    d_ff_dense: int = 0        # d_ff of the leading dense layers (MoE archs)
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (Mamba2 SSD) ---
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    n_groups: int = 1
    # --- hybrid (Zamba2) ---
    attn_every: int = 0        # shared attention block period (0 = none)
    # --- enc-dec (Whisper) ---
    n_enc_layers: int = 0
    enc_len: int = 0           # encoder frames (precomputed embeddings stub)
    # --- VLM ---
    n_img_tokens: int = 0      # prepended patch embeddings (stub frontend)
    # --- misc ---
    qk_norm: bool = False      # Qwen3-style q/k RMSNorm
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # KV/latent cache storage dtype; "float8_e4m3fn" halves the
    # memory-bound decode roofline term (§Roofline-summary)
    cache_dtype: str = "bfloat16"
    # long-context capability flag (sub-quadratic decode path exists)
    subquadratic: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def hdim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def jdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def cache_jdtype(self) -> torch.dtype:
        return getattr(torch, self.cache_dtype)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS and documentation."""
        D, V = self.d_model, self.vocab
        total = 2 * V * D  # embed + lm head
        if self.family in ("dense", "vlm"):
            total += self.n_layers * self._dense_layer_params()
        elif self.family in ("moe_mla", "moe_gqa"):
            dense_l = self.first_k_dense
            moe_l = self.n_layers - dense_l
            total += dense_l * self._dense_layer_params(self.d_ff_dense)
            attn = self._attn_params()
            ff_e = 3 * D * self.d_ff_expert
            shared = self.n_shared_experts * ff_e
            total += moe_l * (attn + self.n_experts * ff_e + shared
                              + D * self.n_experts)
        elif self.family == "ssm":
            total += self.n_layers * self._ssm_layer_params()
        elif self.family == "hybrid":
            total += self.n_layers * self._ssm_layer_params()
            total += self._dense_layer_params()  # one shared attn block
        elif self.family == "encdec":
            total += self.n_enc_layers * self._dense_layer_params()
            # decoder layers have an extra cross-attention
            total += self.n_layers * (self._dense_layer_params()
                                      + self._attn_params())
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared)."""
        if self.family not in ("moe_mla", "moe_gqa"):
            return self.param_count()
        D = self.d_model
        dense_l = self.first_k_dense
        moe_l = self.n_layers - dense_l
        attn = self._attn_params()
        ff_e = 3 * D * self.d_ff_expert
        total = 2 * self.vocab * D
        total += dense_l * self._dense_layer_params(self.d_ff_dense)
        total += moe_l * (attn + (self.top_k + self.n_shared_experts) * ff_e
                          + D * self.n_experts)
        return total

    def _attn_params(self) -> int:
        D = self.d_model
        if self.kv_lora_rank:  # MLA
            qdim = self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
            kv_in = self.kv_lora_rank + self.qk_rope_dim
            expand = self.kv_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.v_head_dim)
            out = self.n_heads * self.v_head_dim * D
            return D * qdim + D * kv_in + expand + out
        H, KV, hd = self.n_heads, self.kv_heads, self.hdim
        return D * hd * (H + 2 * KV) + H * hd * D

    def _dense_layer_params(self, d_ff: int | None = None) -> int:
        return self._attn_params() + 3 * self.d_model * (d_ff or self.d_ff)

    def _ssm_layer_params(self) -> int:
        D, Din, N = self.d_model, self.d_inner, self.d_state
        G = self.n_groups
        in_proj = D * (2 * Din + 2 * G * N + self.ssm_heads)
        conv = self.d_conv * (Din + 2 * G * N)
        out = Din * D
        return in_proj + conv + out + 2 * self.ssm_heads
