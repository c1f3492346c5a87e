"""Mixture-of-Experts FFN with capacity-based top-k routing (port of
``repro.models.moe``).

Tokens are dispatched into a fixed-shape ``[E, C, D]`` buffer via cumsum
position assignment + scatter, experts run as batched matmuls, results
gather back with gate-weighted combine, so the work is proportional to
the capacity-bounded active parameters.

Capacity C = ceil(tokens * top_k / E * capacity_factor); overflow tokens
drop to the shared/residual path (standard GShard semantics).

The reference's expert-parallel path (``moe_block_ep``: ``shard_map``
plus all-to-all over a mesh's model axis) has no one-device counterpart;
`moe_block` always takes the scatter path, and `moe_block_ep` raises.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from repro_torch.dist import sharding as shd
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import _normal, init_mlp, mlp

F32 = torch.float32


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = cfg.jdtype
    p = {
        "router": _normal(gen, (D, E), F32, D ** -0.5),
        "w_gate": _normal(gen, (E, D, Fe), dt, D ** -0.5),
        "w_up": _normal(gen, (E, D, Fe), dt, D ** -0.5),
        "w_down": _normal(gen, (E, Fe, D), dt, Fe ** -0.5),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg,
                               d_ff=cfg.n_shared_experts * cfg.d_ff_expert)
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                    * cfg.capacity_factor)
    return max(int(cap), 8)


def moe_block(p, x, cfg: ModelConfig):
    """x [B,S,D] -> (out [B,S,D], aux_loss scalar): the single-device
    scatter/gather path (there is no mesh on one device)."""
    return moe_block_scatter(p, x, cfg)


def moe_block_scatter(p, x, cfg: ModelConfig):
    """Single-program scatter/gather dispatch."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    C = moe_capacity(cfg, N)
    xf = shd.constrain(x.reshape(N, D), ("dp", None))
    logits = xf.to(F32) @ p["router"]                         # [N, E]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, K, dim=-1)                  # [N, K]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch-style)
    me = probs.mean(dim=0)                                    # [E]
    density = torch.zeros((E,), dtype=F32, device=x.device)
    for j in range(K):
        density = density + Fn.one_hot(idx[:, j], E).to(F32).sum(0)
    density = density / (N * K)
    aux = torch.sum(me * density) * E

    # position of each (token, choice) within its expert, choices serialized
    base = torch.zeros((E,), dtype=torch.int64, device=x.device)
    pos_js = []
    for j in range(K):
        oh = Fn.one_hot(idx[:, j], E)                         # [N, E]
        cum = torch.cumsum(oh, dim=0) - 1 + base[None, :]
        pos_js.append(torch.gather(cum, 1, idx[:, j:j + 1])[:, 0])
        base = base + oh.sum(0)
    pos = torch.stack(pos_js, dim=1)                          # [N, K]
    keep = pos < C

    e_flat = idx.reshape(-1)
    p_flat = torch.where(keep, pos, 0).reshape(-1)
    keep_f = keep.reshape(-1, 1).to(x.dtype)
    upd = torch.repeat_interleave(xf, K, dim=0) * keep_f      # [N*K, D]
    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((e_flat, p_flat), upd, accumulate=True)

    h = torch.einsum("ecd,edf->ecf", buf, p["w_gate"])
    u = torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    y_buf = torch.einsum("ecf,efd->ecd", Fn.silu(h) * u, p["w_down"])

    y = y_buf[e_flat, p_flat] * keep_f                        # [N*K, D]
    y = y.reshape(N, K, D)
    out = torch.sum(y * gate[..., None].to(x.dtype), dim=1)

    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], xf)
    return out.reshape(B, S, D), aux


def moe_block_ep(p, x, cfg: ModelConfig):
    """The reference's expert-parallel MoE (``shard_map`` + all-to-all
    over a mesh's model axis): no counterpart on one device."""
    raise NotImplementedError(
        "moe_block_ep needs a mesh with a model axis (expert parallelism "
        "by all-to-all); the PyTorch/CUDA port runs on a single device, "
        "use moe_block_scatter")
