"""Mixture-of-Experts FFN with capacity-based top-k routing (port of
``repro.models.moe``).

Tokens are dispatched into a fixed-shape ``[E, C, D]`` buffer via cumsum
position assignment + scatter, experts run as batched matmuls, results
gather back with gate-weighted combine, so the work is proportional to
the capacity-bounded active parameters.

Capacity C = ceil(tokens * top_k / E * capacity_factor); overflow tokens
drop to the shared/residual path (standard GShard semantics).

Under a world mesh (``dist.sharding``) whose model axis divides the
experts, `moe_block` takes the expert-parallel path, `moe_block_ep`: the
reference's ``shard_map`` body run by each rank, experts split over the
model axis and tokens exchanged by all-to-all over its process group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from repro_torch.dist import collectives as coll
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
    """x [B,S,D] -> (out [B,S,D], aux_loss scalar).

    Dispatches to the expert-parallel path when a world mesh with a
    "model" axis that divides the experts is active, else the
    single-program scatter/gather path, as the reference does."""
    rules = shd.model_rules()
    if rules is not None and rules.mp is not None \
            and cfg.n_experts % rules.axis_size("mp") == 0:
        return moe_block_ep(p, x, cfg)
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
    """Expert-parallel MoE (the reference's ``shard_map`` + all_to_all),
    run by each rank of the active world mesh.

    x [B_loc, S, D] is this rank's rows of the batch (split over the data
    axes, the same on every rank of a model column group). The experts
    split over "model": ``w_gate``/``w_up`` [E_loc, D, Fe] and ``w_down``
    [E_loc, Fe, D], their D split over the data axes (ZeRO-3) unless
    already gathered. Each model column routes its 1/mp slice of the
    local tokens (padded to divisibility) at the local capacity
    ``max(int(-(-N*K // E) * capacity_factor), 8)``, packs an
    [mp, E_loc, C, D] send buffer, exchanges it over the model group,
    runs its local experts, exchanges the results back and combines
    them; the columns' outputs are all-gathered and cut to the local
    tokens. The aux loss is averaged over every rank. The backward pass
    sends each expert's gradient to its owner, sums the router's over
    the columns and joins the columns' input gradients."""
    if shd.active() is None:
        raise RuntimeError("moe_block_ep requires set_mesh(...) first")
    rules = shd.model_rules()
    if rules is None:
        raise shd.unsupported("moe_block_ep under a lane mesh",
                              shd.LANE_MESH)
    mesh = rules.mesh
    shd.check_local(x, mesh)
    mp_group = mesh.group(rules.mp)
    dp_group = mesh.group(rules.dp) if rules.dp else None
    mp_size = rules.axis_size("mp")
    E, K = cfg.n_experts, cfg.top_k
    E_loc = E // mp_size
    Bl, Sl, D = x.shape
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if wg.shape[0] != E_loc:
        raise ValueError(f"moe_block_ep: {wg.shape[0]} local experts, the "
                         f"model axis gives each column {E_loc}")
    # ZeRO-3 expert weights: gather the dp-sharded dim per layer
    if dp_group is not None and wg.shape[1] != D:
        wg = coll.gather_params(wg, 1, dp_group)
        wu = coll.gather_params(wu, 1, dp_group)
    if dp_group is not None and wd.shape[2] != D:
        wd = coll.gather_params(wd, 2, dp_group)

    N_full = Bl * Sl
    Np = -(-N_full // mp_size) * mp_size
    xf_full = x.reshape(N_full, D)
    if Np != N_full:
        xf_full = Fn.pad(xf_full, (0, 0, 0, Np - N_full))
    xf = coll.own_slice(xf_full, 0, mp_group)           # [Ns, D]
    N = Np // mp_size
    # local capacity with the configured slack factor
    C = max(int(-(-N * K // E) * cfg.capacity_factor), 8)

    router = coll.sum_grads(p["router"], mp_group)
    logits = xf.to(F32) @ router                          # [N, E]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, K, dim=-1)              # [N, K]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # aux load-balance loss, averaged over every rank
    me = probs.mean(dim=0)
    density = torch.zeros((E,), dtype=F32, device=x.device)
    for j in range(K):
        density = density + Fn.one_hot(idx[:, j], E).to(F32).sum(0)
    density = density / (N * K)
    aux = torch.sum(me * density) * E
    aux = coll.sum_replicated(aux, mesh.group(mesh.axis_names)) \
        / mesh.size

    # position of each (token, choice) within its chosen expert
    base = torch.zeros((E,), dtype=torch.int64, device=x.device)
    pos_js = []
    for j in range(K):
        oh = Fn.one_hot(idx[:, j], E)
        cum = torch.cumsum(oh, dim=0) - 1 + base[None, :]
        pos_js.append(torch.gather(cum, 1, idx[:, j:j + 1])[:, 0])
        base = base + oh.sum(0)
    pos = torch.stack(pos_js, 1)                          # [N, K]
    keep = pos < C
    col = (idx // E_loc).reshape(-1)                      # target column
    le = (idx % E_loc).reshape(-1)                        # local expert id
    p_safe = torch.where(keep, pos, 0).reshape(-1)
    keep_f = keep.reshape(-1, 1).to(x.dtype)

    send = torch.zeros((mp_size, E_loc, C, D), dtype=x.dtype,
                       device=x.device)
    send = send.index_put((col, le, p_safe),
                          torch.repeat_interleave(xf, K, dim=0) * keep_f,
                          accumulate=True)
    recv = coll.all_to_all(send, mp_group)
    # recv[i] = tokens column i routed to my experts
    buf = recv.transpose(0, 1).reshape(E_loc, mp_size * C, D)

    h = torch.einsum("ecd,edf->ecf", buf, wg)
    u = torch.einsum("ecd,edf->ecf", buf, wu)
    y = torch.einsum("ecf,efd->ecd", Fn.silu(h) * u, wd)

    y = y.reshape(E_loc, mp_size, C, D).transpose(0, 1)
    back = coll.all_to_all(y.contiguous(), mp_group)
    # back[col, le, pos] = expert output for my token (col, le, pos)
    out_k = back[col, le, p_safe] * keep_f                # [N*K, D]
    out = torch.sum(out_k.reshape(N, K, D) * gate[..., None].to(x.dtype),
                    dim=1)
    # reassemble the full (model-axis-replicated) token set
    out_full = coll.gather_replicated(out, 0, mp_group)[:N_full]
    out = out_full.reshape(Bl, Sl, D)
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], x.reshape(-1, D)).reshape(Bl, Sl, D)
    return out, aux
