"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) in PyTorch (port
of ``repro.models.ssm``).

Training/prefill uses the chunked SSD algorithm (block-decomposed: exact
quadratic attention within chunks + linear state passing across
chunks, a Python loop over chunks where the reference scans); decode is
the O(1)-per-token recurrent update. n_groups=1 (B/C shared across
heads), head_dim P, state N.
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import _f32, _normal, init_rms, rms_norm

F32 = torch.float32


def init_mamba2(gen: torch.Generator, cfg: ModelConfig):
    D, Din, N, H = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.ssm_heads
    conv_ch = Din + 2 * cfg.n_groups * N
    dev, dt = gen.device, cfg.jdtype
    return {
        "in_proj": _normal(gen, (D, 2 * Din + 2 * cfg.n_groups * N + H), dt,
                           D ** -0.5),
        "conv_w": _normal(gen, (cfg.d_conv, conv_ch), dt, 0.1),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "A_log": torch.zeros((H,), dtype=F32, device=dev),  # A = -1
        "dt_bias": torch.full((H,), -2.0, dtype=F32, device=dev),
        "D_skip": torch.ones((H,), dtype=F32, device=dev),
        "norm": init_rms(Din, dev),
        "out_proj": _normal(gen, (Din, D), dt, Din ** -0.5),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x [B,S,C], w [K,C] -> [B,S,C]."""
    K = w.shape[0]
    xp = Fn.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out + b


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, *, return_state=False):
    """Chunked SSD: one loop over chunks fuses the intra-chunk quadratic
    part with the inter-chunk state recurrence, so the largest transient
    is the per-chunk [b,Q,Q,h] score tile.

    xh [B,L,H,P]; dt [B,L,H] (post-softplus); A [H] (negative);
    Bm, Cm [B,L,N] (n_groups=1, broadcast over heads).
    Returns y [B,L,H,P] (and the final state [B,H,N,P] if requested).
    """
    Bsz, L, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    nc = L // Q
    xc = xh.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    qi = torch.arange(Q, device=xh.device)
    tril = (qi[:, None] >= qi[None, :])[None, :, :, None]  # [1,q,k,1]

    state = torch.zeros((Bsz, H, N, P), dtype=F32, device=xh.device)
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        a = dtq * A[None, None, :]                      # [b,Q,h]
        cum = torch.cumsum(a, dim=1)
        # intra-chunk
        CB = torch.einsum("bqn,bkn->bqk", _f32(Cq), _f32(Bq))
        seg = cum[:, :, None, :] - cum[:, None, :, :]   # [b,q,k,h]
        decay = torch.where(tril, torch.exp(seg), 0.0)
        scores = CB[..., None] * decay * dtq[:, None]   # [b,q,k,h]
        y_diag = torch.einsum("bqkh,bkhp->bqhp", scores, _f32(xq))
        # contribution of the incoming state
        y_off = torch.einsum("bqn,bqh,bhnp->bqhp", _f32(Cq),
                             torch.exp(cum), state)
        # state update
        decay_out = torch.exp(cum[:, -1:, :] - cum)     # [b,Q,h]
        inc = torch.einsum("bkn,bkh,bkhp->bhnp", _f32(Bq),
                           decay_out * dtq, _f32(xq))
        chunk_decay = torch.exp(cum[:, -1, :])          # [b,h]
        state = state * chunk_decay[..., None, None] + inc
        ys.append((y_diag + y_off).to(xh.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, L, H, P)
    if return_state:
        return y, state
    return y


def ssd_decode_step(state, xt, dt, A, Bt, Ct):
    """One recurrent step. state [B,H,N,P]; xt [B,H,P]; dt [B,H];
    Bt, Ct [B,N]. Returns (new_state, y [B,H,P])."""
    da = torch.exp(dt * A[None, :])                     # [B,H]
    inc = torch.einsum("bn,bh,bhp->bhnp", _f32(Bt), dt, _f32(xt))
    new_state = state * da[..., None, None] + inc
    y = torch.einsum("bn,bhnp->bhp", _f32(Ct), new_state)
    return new_state, y.to(xt.dtype)


def mamba2_block(p, x, cfg: ModelConfig, *, cache=None, pos=None):
    """Mamba2 block. x [B,S,D]. cache = {"conv": [B,d_conv-1,C],
    "ssm": [B,H,N,P]} for decode (S==1). Returns (out, new_cache)."""
    B, S, D = x.shape
    Din, N, H, P = cfg.d_inner, cfg.d_state, cfg.ssm_heads, cfg.ssm_head_dim
    G = cfg.n_groups

    proj = x @ p["in_proj"]                             # [B,S,...]
    z, xBC, dt_raw = torch.split(proj, [Din, Din + 2 * G * N, H], dim=-1)
    dt = Fn.softplus(_f32(dt_raw) + p["dt_bias"][None, None])  # [B,S,H]
    A = -torch.exp(p["A_log"])                          # [H]

    if cache is None or S > 1:
        conv_out = Fn.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
        x_ssm, Bm, Cm = torch.split(conv_out, [Din, G * N, G * N], dim=-1)
        xh = x_ssm.reshape(B, S, H, P)
        y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk,
                                     return_state=True)
        y = y + p["D_skip"][None, None, :, None] * xh
        new_cache = None
        if cache is not None:  # prefill: hand the final states to decode
            conv_state = Fn.pad(
                xBC, (0, 0, max(cfg.d_conv - 1 - S, 0), 0)
            )[:, -(cfg.d_conv - 1):]
            new_cache = {"conv": conv_state.to(cfg.jdtype),
                         "ssm": final_state}
    else:  # decode
        conv_buf = torch.cat([cache["conv"].to(xBC.dtype), xBC],
                             dim=1)                     # [B,d_conv,C]
        conv_out = torch.einsum("bkc,kc->bc", conv_buf, p["conv_w"]) \
            + p["conv_b"]
        conv_out = Fn.silu(conv_out)[:, None]           # [B,1,C]
        x_ssm, Bm, Cm = torch.split(conv_out, [Din, G * N, G * N], dim=-1)
        xh = x_ssm.reshape(B, H, P)
        new_ssm, y = ssd_decode_step(cache["ssm"], xh, dt[:, 0], A,
                                     Bm[:, 0], Cm[:, 0])
        y = (y + p["D_skip"][None, :, None] * xh)[:, None]  # [B,1,H,P]
        new_cache = {"conv": conv_buf[:, 1:].to(cfg.jdtype),
                     "ssm": new_ssm}

    y = y.reshape(B, S, Din).to(x.dtype)
    y = rms_norm(y * Fn.silu(z), p["norm"]["scale"], cfg.norm_eps)
    return y @ p["out_proj"], new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, device="cuda"):
    conv_ch = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, conv_ch),
                                dtype=cfg.jdtype, device=device),
            "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.d_state,
                                cfg.ssm_head_dim), dtype=F32,
                               device=device)}
