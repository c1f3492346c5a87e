"""Core transformer layers (port of ``repro.models.layers``): RMSNorm,
RoPE, chunked-flash GQA attention, MLA (DeepSeek-V2 multi-head latent
attention), SwiGLU MLP.

Conventions: params are nested dicts of tensors; functions are plain
functions on tensors. Activations default to bf16, accumulation and
softmax in f32: where the reference asks XLA for an f32 product of
low-precision operands (``preferred_element_type=jnp.float32``), the
operands are upcast to f32 first (`_f32`), so the port rounds where the
reference does. The reference has no Pallas kernel here; products go to
``torch.einsum``/``torch.matmul`` and attention is written as the
reference writes it (chunked, online softmax), never through
``scaled_dot_product_attention``.

Decode writes the new token's keys and values into the cache tensors in
place (the reference returns updated copies) and returns the same dict,
so a decode step moves no more cache bytes than it reads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from repro_torch.models.common import ModelConfig

NEG_INF = -1e30
F32 = torch.float32

# The reference unrolls its scans for cost probes; the port loops in
# Python already, so the flag is kept only as API.
_UNROLL = False


def set_unroll(v: bool) -> None:
    global _UNROLL
    _UNROLL = v


def unroll() -> bool:
    return _UNROLL


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == F32 else x.to(F32)


def _normal(gen: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device) * std


def rms_norm(x, scale, eps=1e-5):
    x32 = _f32(x)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def init_rms(d, device="cuda"):
    return {"scale": torch.ones((d,), dtype=F32, device=device)}


# ------------------------------------------------------------------ RoPE ----
def rope_freqs(hd: int, theta: float, device="cpu"):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32, device=device)
                            / hd))


def apply_rope(x, positions, theta=10000.0):
    """x [..., S, H, hd] (hd even), positions [..., S] int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # [hd/2]
    ang = positions[..., None].to(F32) * freqs           # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                   # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(_f32(x), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------- chunked flash attention ----
def _flash_q_chunk(q, k, v, q_pos0, kv_chunk, scale, causal=True,
                   kv_valid=None):
    """Online-softmax attention of one query chunk against all of k/v.

    q [B, qc, H, hd]; k/v [B, S, KV, hd]; causal with absolute offset
    q_pos0. Loops over kv chunks carrying (m, l, acc) in f32.
    """
    B, qc, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qg = _f32(q.reshape(B, qc, KV, G, hd))
    m = torch.full((B, KV, G, qc), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, KV, G, qc), dtype=F32, device=dev)
    acc = torch.zeros((B, KV, G, qc, hd), dtype=F32, device=dev)
    q_ids = q_pos0 + torch.arange(qc, device=dev)
    for i in range(S // kv_chunk):
        ks = k[:, i * kv_chunk:(i + 1) * kv_chunk]
        vs = v[:, i * kv_chunk:(i + 1) * kv_chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, _f32(ks)) * scale
        if causal:
            kv_ids = i * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = q_ids[:, None] >= kv_ids[None, :]
            s = torch.where(mask[None, None, None], s, NEG_INF)
        if kv_valid is not None:
            vmask = kv_valid[i * kv_chunk:(i + 1) * kv_chunk]
            s = torch.where(vmask[None, None, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", _f32(p.to(vs.dtype)),
                          _f32(vs))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-20)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, qc, H, hd)
    return out.to(q.dtype)


def flash_attention(q, k, v, *, q_chunk=512, kv_chunk=1024, causal=True):
    """Chunked attention. q [B,Sq,H,hd], k/v [B,Skv,KV,hd] -> [B,Sq,H,hd].

    O(chunk^2) memory, online softmax, GQA by grouping. Non-causal
    (causal=False) supports cross/encoder attention with Sq != Skv.
    """
    B, S, H, hd = q.shape
    Skv = k.shape[1]
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, Skv)
    q_pad = 0
    if S % q_chunk:  # pad queries to a chunk multiple, slice the result
        q_pad = q_chunk - S % q_chunk
        q = Fn.pad(q, (0, 0, 0, 0, 0, q_pad))
        S = S + q_pad
    kv_valid = None
    if Skv % kv_chunk:  # pad kv to a chunk multiple with masked tail
        pad = kv_chunk - Skv % kv_chunk
        k = Fn.pad(k, (0, 0, 0, 0, 0, pad))
        v = Fn.pad(v, (0, 0, 0, 0, 0, pad))
        if not causal:  # causal mask already excludes the tail
            kv_valid = torch.arange(Skv + pad, device=q.device) < Skv
    scale = 1.0 / (hd ** 0.5)
    outs = [_flash_q_chunk(q[:, i * q_chunk:(i + 1) * q_chunk], k, v,
                           i * q_chunk, kv_chunk, scale, causal=causal,
                           kv_valid=kv_valid)
            for i in range(S // q_chunk)]
    out = torch.cat(outs, dim=1)
    return out[:, :S - q_pad] if q_pad else out


def decode_attention(q, k_cache, v_cache, pos, scale=None):
    """Single-token attention over a cache.

    q [B,1,H,hd]; caches [B,S,KV,hd] (any storage dtype — fp8 caches are
    upcast at use); pos int = index of the new token (attends to cache
    positions <= pos). Returns [B,1,H,hd].
    """
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale or 1.0 / (hd ** 0.5)
    if k_cache.element_size() < 2:  # fp8 storage -> bf16 compute
        k_cache = k_cache.to(q.dtype)
        v_cache = v_cache.to(q.dtype)
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", _f32(qg), _f32(k_cache)) * scale
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", _f32(p.to(v_cache.dtype)),
                       _f32(v_cache))
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ------------------------------------------------------------ GQA block ----
def init_attention(gen: torch.Generator, cfg: ModelConfig):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hdim
    std = D ** -0.5
    dt = cfg.jdtype
    p = {
        "wq": _normal(gen, (D, H, hd), dt, std),
        "wk": _normal(gen, (D, KV, hd), dt, std),
        "wv": _normal(gen, (D, KV, hd), dt, std),
        "wo": _normal(gen, (H, hd, D), dt, std),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms(hd, gen.device)
        p["k_norm"] = init_rms(hd, gen.device)
    return p


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def attention(p, x, cfg: ModelConfig, *, positions=None, cache=None,
              pos=None, kv_x=None, causal=True, use_rope=True):
    """GQA attention. x [B,S,D].

    Training/prefill: cache=None, full causal flash. If `cache` is given
    (dict with k/v [B,Smax,KV,hd]) and S==1, runs a decode step writing at
    `pos` and returns (out, cache); prefill with cache returns the
    populated cache. Cross attention: pass kv_x (keys/values source) and
    causal=False (its k/v are recomputed from kv_x at every call, as in
    the reference).
    """
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    src = x if kv_x is None else kv_x
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)

    if use_rope:
        if positions is None:
            if cache is not None and S == 1:
                positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                                       device=x.device)
            else:
                positions = _positions(B, S, x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        kv_pos = _positions(B, k.shape[1], x.device) \
            if kv_x is not None else positions
        k = apply_rope(k, kv_pos, cfg.rope_theta)

    if cache is None:
        out = flash_attention(q, k, v, causal=causal)
        new_cache = None
    elif S == 1:  # decode: write at pos in place
        at = min(int(pos), cache["k"].shape[1] - 1)
        cache["k"][:, at:at + 1] = k.to(cache["k"].dtype)
        cache["v"][:, at:at + 1] = v.to(cache["v"].dtype)
        out = decode_attention(q, cache["k"], cache["v"], pos)
        new_cache = cache
    else:  # prefill into cache
        out = flash_attention(q, k, v)
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
        new_cache = cache

    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device="cuda"):
    shape = (batch, max_len, cfg.kv_heads, cfg.hdim)
    return {"k": torch.zeros(shape, dtype=cfg.cache_jdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cache_jdtype, device=device)}


# ------------------------------------------------------------------- MLA ----
def init_mla(gen: torch.Generator, cfg: ModelConfig):
    """DeepSeek-V2 multi-head latent attention (no q compression, as in
    V2-Lite): q proj full rank; kv compressed to kv_lora_rank + rope dims."""
    D, H = cfg.d_model, cfg.n_heads
    L, rd, nd, vd = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                     cfg.v_head_dim)
    std = D ** -0.5
    dt = cfg.jdtype
    return {
        "wq": _normal(gen, (D, H, nd + rd), dt, std),
        "w_dkv": _normal(gen, (D, L + rd), dt, std),
        "kv_norm": init_rms(L, gen.device),
        "w_uk": _normal(gen, (L, H, nd), dt, L ** -0.5),
        "w_uv": _normal(gen, (L, H, vd), dt, L ** -0.5),
        "wo": _normal(gen, (H, vd, D), dt, std),
    }


def mla_attention(p, x, cfg: ModelConfig, *, cache=None, pos=None):
    """MLA forward. Cache holds the compressed c_kv and rope key only.
    Decode uses the absorption trick (scores computed in latent space; no
    per-step re-expansion)."""
    B, S, D = x.shape
    H = cfg.n_heads
    L, rd, nd, vd = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                     cfg.v_head_dim)
    scale = 1.0 / ((nd + rd) ** 0.5)

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])        # [B,S,H,nd+rd]
    q_nope, q_pe = q[..., :nd], q[..., nd:]
    ckv_full = torch.einsum("bsd,dk->bsk", x, p["w_dkv"])  # [B,S,L+rd]
    c_kv = rms_norm(ckv_full[..., :L], p["kv_norm"]["scale"], cfg.norm_eps)
    k_pe = ckv_full[..., L:][:, :, None, :]              # [B,S,1,rd]

    if cache is not None and S == 1:  # ---- decode (absorbed) ----
        positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                               device=x.device)
        q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
        k_pe = apply_rope(k_pe, positions, cfg.rope_theta)
        at = min(int(pos), cache["c_kv"].shape[1] - 1)
        cache["c_kv"][:, at:at + 1] = c_kv.to(cache["c_kv"].dtype)
        cache["k_pe"][:, at:at + 1] = k_pe[:, :, 0].to(cache["k_pe"].dtype)
        new_cache = cache
        ckv_c, kpe_c = cache["c_kv"], cache["k_pe"]
        if ckv_c.element_size() < 2:  # fp8 storage -> bf16 compute
            ckv_c = ckv_c.to(x.dtype)
            kpe_c = kpe_c.to(x.dtype)
        # absorb W_uk into the query: q_lat [B,H,L]
        q_lat = torch.einsum("bshk,lhk->bshl", q_nope, p["w_uk"])[:, 0]
        s = (torch.einsum("bhl,bsl->bhs", _f32(q_lat), _f32(ckv_c))
             + torch.einsum("bhk,bsk->bhs", _f32(q_pe[:, 0]),
                            _f32(kpe_c))) * scale
        Smax = ckv_c.shape[1]
        s = torch.where((torch.arange(Smax, device=x.device)
                         <= int(pos))[None, None], s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhs,bsl->bhl", _f32(pr.to(ckv_c.dtype)),
                             _f32(ckv_c))
        out = torch.einsum("bhl,lhv->bhv", o_lat.to(x.dtype), p["w_uv"])
        out = out[:, None]                                # [B,1,H,vd]
    else:  # ---- train / prefill (expanded) ----
        positions = _positions(B, S, x.device)
        q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
        k_pe = apply_rope(k_pe, positions, cfg.rope_theta)
        k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uk"])
        v = torch.einsum("bsl,lhv->bshv", c_kv, p["w_uv"])
        k_full = torch.cat([k_nope, k_pe.expand(B, S, H, rd)], dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        # pad v to qk head dim for the shared flash kernel, slice after
        v_pad = Fn.pad(v, (0, (nd + rd) - vd))
        out = flash_attention(q_full, k_full, v_pad)[..., :vd]
        if cache is not None:
            cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
            cache["k_pe"][:, :S] = k_pe[:, :, 0].to(cache["k_pe"].dtype)
            new_cache = cache
        else:
            new_cache = None

    y = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    return y, new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device="cuda"):
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=cfg.cache_jdtype, device=device),
            "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                dtype=cfg.cache_jdtype, device=device)}


# ---------------------------------------------------------------- SwiGLU ----
def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None):
    D = cfg.d_model
    Ff = d_ff or cfg.d_ff
    dt = cfg.jdtype
    return {
        "w_gate": _normal(gen, (D, Ff), dt, D ** -0.5),
        "w_up": _normal(gen, (D, Ff), dt, D ** -0.5),
        "w_down": _normal(gen, (Ff, D), dt, Ff ** -0.5),
    }


def mlp(p, x):
    h = Fn.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


__all__ = ["NEG_INF", "apply_rope", "attention", "decode_attention",
           "flash_attention", "init_attention", "init_kv_cache", "init_mla",
           "init_mla_cache", "init_mlp", "init_rms", "mla_attention", "mlp",
           "rms_norm", "rope_freqs", "set_unroll", "unroll"]
