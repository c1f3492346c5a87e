"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``;
the audio frontend is a stub: callers pass precomputed frame embeddings).
Encoder: non-causal self-attention; decoder: causal self + cross
attention. One parameter dict per layer, in lists.
"""
from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd
from repro_torch.models import layers as Lyr
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import generator

F32 = torch.float32


def _init_enc_layer(gen, cfg):
    dev = gen.device
    return {"ln1": Lyr.init_rms(cfg.d_model, dev),
            "ln2": Lyr.init_rms(cfg.d_model, dev),
            "attn": Lyr.init_attention(gen, cfg),
            "mlp": Lyr.init_mlp(gen, cfg)}


def _init_dec_layer(gen, cfg):
    dev = gen.device
    return {"ln1": Lyr.init_rms(cfg.d_model, dev),
            "ln2": Lyr.init_rms(cfg.d_model, dev),
            "ln3": Lyr.init_rms(cfg.d_model, dev),
            "self_attn": Lyr.init_attention(gen, cfg),
            "cross_attn": Lyr.init_attention(gen, cfg),
            "mlp": Lyr.init_mlp(gen, cfg)}


def init(rng, cfg: ModelConfig, *, device="cuda"):
    gen = generator(rng, device)
    dev = gen.device
    return {
        "embed": Lyr._normal(gen, (cfg.vocab, cfg.d_model), cfg.jdtype,
                             0.02),
        "enc_layers": [_init_enc_layer(gen, cfg)
                       for _ in range(cfg.n_enc_layers)],
        "dec_layers": [_init_dec_layer(gen, cfg)
                       for _ in range(cfg.n_layers)],
        "enc_norm": Lyr.init_rms(cfg.d_model, dev),
        "final_norm": Lyr.init_rms(cfg.d_model, dev),
        "lm_head": Lyr._normal(gen, (cfg.d_model, cfg.vocab), cfg.jdtype,
                               cfg.d_model ** -0.5),
    }


def encode(params, enc_embeds, cfg: ModelConfig, *, remat=True):
    """enc_embeds [B, T_enc, D] (stub frontend output) -> [B, T_enc, D]."""
    del remat
    h = enc_embeds.to(cfg.jdtype)
    for lp in params["enc_layers"]:
        a = Lyr.rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps)
        a, _ = Lyr.attention(lp["attn"], a, cfg, causal=False)
        h = h + a
        m = Lyr.rms_norm(h, lp["ln2"]["scale"], cfg.norm_eps)
        h = shd.constrain(h + Lyr.mlp(lp["mlp"], m), ("dp", "mp", None))
    return Lyr.rms_norm(h, params["enc_norm"]["scale"], cfg.norm_eps)


def _dec_block(lp, h, enc_out, cfg, *, cache=None, pos=None):
    a = Lyr.rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps)
    self_cache = None if cache is None else cache["self"]
    a, new_self = Lyr.attention(lp["self_attn"], a, cfg, cache=self_cache,
                                pos=pos)
    h = h + a
    c = Lyr.rms_norm(h, lp["ln2"]["scale"], cfg.norm_eps)
    c, _ = Lyr.attention(lp["cross_attn"], c, cfg, kv_x=enc_out,
                         causal=False, use_rope=False)
    h = h + c
    m = Lyr.rms_norm(h, lp["ln3"]["scale"], cfg.norm_eps)
    h = h + Lyr.mlp(lp["mlp"], m)
    new_cache = None if cache is None else {"self": new_self}
    return h, new_cache


def forward(params, batch, cfg: ModelConfig, *, remat=True,
            return_hidden: bool = False):
    """Training forward: batch {"tokens": [B,S], "enc_embeds": [B,T,D]}.
    Returns (logits [B,S,V], aux=0)."""
    enc_out = encode(params, batch["enc_embeds"], cfg, remat=remat)
    h = params["embed"][batch["tokens"]]
    for lp in params["dec_layers"]:
        h, _ = _dec_block(lp, h, enc_out, cfg)
        h = shd.constrain(h, ("dp", "mp", None))
    h = Lyr.rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    aux = torch.zeros((), dtype=F32, device=h.device)
    if return_hidden:
        return h, aux
    logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"])
    return logits, aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda"):
    return {"dec": [{"self": Lyr.init_kv_cache(cfg, batch, max_len, device)}
                    for _ in range(cfg.n_layers)],
            "enc_out": torch.zeros((batch, cfg.enc_len, cfg.d_model),
                                   dtype=cfg.jdtype, device=device)}


def _run_dec_stack(params, dec_cache, h, enc_out, cfg, pos):
    new_dec = []
    for lp, lc in zip(params["dec_layers"], dec_cache):
        h, nc = _dec_block(lp, h, enc_out, cfg, cache=lc, pos=pos)
        new_dec.append(nc)
    return h, new_dec


def prefill(params, batch, cfg: ModelConfig, max_len: int):
    """Encode + run the decoder prompt. Returns (last logits, cache)."""
    h = params["embed"][batch["tokens"]]
    cache = init_cache(cfg, batch["tokens"].shape[0], max_len,
                       device=h.device)
    enc_out = encode(params, batch["enc_embeds"], cfg, remat=False)
    h, new_dec = _run_dec_stack(params, cache["dec"], h, enc_out, cfg, 0)
    h = Lyr.rms_norm(h[:, -1:], params["final_norm"]["scale"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"])
    return logits, {"dec": new_dec, "enc_out": enc_out}


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    h = params["embed"][tokens]
    enc_out = cache["enc_out"]
    h, new_dec = _run_dec_stack(params, cache["dec"], h, enc_out, cfg, pos)
    h = Lyr.rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"])
    return logits, {"dec": new_dec, "enc_out": enc_out}
