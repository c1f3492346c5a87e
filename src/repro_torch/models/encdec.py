"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``;
the audio frontend is a stub: callers pass precomputed frame embeddings).
Encoder: non-causal self-attention; decoder: causal self + cross
attention. One parameter dict per layer, in lists.
"""
from __future__ import annotations

import torch

from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.models import layers as Lyr
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import _head, _using, generator

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


def _shardings(cfg: ModelConfig, shardings=None):
    """`shardings` or, under a world mesh when None, those of `init`'s
    tree for `cfg` (``transformer._shardings``' counterpart)."""
    if shardings is None and shd.model_rules() is not None:
        shardings = shd.param_shardings(init(0, cfg, device="meta"))
    return shardings


def encode(params, enc_embeds, cfg: ModelConfig, *, remat=True,
           use=_using(None)):
    """enc_embeds [B, T_enc, D] (stub frontend output) -> [B, T_enc, D];
    with `remat` each layer is recomputed in the backward pass. `use`
    gathers a layer's leaves where it runs (``transformer._using``)."""
    def layer(lp, h, i):
        lp = use(lp, "enc_layers", i)
        a = Lyr.rms_norm(h, lp["ln1"]["scale"], cfg.norm_eps)
        a, _ = Lyr.attention(lp["attn"], a, cfg, causal=False)
        h = h + a
        m = Lyr.rms_norm(h, lp["ln2"]["scale"], cfg.norm_eps)
        return shd.constrain(h + Lyr.mlp(lp["mlp"], m), ("dp", "mp", None))

    h = enc_embeds.to(cfg.jdtype)
    for i, lp in enumerate(params["enc_layers"]):
        h = Lyr.remat(layer, lp, h, i, enabled=remat)
    return Lyr.rms_norm(h, use(params["enc_norm"], "enc_norm")["scale"],
                        cfg.norm_eps)


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
            return_hidden: bool = False, shardings=None):
    """Training forward: batch {"tokens": [B,S], "enc_embeds": [B,T,D]}.
    Returns (logits [B,S,V], aux=0); with `remat` each encoder and decoder
    layer is recomputed in the backward pass. Under a world mesh `params`
    is this rank's blocks (of `shardings`, or of ``dist.sharding
    .param_shardings`` of `init`'s tree): each layer's leaves are gathered
    where the layer runs, inside its remat, as in ``transformer.forward``."""
    use = _using(_shardings(cfg, shardings))
    enc_out = encode(params, batch["enc_embeds"], cfg, remat=remat, use=use)
    h = use(params["embed"], "embed")[batch["tokens"]]

    def layer(lp, h, i):
        h, _ = _dec_block(use(lp, "dec_layers", i), h, enc_out, cfg)
        return shd.constrain(h, ("dp", "mp", None))

    for i, lp in enumerate(params["dec_layers"]):
        h = Lyr.remat(layer, lp, h, i, enabled=remat)
    h = Lyr.rms_norm(h, use(params["final_norm"], "final_norm")["scale"],
                     cfg.norm_eps)
    aux = torch.zeros((), dtype=F32, device=h.device)
    if return_hidden:
        return h, aux
    logits = torch.einsum("bsd,dv->bsv", h, use(params["lm_head"],
                                                "lm_head"))
    return logits, aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda"):
    """The decoder's per-layer caches of `batch` rows and the encoder
    output; under a world mesh `batch` is this rank's rows and the encoder
    output this rank's block of every row's (`_enc_out_sharding`)."""
    enc = (batch, cfg.enc_len, cfg.d_model)
    rules = shd.model_rules()
    if rules is not None:
        enc = _enc_out_sharding(cfg).shard_shape(
            (batch * rules.axis_size("dp"),) + enc[1:])
    return {"dec": _dec_caches(cfg, batch, max_len, device),
            "enc_out": torch.zeros(enc, dtype=cfg.jdtype, device=device)}


def _dec_caches(cfg, batch, max_len, device):
    return [{"self": Lyr.init_kv_cache(cfg, batch, max_len, device)}
            for _ in range(cfg.n_layers)]


def _run_dec_stack(params, dec_cache, h, enc_out, cfg, pos, use):
    new_dec = []
    for i, (lp, lc) in enumerate(zip(params["dec_layers"], dec_cache)):
        h, nc = _dec_block(use(lp, "dec_layers", i), h, enc_out, cfg,
                           cache=lc, pos=pos)
        new_dec.append(nc)
    return h, new_dec


def _enc_out_sharding(cfg: ModelConfig):
    """The sharding of the cache's encoder output under the active world
    mesh: the reference's ``cache_shardings`` splits its axis 1 (the frames)
    over "dp" where that divides them, so a rank holds every row's block
    of frames."""
    return shd.cache_shardings({"enc_out": torch.empty(
        (1, cfg.enc_len, cfg.d_model), device="meta")}, cfg)["enc_out"]


def _data_group(cfg: ModelConfig, rows: int, n_rows: int):
    """The data axes' group and its size, when the cache's encoder output
    splits its frames over them (else None, 1); `rows` of `n_rows` must be
    this rank's even share."""
    rules = shd.model_rules()
    n = rules.axis_size("dp")
    if rows * n != n_rows:
        raise ValueError(f"{rows} rows of {n_rows} on this rank: the encoder "
                         f"output needs the rows split evenly over {n} data "
                         f"blocks")
    if _enc_out_sharding(cfg).entries(3)[1] is None:
        return None, 1
    return rules.mesh.group(rules.dp), n


def prefill(params, batch, cfg: ModelConfig, max_len: int, *,
            shardings=None):
    """Encode + run the decoder prompt. Returns (last logits, cache).
    Under a world mesh `params` is this rank's blocks and `batch` its rows,
    and each layer's leaves are gathered where it runs (as `forward`); the
    cache holds the decoder's caches of these rows and this rank's block
    of every row's encoder output (`_enc_out_sharding`; one all-to-all
    over the data axes, an all-gather where the frames are not split), so
    the rows must split evenly over the data axes."""
    use = _using(_shardings(cfg, shardings))
    h = use(params["embed"], "embed")[batch["tokens"]]
    dec_cache = _dec_caches(cfg, batch["tokens"].shape[0], max_len,
                            h.device)
    enc_out = encode(params, batch["enc_embeds"], cfg, remat=False, use=use)
    h, new_dec = _run_dec_stack(params, dec_cache, h, enc_out, cfg, 0, use)
    rules = shd.model_rules()
    if rules is not None and rules.dp:
        b = enc_out.shape[0]
        group, n = _data_group(cfg, b, b * rules.axis_size("dp"))
        if group is None:
            enc_out = coll.all_gather(enc_out, 0, rules.mesh.group(rules.dp))
        else:       # block j (frames j of my rows) to member j
            enc_out = coll.exchange(enc_out.unflatten(1, (n, -1))
                                    .transpose(0, 1).flatten(0, 1), group)
    return _head(params, h[:, -1:], cfg, use), {"dec": new_dec,
                                               "enc_out": enc_out}


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, *,
                shardings=None):
    """One decode step; under a world mesh as `prefill` (the encoder
    output of this rank's rows by one all-to-all from the cache's block of
    frames, or sliced where the frames are not split)."""
    use = _using(_shardings(cfg, shardings))
    h = use(params["embed"], "embed")[tokens]
    enc_out = mine = cache["enc_out"]
    if shd.model_rules() is not None:
        group, n = _data_group(cfg, tokens.shape[0], enc_out.shape[0])
        if group is None:
            mine = enc_out[shd.batch_rows(enc_out.shape[0])]
        else:       # block j: member j's frames of my rows
            mine = coll.exchange(enc_out, group).unflatten(0, (n, -1)) \
                .transpose(0, 1).flatten(1, 2)
    h, new_dec = _run_dec_stack(params, cache["dec"], h, mine, cfg, pos,
                                use)
    return _head(params, h, cfg, use), {"dec": new_dec, "enc_out": enc_out}
