"""Unified decoder-only model covering the dense / moe_mla / moe_gqa /
ssm / hybrid / vlm families (port of ``repro.models.transformer``).

The reference stacks its layers for ``lax.scan``; the port keeps one
parameter dict (and one cache dict) per layer in a list and loops over
them in Python (``interop.params_from_reference`` unstacks the
reference's arrays).

API:
    init(gen, cfg)                    -> params
    forward(params, batch, cfg)       -> (logits, aux)
    prefill(params, tokens, cfg, L)   -> (logits_last, cache)
    decode_step(params, cache, tok, pos, cfg) -> (logits, cache)

`decode_step` and `prefill` write the attention caches in place (see
``layers``); the returned cache dict holds the same tensors.
"""
from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd
from repro_torch.models import layers as Lyr
from repro_torch.models import moe as Moe
from repro_torch.models import ssm as Ssm
from repro_torch.models.common import ModelConfig

F32 = torch.float32


class _ShapesOnly:
    """The generator of a meta-device init: ``layers._normal`` draws
    nothing from it (``torch.Generator`` has no meta device)."""
    device = torch.device("meta")


def generator(rng, device="cuda") -> torch.Generator:
    """`rng` as a ``torch.Generator`` on `device`: a generator passes
    through, an int seeds a new one. On the meta device (``launch.specs``)
    parameters get their shapes and dtypes only."""
    if isinstance(rng, (torch.Generator, _ShapesOnly)):
        return rng
    if torch.device(device).type == "meta":
        return _ShapesOnly()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng))
    return gen


# ----------------------------------------------------------------- blocks ----
def init_block(gen: torch.Generator, cfg: ModelConfig, *,
               dense_ff: bool = False):
    """One residual block's params for the given family."""
    dev = gen.device
    if cfg.family in ("ssm", "hybrid"):
        return {"norm": Lyr.init_rms(cfg.d_model, dev),
                "mixer": Ssm.init_mamba2(gen, cfg)}
    p = {"ln1": Lyr.init_rms(cfg.d_model, dev),
         "ln2": Lyr.init_rms(cfg.d_model, dev)}
    if cfg.family == "moe_mla":
        p["attn"] = Lyr.init_mla(gen, cfg)
    else:
        p["attn"] = Lyr.init_attention(gen, cfg)
    if cfg.family in ("moe_mla", "moe_gqa") and not dense_ff:
        p["moe"] = Moe.init_moe(gen, cfg)
    else:
        ff = cfg.d_ff_dense if (dense_ff and cfg.d_ff_dense) else cfg.d_ff
        p["mlp"] = Lyr.init_mlp(gen, cfg, d_ff=ff)
    return p


def block_forward(p, x, cfg: ModelConfig, *, cache=None, pos=None,
                  dense_ff: bool = False):
    """Residual block. Returns (x, aux, new_cache)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        h, new_cache = Ssm.mamba2_block(
            p["mixer"], Lyr.rms_norm(x, p["norm"]["scale"], cfg.norm_eps),
            cfg, cache=cache, pos=pos)
        return x + h, aux, new_cache

    h = Lyr.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    if cfg.family == "moe_mla":
        h, attn_cache = Lyr.mla_attention(p["attn"], h, cfg, cache=cache,
                                          pos=pos)
    else:
        h, attn_cache = Lyr.attention(p["attn"], h, cfg, cache=cache,
                                      pos=pos)
    x = x + h
    h = Lyr.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    if "moe" in p:
        h, aux = Moe.moe_block(p["moe"], h, cfg)
    else:
        h = Lyr.mlp(p["mlp"], h)
    return x + h, aux, attn_cache


# ------------------------------------------------------------------ model ----
def _n_scan_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers - cfg.first_k_dense


def init(rng, cfg: ModelConfig, *, device="cuda"):
    """Random parameters drawn from `rng` (a ``torch.Generator``, whose
    device they take, or an int seed for a generator on `device`)."""
    gen = generator(rng, device)
    dev = gen.device
    params = {
        "embed": Lyr._normal(gen, (cfg.vocab, cfg.d_model), cfg.jdtype,
                             0.02),
        "final_norm": Lyr.init_rms(cfg.d_model, dev),
        "lm_head": Lyr._normal(gen, (cfg.d_model, cfg.vocab), cfg.jdtype,
                               cfg.d_model ** -0.5),
    }
    # leading dense layers of MoE archs
    if cfg.first_k_dense:
        params["dense_layers"] = [init_block(gen, cfg, dense_ff=True)
                                  for _ in range(cfg.first_k_dense)]
    params["layers"] = [init_block(gen, cfg)
                        for _ in range(_n_scan_layers(cfg))]
    if cfg.family == "hybrid" and cfg.attn_every:
        params["shared_attn"] = {
            "ln1": Lyr.init_rms(cfg.d_model, dev),
            "ln2": Lyr.init_rms(cfg.d_model, dev),
            "attn": Lyr.init_attention(gen, cfg),
            "mlp": Lyr.init_mlp(gen, cfg),
        }
    return params


def _shared_attn_block(sp, x, cfg, *, cache=None, pos=None):
    h = Lyr.rms_norm(x, sp["ln1"]["scale"], cfg.norm_eps)
    h, new_cache = Lyr.attention(sp["attn"], h, cfg, cache=cache, pos=pos)
    x = x + h
    h = Lyr.rms_norm(x, sp["ln2"]["scale"], cfg.norm_eps)
    return x + Lyr.mlp(sp["mlp"], h), new_cache


def _embed_inputs(params, batch, cfg: ModelConfig):
    """tokens (+ optional stub-frontend embeddings) -> h [B, S_total, D]."""
    h = params["embed"][batch["tokens"]]
    if cfg.n_img_tokens and "img_embeds" in batch:
        h = torch.cat([batch["img_embeds"].to(h.dtype), h], dim=1)
    return h


def _shardings(cfg: ModelConfig, shardings=None):
    """`shardings` or, under a world mesh (``dist.sharding.model_rules``)
    when None, ``dist.sharding.param_shardings`` of `init`'s tree for
    `cfg` (shapes only); None without one."""
    if shardings is None and shd.model_rules() is not None:
        shardings = shd.param_shardings(init(0, cfg, device="meta"))
    return shardings


def _using(shardings):
    """`use(tree, *keys)`: the subtree `tree` of the parameters, at `keys`
    of their tree, as the model uses it (``dist.sharding.gather_for_use``
    under the shardings at those keys; `tree` itself without them)."""
    def use(tree, *keys):
        sh = shardings
        for k in keys:
            sh = None if sh is None else sh[k]
        return tree if sh is None else shd.gather_for_use(tree, sh)
    return use


def forward(params, batch, cfg: ModelConfig, *, remat: bool = True,
            return_hidden: bool = False, shardings=None):
    """Training forward. batch {"tokens": [B,S], ...} -> (logits, aux),
    or (hidden, aux) with return_hidden=True. With `remat` each layer of
    the stack (and the shared attention applied after it) is recomputed
    in the backward pass, as the reference's checkpointed scan body.

    Under a world mesh `params` is this rank's blocks and `batch` its
    rows, `shardings` the tree's (computed from `cfg` when None): each
    layer's leaves are gathered where the layer runs, inside its remat,
    so a recompute gathers them again and no more than a layer's full
    parameters exist at a time."""
    use = _using(_shardings(cfg, shardings))
    embed = use(params["embed"], "embed")
    h = shd.constrain(_embed_inputs({"embed": embed}, batch, cfg),
                      ("dp", None, None))
    aux_total = torch.zeros((), dtype=F32, device=h.device)

    for i, dp in enumerate(params.get("dense_layers", [])):
        h, aux, _ = block_forward(use(dp, "dense_layers", i), h, cfg,
                                  dense_ff=True)
        aux_total = aux_total + aux

    shared = params.get("shared_attn")

    def layer(lp, h, i):
        h, aux, _ = block_forward(use(lp, "layers", i), h, cfg)
        if shared is not None and cfg.attn_every \
                and (i + 1) % cfg.attn_every == 0:
            h, _ = _shared_attn_block(use(shared, "shared_attn"), h, cfg)
        return h, aux

    for i, lp in enumerate(params["layers"]):
        h, aux = Lyr.remat(layer, lp, h, i, enabled=remat)
        aux_total = aux_total + aux

    h = Lyr.rms_norm(h, use(params["final_norm"], "final_norm")["scale"],
                     cfg.norm_eps)
    if cfg.n_img_tokens and "img_embeds" in batch:
        h = h[:, batch["img_embeds"].shape[1]:]   # loss on text positions
    if return_hidden:
        return h, aux_total
    logits = torch.einsum("bsd,dv->bsv", h, use(params["lm_head"],
                                                "lm_head"))
    return logits, aux_total


# ------------------------------------------------------------------ cache ----
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda"):
    """Per-layer cache list (+ shared-attn caches for hybrid)."""
    def one_layer():
        if cfg.family in ("ssm", "hybrid"):
            return Ssm.init_ssm_cache(cfg, batch, device)
        if cfg.family == "moe_mla":
            return Lyr.init_mla_cache(cfg, batch, max_len, device)
        return Lyr.init_kv_cache(cfg, batch, max_len, device)

    n_scan = _n_scan_layers(cfg)
    cache = {"layers": [one_layer() for _ in range(n_scan)]}
    if cfg.first_k_dense:
        cache["dense_layers"] = [one_layer()
                                 for _ in range(cfg.first_k_dense)]
    if cfg.family == "hybrid" and cfg.attn_every:
        cache["shared"] = [Lyr.init_kv_cache(cfg, batch, max_len, device)
                           for _ in range(n_scan // cfg.attn_every)]
    return cache


def _run_layers(params, layer_cache: list, h, cfg, *, start: int,
                count: int, pos):
    for li in range(start, start + count):
        h, _, layer_cache[li] = block_forward(
            params["layers"][li], h, cfg, cache=layer_cache[li], pos=pos)
    return h


def _run_stack_with_cache(params, cache, h, cfg: ModelConfig, pos):
    """Layer stack + (for hybrid) block-structured shared attention with
    per-application caches. Returns (h, new_cache)."""
    shared = params.get("shared_attn")
    n_scan = _n_scan_layers(cfg)
    new_cache = dict(cache)
    layer_cache = list(cache["layers"])
    new_cache["layers"] = layer_cache

    if shared is not None and cfg.attn_every:
        ae = cfg.attn_every
        n_apps = n_scan // ae
        shared_cache = list(cache["shared"])
        for app in range(n_apps):
            h = _run_layers(params, layer_cache, h, cfg, start=app * ae,
                            count=ae, pos=pos)
            h, shared_cache[app] = _shared_attn_block(
                shared, h, cfg, cache=shared_cache[app], pos=pos)
        tail = n_scan - n_apps * ae
        if tail:
            h = _run_layers(params, layer_cache, h, cfg, start=n_apps * ae,
                            count=tail, pos=pos)
        new_cache["shared"] = shared_cache
        return h, new_cache

    h = _run_layers(params, layer_cache, h, cfg, start=0, count=n_scan,
                    pos=pos)
    return h, new_cache


def _dense_with_cache(params, cache, h, cfg, pos):
    new_dense = []
    for dp, dc in zip(params.get("dense_layers", []),
                      cache.get("dense_layers", [])):
        h, _, nc = block_forward(dp, h, cfg, cache=dc, pos=pos,
                                 dense_ff=True)
        new_dense.append(nc)
    return h, new_dense


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step. tokens [B,1] int, pos int.
    Returns (logits [B,1,V], new_cache)."""
    h = params["embed"][tokens]
    h, new_dense = _dense_with_cache(params, cache, h, cfg, pos)
    h, new_cache = _run_stack_with_cache(params, cache, h, cfg, pos)
    if new_dense:
        new_cache["dense_layers"] = new_dense
    h = Lyr.rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"])
    return logits, new_cache


def prefill(params, batch, cfg: ModelConfig, max_len: int):
    """Populate a cache from a prompt. Returns (last-token logits, cache)."""
    h = shd.constrain(_embed_inputs(params, batch, cfg), ("dp", None, None))
    cache = init_cache(cfg, batch["tokens"].shape[0], max_len,
                       device=h.device)
    h, new_dense = _dense_with_cache(params, cache, h, cfg, 0)
    h, new_cache = _run_stack_with_cache(params, cache, h, cfg, pos=0)
    if new_dense:
        new_cache["dense_layers"] = new_dense
    h = Lyr.rms_norm(h[:, -1:], params["final_norm"]["scale"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"])
    return logits, new_cache
