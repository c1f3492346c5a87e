"""Meta-device stand-ins for every model input, parameter, optimizer state
and cache (port of ``repro.launch.specs``: ``ShapeDtypeStruct`` becomes a
tensor on the ``meta`` device, which has a shape and a dtype and holds no
memory), plus the functions the dry run traces: train_step / prefill /
decode.

Under an active world mesh (``launch.dryrun`` traces under
``dist.sharding.Mesh.over_shapes``) `step_fn`'s arguments are one rank's:
its blocks of the parameters and optimizer state, its rows of the batch
(``batch_shardings``) and its cache at the local batch (``init_cache`` of
its rows: its blocks under ``cache_shardings``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.dist import sharding as shd
from repro_torch.models import model as M
from repro_torch.models.common import ModelConfig
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import make_train_step

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors for the model-input batch of a given shape cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        n_text = S - (cfg.n_img_tokens or 0)
        batch = {"tokens": _sds((B, n_text), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _sds((B, n_text), torch.int32)
        if cfg.n_img_tokens:
            batch["img_embeds"] = _sds((B, cfg.n_img_tokens, cfg.d_model),
                                       cfg.jdtype)
        if cfg.family == "encdec":
            batch["enc_embeds"] = _sds((B, cfg.enc_len, cfg.d_model),
                                       cfg.jdtype)
        return batch
    # decode: one new token against a seq_len-deep cache
    return {"tokens": _sds((B, 1), torch.int32)}


def param_specs(cfg: ModelConfig):
    return M.init(0, cfg, device=META)


def opt_specs(cfg: ModelConfig):
    return opt_lib.init(param_specs(cfg))


def cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    """Decode-shape KV/state cache meta tensors (seq_len deep)."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def train_microbatches(cfg: ModelConfig, shape: ShapeSpec,
                       dp_size: int, *, stash_budget: float = 2e9) -> int:
    """Gradient-accumulation depth chosen so the per-device remat stash
    (n_layers x live-tokens x d_model x 2B) fits the budget. Power of two,
    capped so each microbatch still has >= 1 sequence per data shard."""
    tokens_loc = shape.global_batch * shape.seq_len / max(dp_size, 1)
    width = cfg.d_model * (cfg.expand if cfg.family in ("ssm", "hybrid")
                           else 1)
    stash = cfg.n_layers * tokens_loc * width * 2.0
    mb, cap = 1, max(shape.global_batch // max(dp_size, 1), 1)
    while stash / mb > stash_budget and mb < cap:
        mb *= 2
    return mb


def step_fn(cfg: ModelConfig, shape: ShapeSpec, *, dp_size: int = 16,
            microbatches: int | None = None):
    """The function a dry-run cell traces, plus its meta args (one
    rank's under a world mesh: see the module docstring)."""
    rules = shd.model_rules()
    params = param_specs(cfg)
    sh = None
    if rules is not None:
        sh = shd.param_shardings(params)
        params = shd.device_put(params, sh)

    def rows(tree):
        return tree if rules is None else \
            shd.device_put(tree, shd.batch_shardings(tree))

    if shape.kind == "train":
        mb = (microbatches if microbatches is not None
              else train_microbatches(cfg, shape, dp_size))
        ts = make_train_step(cfg, microbatches=mb)
        return ts, (params, opt_lib.init(params),
                    rows(input_specs(cfg, shape)))
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return M.prefill(params, batch, cfg, max_len=shape.seq_len,
                             shardings=sh)
        return prefill_fn, (params, rows(input_specs(cfg, shape)))

    def decode_fn(params, cache, tokens):
        return M.decode_step(params, cache, tokens, shape.seq_len - 1, cfg,
                             shardings=sh)
    mine = shd.batch_rows(shape.global_batch)
    cache = M.init_cache(cfg, mine.stop - mine.start, shape.seq_len,
                         device=META)
    return decode_fn, (params, cache,
                       rows(input_specs(cfg, shape))["tokens"])
