"""Family dispatch: one API over decoder-only and encoder-decoder models
(port of ``repro.models.model``). `loss_fn` is differentiated by
``torch.autograd`` in ``train.train_step``. Under a world mesh
(``dist.sharding``) every entry point takes this rank's blocks of the
parameters and its rows of the batch (and of the cache); the loss is the
global token mean."""
from __future__ import annotations

import torch

from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.models import encdec, transformer
from repro_torch.models import layers as Lyr
from repro_torch.models.common import ModelConfig

F32 = torch.float32


def _mod(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else transformer


def init(rng, cfg: ModelConfig, *, device="cuda"):
    """Parameters from `rng` (a ``torch.Generator`` or an int seed)."""
    return _mod(cfg).init(rng, cfg, device=device)


def forward(params, batch, cfg: ModelConfig, *, remat: bool = True,
            return_hidden: bool = False, shardings=None):
    return _mod(cfg).forward(params, batch, cfg, remat=remat,
                             return_hidden=return_hidden,
                             shardings=shardings)


def param_shardings(cfg: ModelConfig):
    """``dist.sharding.param_shardings`` of `init`'s tree for `cfg` under
    the active mesh (shapes only, on the meta device)."""
    return shd.param_shardings(init(0, cfg, device="meta"))


def prefill(params, batch, cfg: ModelConfig, max_len: int, *,
            shardings=None):
    """(last-token logits, cache) of a prompt. Under a world mesh `params`
    is this rank's blocks (of `shardings`: `param_shardings` when None)
    and `batch` its rows; the cache holds its blocks under
    ``dist.sharding.cache_shardings`` and the logits are its rows."""
    return _mod(cfg).prefill(params, batch, cfg, max_len,
                             shardings=shardings)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, *,
                shardings=None):
    """(logits [B,1,V], cache) of one decode step; under a world mesh as
    `prefill`."""
    return _mod(cfg).decode_step(params, cache, tokens, pos, cfg,
                                 shardings=shardings)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda"):
    """An empty cache of `batch` rows (under a world mesh: this rank's
    rows, its blocks under ``dist.sharding.cache_shardings``)."""
    return _mod(cfg).init_cache(cfg, batch, max_len, device=device)


def _ce_chunk(hc, labels_c, lm_head):
    """CE over one sequence chunk: (summed nll, valid count); rematted
    when the loss has several chunks, so the logits never persist."""
    logits = torch.einsum("bsd,dv->bsv", hc, lm_head).to(F32)
    valid = labels_c >= 0
    safe = torch.where(valid, labels_c, 0)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return (-torch.sum(torch.where(valid, ll, 0.0)),
            torch.sum(valid).to(F32))


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = True,
            aux_weight: float = 0.01, ce_chunk: int = 512, shardings=None):
    """Next-token cross-entropy (+ MoE aux), computed in sequence chunks so
    the full-vocab [B,S,V] logits never materialize at once. batch needs
    "tokens" and "labels" (-100 = ignore).

    Under a world mesh (`shardings`: the parameters', `param_shardings`
    when None) the cross-entropy is the global token mean: this rank's
    summed nll over the token count of every rank's rows, summed over the
    data axes."""
    rules = shd.model_rules()
    if rules is not None and shardings is None:
        shardings = param_shardings(cfg)
    h, aux = forward(params, batch, cfg, remat=remat, return_hidden=True,
                     shardings=shardings)
    lm_head = params["lm_head"] if rules is None else \
        shd.gather_for_use(params["lm_head"], shardings["lm_head"])
    labels = batch["labels"]
    S = h.shape[1]
    c = ce_chunk if S % ce_chunk == 0 else S
    chunked = remat and S // c > 1
    parts = [Lyr.remat(_ce_chunk, h[:, i:i + c], labels[:, i:i + c],
                       lm_head, enabled=chunked)
             for i in range(0, S, c)]
    nll = torch.sum(torch.stack([p[0] for p in parts]))
    cnt = torch.sum(torch.stack([p[1] for p in parts]))
    if rules is not None and rules.dp:
        dp_group = rules.mesh.group(rules.dp)
        nll = coll.sum_replicated(nll, dp_group)
        cnt = coll.all_reduce(cnt.detach(), dp_group)
    ce = nll / torch.clamp_min(cnt, 1.0)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
