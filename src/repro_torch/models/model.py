"""Family dispatch: one API over decoder-only and encoder-decoder models
(port of ``repro.models.model``). `loss_fn` gives the forward value of
the training loss; gradients and optimizer steps are not ported yet."""
from __future__ import annotations

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.common import ModelConfig

F32 = torch.float32


def _mod(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else transformer


def init(rng, cfg: ModelConfig, *, device="cuda"):
    """Parameters from `rng` (a ``torch.Generator`` or an int seed)."""
    return _mod(cfg).init(rng, cfg, device=device)


def forward(params, batch, cfg: ModelConfig, *, remat: bool = True,
            return_hidden: bool = False):
    return _mod(cfg).forward(params, batch, cfg, remat=remat,
                             return_hidden=return_hidden)


def prefill(params, batch, cfg: ModelConfig, max_len: int):
    return _mod(cfg).prefill(params, batch, cfg, max_len)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    return _mod(cfg).decode_step(params, cache, tokens, pos, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda"):
    return _mod(cfg).init_cache(cfg, batch, max_len, device=device)


def _ce_chunk(hc, labels_c, lm_head):
    """CE over one sequence chunk: (summed nll, valid count)."""
    logits = torch.einsum("bsd,dv->bsv", hc, lm_head).to(F32)
    valid = labels_c >= 0
    safe = torch.where(valid, labels_c, 0)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return (-torch.sum(torch.where(valid, ll, 0.0)),
            torch.sum(valid).to(F32))


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = True,
            aux_weight: float = 0.01, ce_chunk: int = 512):
    """Next-token cross-entropy (+ MoE aux), computed in sequence chunks so
    the full-vocab [B,S,V] logits never materialize at once. batch needs
    "tokens" and "labels" (-100 = ignore)."""
    h, aux = forward(params, batch, cfg, remat=remat, return_hidden=True)
    labels = batch["labels"]
    S = h.shape[1]
    c = ce_chunk if S % ce_chunk == 0 else S
    parts = [_ce_chunk(h[:, i:i + c], labels[:, i:i + c],
                       params["lm_head"]) for i in range(0, S, c)]
    nll = torch.stack([p[0] for p in parts])
    cnt = torch.stack([p[1] for p in parts])
    ce = torch.sum(nll) / torch.clamp_min(torch.sum(cnt), 1.0)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
