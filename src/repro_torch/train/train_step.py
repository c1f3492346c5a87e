"""Training step (port of ``repro.train.train_step``): loss, gradients by
``torch.autograd`` and AdamW, with optional microbatch gradient
accumulation and optional bf16 gradient compression.

The step is a pure function of its arguments: it differentiates
``models.model.loss_fn`` with respect to detached copies of the
parameter leaves (sharing their storage), so the caller's tensors are
never modified, and it returns new parameters and a new ``OptState``. No
optimizer state is kept anywhere else.

Under a world mesh (``dist.sharding``) it is the same function on this
rank's blocks: params and optimizer state placed by ``dist.sharding
.device_put`` under ``models.model.param_shardings(cfg)``, the batch by
``batch_shardings``. Each rank runs ``loss_fn`` on its rows (ranks of one
model column group hold the same rows); each layer's leaves are gathered
where the layer runs, the gathers' backward passes reduce-scatter the
gradients over the data axes, and a replicated leaf's gradient is summed
over the ranks that saw other rows. The loss is the global token mean,
and AdamW runs on the blocks with the global gradient norm.
"""
from __future__ import annotations

import torch

from repro_torch import _numerics
from repro_torch.dist import sharding as shd
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt_lib

F32 = torch.float32


def make_train_step(cfg, opt_cfg: opt_lib.AdamWConfig = opt_lib.AdamWConfig(),
                    *, microbatches: int = 1, remat: bool = True,
                    compress_grads: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    batch leaves have leading dim global_batch; with microbatches > 1 the
    batch splits into `microbatches` consecutive slices whose gradients
    accumulate in f32, in order (the reference's scan)."""

    def value_and_grad(params, batch, shardings):
        flat = [p.detach().requires_grad_(True)
                for p in opt_lib.leaves(params)]
        with torch.enable_grad():
            l, parts = M.loss_fn(opt_lib.unflatten(params, flat), batch, cfg,
                                 remat=remat, shardings=shardings)
            grads = torch.autograd.grad(l, flat, materialize_grads=True)
        return l.detach(), {k: v.detach() for k, v in parts.items()}, grads

    def compute_grads(params, batch, shardings):
        if microbatches == 1:
            return value_and_grad(params, batch, shardings)

        def split(x, i):
            n = x.shape[0] // microbatches
            return x[i * n:(i + 1) * n]

        acc = lsum = None      # the accumulators are the step's own
        for i in range(microbatches):
            l, _, g = value_and_grad(
                params, {k: split(v, i) for k, v in batch.items()},
                shardings)
            if compress_grads:  # bf16 DP reduction, f32 accumulation
                g = [x.to(torch.bfloat16) for x in g]
            if acc is None:
                acc, lsum = [x.to(F32) for x in g], l
            else:
                for a, x in zip(acc, g):
                    a.add_(x.to(F32))
                lsum = lsum + l
        inv = _numerics.recip(microbatches)
        for a in acc:
            a.mul_(inv)
        loss = lsum * inv
        zero = torch.zeros((), dtype=F32, device=loss.device)
        return loss, {"ce": loss, "aux": zero}, acc

    def train_step(params, opt_state, batch):
        shardings = None
        if shd.model_rules() is not None:
            full = M.init(0, cfg, device="meta")
            shardings = shd.param_shardings(full)
            shd.check_placed(params, shardings, full)
        l, parts, flat_grads = compute_grads(params, batch, shardings)
        grads = opt_lib.unflatten(params, flat_grads)
        new_params, new_opt, gnorm = opt_lib.apply(
            grads, params, opt_state, opt_cfg, shardings=shardings)
        metrics = {"loss": l, "grad_norm": gnorm, **parts}
        return new_params, new_opt, metrics

    return train_step
