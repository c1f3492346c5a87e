"""The port's gradients against the JAX reference's on the CPU, for every
arch at ``smoke_config`` in f32.

The reference's initialized parameters are carried across
(``interop.params_from_reference``), the same NumPy-seeded tokens, labels
and stub-frontend embeddings go through both packages, and the port's
``torch.autograd`` gradients of ``models.model.loss_fn`` are held against
``jax.grad`` of the reference's (jitted), leaf by leaf through the
layout mapping (the reference's layer-stacked gradients are unstacked as
its parameters are), at rtol 1e-4 / atol 1e-5 of each leaf's largest
entry: the forward's 1e-4 (``test_torch_models.py``). The loss is held at
rtol 1e-4. ``remat=True`` (each layer and each flash query chunk
recomputed in the backward pass) and ``remat=False`` give bitwise-equal
gradients on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import model as RM
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt_lib

B, S = 2, 16


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", cache_dtype="float32")


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
              "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    arrays["labels"][0, :3] = -100             # ignored positions
    if cfg.n_img_tokens:
        arrays["img_embeds"] = rng.normal(
            size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        arrays["enc_embeds"] = rng.normal(
            size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.as_tensor(v) for k, v in arrays.items()})


def _grads(params, batch, cfg, remat):
    flat = [p.detach().requires_grad_(True)
            for p in opt_lib.leaves(params)]
    loss, _ = M.loss_fn(opt_lib.unflatten(params, flat), batch, cfg,
                        remat=remat)
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    return float(loss.detach()), grads


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grads_match_reference(arch):
    rcfg = _f32(ref_smoke_config(ref_get_config(arch)))
    cfg = _f32(smoke_config(get_config(arch)))
    rparams = RM.init(jax.random.PRNGKey(0), rcfg)
    rb, pb = _inputs(cfg)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, b, rcfg), has_aux=True))(rparams, rb)
    params = interop.params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    want = interop.params_from_reference(
        jax.tree.map(np.asarray, rgrads), cfg, device="cpu")
    loss, grads = _grads(params, pb, cfg, remat=True)
    np.testing.assert_allclose(loss, float(rloss), rtol=1e-4)
    want = opt_lib.leaves(want)
    assert len(grads) == len(want)
    for i, (got, exp) in enumerate(zip(grads, want)):
        exp = exp.numpy()
        assert got.shape == exp.shape
        np.testing.assert_allclose(
            got.numpy(), exp, rtol=1e-4,
            atol=1e-5 * max(np.abs(exp).max(), 1e-30), err_msg=f"leaf {i}")
    loss2, plain = _grads(params, pb, cfg, remat=False)
    assert loss2 == loss
    assert all(torch.equal(a, b) for a, b in zip(grads, plain))
