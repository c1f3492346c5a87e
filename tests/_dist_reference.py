"""The reference's sharded results for the port's model-sharding tests
(``tests/test_torch_dist_*.py``), computed in a subprocess of its own:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_dist_reference.py {moe|train} OUT.npz [ARCH ...]

The mesh is built here as ``jax.sharding.Mesh`` over the forced host
devices, whose axes are Auto (``jax.make_mesh`` gives Explicit axes under
jax 0.9.0, on which the reference's sharded step fails). Inputs are drawn
here from NumPy seeds and written beside the results, so the port starts
from the same arrays. Nothing of ``repro`` is changed.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config, smoke_config
from repro.dist import sharding as shd
from repro.models import model as M
from repro.models.common import ModelConfig
from repro.models.moe import init_moe, moe_block_ep, moe_block_scatter
from repro.train import optimizer as opt_lib
from repro.train.train_step import make_train_step

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MOE_CFG = dict(name="t", family="moe_gqa", n_layers=1, d_model=16,
               n_heads=4, d_ff=32, vocab=8, n_experts=8, top_k=2,
               d_ff_expert=32, n_shared_experts=1, dtype="float32")
MOE_X = (4, 64, 16)                  # [B, S, D]: 256 tokens
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
TRAIN_BATCH = (8, 32)


def run(what: str, out, *args) -> dict:
    """This script in a subprocess with 8 forced host devices; its npz
    as a dict (called by the tests)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        ROOT, "src"), XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, os.path.abspath(__file__), what,
                          str(out), *args], env=env, capture_output=True,
                         text=True, timeout=300)
    if res.returncode:
        raise RuntimeError(res.stderr[-3000:])
    with np.load(out) as z:
        return dict(z)


def mesh(shape):
    n = shape[0] * shape[1]
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             ("data", "model"))


def _flat(prefix, tree, out):
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        out[f"{prefix}{i}"] = np.asarray(leaf)


def moe(path):
    """moe_block_ep on a 2 x 2 mesh at capacity factors 8 and 1: the
    output, the aux loss and the gradients of sum(out * w) + aux with
    respect to the params and x; moe_block_scatter at factor 8."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=MOE_X).astype(np.float32)
    w = rng.normal(size=MOE_X).astype(np.float32)
    out = {"x": x, "w": w}
    m = mesh((2, 2))
    shd.set_mesh(m)
    for cf in (8.0, 1.0):
        cfg = ModelConfig(capacity_factor=cf, **MOE_CFG)
        p = init_moe(jax.random.PRNGKey(0), cfg)
        if cf == 8.0:
            _flat("p", p, out)
            ref, _ = jax.jit(lambda p, x: moe_block_scatter(p, x, cfg))(p, x)
            out["scatter"] = np.asarray(ref)

        def f(p, x):
            y, aux = moe_block_ep(p, x, cfg)
            return jnp.sum(y * w) + aux, (y, aux)
        with m:
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(p, x)
        tag = f"cf{int(cf)}_"
        out[tag + "out"] = np.asarray(y)
        out[tag + "aux"] = np.asarray(aux)
        out[tag + "gx"] = np.asarray(gx)
        _flat(tag + "gp", gp, out)
    np.savez(path, **out)


def train(path, archs):
    """One train step of each smoke config (f32, remat off), from the
    reference's init at PRNGKey(0), on each mesh: loss, grad_norm, the
    new params and optimizer state (an encoder-decoder's batch also holds
    frame embeddings drawn here)."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, TRAIN_BATCH).astype(np.int32)
    out = {"tokens": toks}
    for arch in archs:
        cfg = dataclasses.replace(smoke_config(get_config(arch)),
                                  dtype="float32", cache_dtype="float32")
        params = M.init(jax.random.PRNGKey(0), cfg)
        opt = opt_lib.init(params)
        batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
        if cfg.n_enc_layers:        # the stub frontend's frame embeddings
            emb = np.random.default_rng(2).normal(size=(
                TRAIN_BATCH[0], cfg.enc_len, cfg.d_model)).astype(np.float32)
            out[f"{arch}/enc_embeds"] = emb
            batch["enc_embeds"] = jnp.asarray(emb)
        ts = make_train_step(cfg, remat=False)
        _flat(f"{arch}/params", params, out)
        for name, shape in MESHES.items():
            m = mesh(shape)
            shd.set_mesh(m)
            in_sh = (shd.param_shardings(params),
                     type(opt)(None, shd.param_shardings(opt.master),
                               shd.param_shardings(opt.m),
                               shd.param_shardings(opt.v)),
                     shd.batch_shardings(batch))
            with m:
                p2, o2, m2 = jax.jit(ts, in_shardings=in_sh)(params, opt,
                                                             batch)
            tag = f"{arch}/{name}/"
            for k in ("loss", "grad_norm", "ce", "aux"):
                out[tag + k] = np.asarray(m2[k])
            _flat(tag + "params", p2, out)
            for field in ("master", "m", "v"):
                _flat(tag + field, getattr(o2, field), out)
        shd.set_mesh(None)
    np.savez(path, **out)


if __name__ == "__main__":
    what, path = sys.argv[1], sys.argv[2]
    if what == "moe":
        moe(path)
    else:
        train(path, sys.argv[3:])
