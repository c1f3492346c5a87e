"""The reference's sharded results for the port's model-sharding tests
(``tests/test_torch_dist_*.py``), computed in a subprocess of its own:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_dist_reference.py {moe|train|decode} OUT.npz [ARCH ...]

The mesh is built here as ``jax.sharding.Mesh`` over the forced host
devices, whose axes are Auto (``jax.make_mesh`` gives Explicit axes under
jax 0.9.0, on which the reference's sharded step fails). Inputs are drawn
here from NumPy seeds and written beside the results, so the port starts
from the same arrays. Nothing of ``repro`` is changed.
"""
import contextlib
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
DECODE_BATCH = (8, 8)        # [B, prompt]
DECODE_STEPS = 3
DECODE_MAX_LEN = 16
NO_DROP = 8.0                # a capacity factor at which no token drops


def start(what: str, out, *args, devices: int = 8) -> subprocess.Popen:
    """This script in a subprocess with `devices` forced host devices (see
    `finish`)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        ROOT, "src"), XLA_FLAGS="--xla_force_host_platform_device_count="
        f"{devices}")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             what, str(out), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc: subprocess.Popen, out, timeout: float = 300) -> dict:
    """The npz of a `start`ed subprocess as a dict, once it ends (killed
    after `timeout` seconds)."""
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    if proc.returncode:
        raise RuntimeError(err[-3000:])
    with np.load(out) as z:
        return dict(z)


def run(what: str, out, *args) -> dict:
    """This script in a subprocess with 8 forced host devices; its npz
    as a dict (called by the tests)."""
    return finish(start(what, out, *args), out)


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


def decode_variants(cfg) -> dict:
    """{name: capacity factor}: an MoE config as configured and where no
    token drops; any other config once."""
    if not cfg.n_experts:
        return {"": cfg.capacity_factor}
    return {"cf": cfg.capacity_factor, "nodrop": NO_DROP}


def decode_inputs(cfg, seed=3) -> dict:
    """The prompt (and an encoder-decoder's frame embeddings) and the
    tokens fed at each decode step, from a NumPy seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, DECODE_BATCH)
           .astype(np.int32),
           "steps": rng.integers(0, cfg.vocab, (DECODE_STEPS,
                                                DECODE_BATCH[0], 1))
           .astype(np.int32)}
    if cfg.n_enc_layers:
        out["enc_embeds"] = rng.normal(size=(
            DECODE_BATCH[0], cfg.enc_len, cfg.d_model)).astype(np.float32)
    return out


def _decode_run(cfg, params, inputs, m=None) -> dict:
    """Prefill and DECODE_STEPS decode steps, jitted with the dry run's
    in-shardings on mesh `m` (unsharded without one): each step's logits
    and the last cache's leaves."""
    batch = {k: jnp.asarray(v) for k, v in inputs.items() if k != "steps"}
    pre = jax.jit(lambda p, b: M.prefill(p, b, cfg, DECODE_MAX_LEN))
    dec = jax.jit(lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg))
    if m is not None:
        shd.set_mesh(m)
        psh = shd.param_shardings(params)
        pre = jax.jit(lambda p, b: M.prefill(p, b, cfg, DECODE_MAX_LEN),
                      in_shardings=(psh, shd.batch_shardings(batch)))
    ctx = m if m is not None else contextlib.nullcontext()
    place = (lambda x, sh: x) if m is None else jax.device_put
    with ctx:
        if m is not None:
            params = place(params, psh)
            batch = place(batch, shd.batch_shardings(batch))
        logits, cache = pre(params, batch)
        if m is not None:
            tok_sh = shd.batch_shardings(
                {"tokens": jnp.asarray(inputs["steps"][0])})["tokens"]
            cache_sh = shd.cache_shardings(cache, cfg)
            rep = jax.sharding.NamedSharding(m,
                                             jax.sharding.PartitionSpec())
            dec = jax.jit(
                lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg),
                in_shardings=(psh, cache_sh, tok_sh, rep))
        out = {"logits0": np.asarray(logits)}
        for i, tok in enumerate(inputs["steps"]):
            if m is not None:
                cache = place(cache, cache_sh)
                tok = place(jnp.asarray(tok), tok_sh)
            logits, cache = dec(params, cache, jnp.asarray(tok),
                                jnp.int32(DECODE_BATCH[1] + i))
            out[f"logits{i + 1}"] = np.asarray(logits)
    shd.set_mesh(None)
    _flat("cache", cache, out)
    return out


def decode(path, archs):
    """Each smoke config (f32) from the reference's init at PRNGKey(0):
    prefill and DECODE_STEPS decode steps on each mesh (the MoE config
    as configured and where no token drops). A mesh on which the
    reference's sharded decode fails records its error and the
    unsharded decode in its place."""
    out = {}
    for arch in archs:
        base = dataclasses.replace(smoke_config(get_config(arch)),
                                   dtype="float32", cache_dtype="float32")
        params = M.init(jax.random.PRNGKey(0), base)
        inputs = decode_inputs(base)
        for k, v in inputs.items():
            out[f"{arch}/{k}"] = v
        for var, cf in decode_variants(base).items():
            cfg = dataclasses.replace(base, capacity_factor=cf)
            unsharded = None
            for name, shape in MESHES.items():
                tag = f"{arch}/{var}/{name}/"
                try:
                    res = _decode_run(cfg, params, inputs, mesh(shape))
                except Exception as e:        # recorded, held unsharded
                    shd.set_mesh(None)
                    out[tag + "error"] = np.asarray(
                        f"{type(e).__name__}: {e}"[:2000])
                    if unsharded is None:
                        unsharded = _decode_run(cfg, params, inputs)
                    res = unsharded
                for k, v in res.items():
                    out[tag + k] = v
    np.savez(path, **out)


def _shard_bytes(tree, shardings) -> int:
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(sh.shard_shape(x.shape))) * x.dtype.itemsize
               for x, sh in zip(leaves, shs))


def _port_tree(cfg):
    """The port's parameter tree for `cfg` (one dict per layer) as
    ShapeDtypeStructs."""
    from repro_torch.configs import get_config as port_config
    from repro_torch.models import model as PM

    def sds(tree):
        if isinstance(tree, dict):
            return {k: sds(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [sds(v) for v in tree]
        return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.dtype(
            str(tree.dtype).replace("torch.", "")))
    return sds(PM.init(0, port_config(cfg.name), device="meta"))


def argbytes(path):
    """Per-device argument bytes of every cell of ``cells()`` on the
    reference's production meshes (16x16 and 2x16x16), from
    ``NamedSharding.shard_shape`` under the in-shardings of
    ``repro.launch.dryrun.run_cell``: the batch and the cache are the
    reference's own specs; the parameters (and the optimizer's master, m
    and v) are the port's per-layer tree under the reference's
    ``param_shardings`` (its rules name leaves by path; on its own
    stacked tree they shard otherwise: a stacked dense MLP's 3-d weights
    take the experts' rule, stacked norm scales are FSDP-sharded)."""
    from repro.configs.registry import SHAPES, cells
    from repro.launch import specs as rsp
    from repro.launch.mesh import make_production_mesh
    out = {}
    trees: dict = {}
    for arch, shape_name in cells():
        cfg, shape = get_config(arch), SHAPES[shape_name]
        if arch not in trees:
            trees[arch] = _port_tree(cfg)
        port = trees[arch]
        for name, multi in (("16x16", False), ("2x16x16", True)):
            shd.set_mesh(make_production_mesh(multi_pod=multi))
            try:
                def state(tree):     # params (+ the step, master, m, v)
                    n = _shard_bytes(tree, shd.param_shardings(tree))
                    if shape.kind != "train":
                        return n
                    f32 = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
                        x.shape, jnp.float32), tree)
                    return n + 4 + 3 * _shard_bytes(
                        f32, shd.param_shardings(f32))
                if shape.kind == "decode":
                    cache = rsp.cache_specs(cfg, shape)
                    tok = rsp.input_specs(cfg, shape)
                    rest = _shard_bytes(cache, shd.cache_shardings(cache,
                                                                   cfg)) \
                        + _shard_bytes(tok, shd.batch_shardings(tok))
                else:
                    batch = rsp.input_specs(cfg, shape)
                    rest = _shard_bytes(batch, shd.batch_shardings(batch))
                out[f"{arch}|{shape_name}|{name}"] = np.int64(state(port)
                                                              + rest)
            finally:
                shd.set_mesh(None)
    np.savez(path, **out)


if __name__ == "__main__":
    what, path = sys.argv[1], sys.argv[2]
    if what == "argbytes":
        argbytes(path)
        sys.exit(0)
    if what == "moe":
        moe(path)
    elif what == "decode":
        decode(path, sys.argv[3:])
    else:
        train(path, sys.argv[3:])
