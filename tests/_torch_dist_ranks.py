"""Rank programs of the port's model-sharding tests
(``tests/test_torch_dist_*.py``): module-level functions that
``repro_torch.dist.world.spawn`` runs in each gloo rank. They import
neither JAX nor the reference, so a rank starts quickly; inputs come in
as files that the test process wrote, results go back as tensors."""
import dataclasses

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import make_train_step

SPEC_ARCHS = ("internlm2_1_8b", "deepseek_v2_lite_16b")


def f32_smoke(arch: str):
    return dataclasses.replace(smoke_config(get_config(arch)),
                               dtype="float32", cache_dtype="float32")


def _specs(tree):
    return [tuple(sh.spec) for sh in opt_lib.leaves(tree)]


def sharding_rank(rank: int, root: str) -> dict:
    """Specs over (2, 2) and (4, 1), placement, constrain, and the
    elastic restore: save from a (4,) data mesh, restore onto (2, 2)."""
    out: dict = {"specs": {}}
    for shape in ((2, 2), (4, 1)):
        mesh = launch_mesh.make_debug_mesh(*shape)
        rules = shd.set_mesh(mesh)
        assert shd.model_rules() is rules
        for arch in SPEC_ARCHS:
            cfg = smoke_config(get_config(arch))
            full = M.init(0, cfg, device="meta")
            toks = torch.zeros((8, 32), dtype=torch.int32)
            cache = M.init_cache(cfg, 8, 16, device="meta")
            out["specs"][(shape, arch)] = dict(
                params=_specs(M.param_shardings(cfg)),
                param_paths=_paths(full),
                batch=_specs(shd.batch_shardings({"tokens": toks,
                                                  "labels": toks})),
                cache=_specs(shd.cache_shardings(cache, cfg)),
                cache_paths=_paths(cache))
        x = torch.arange(64 * 6, dtype=torch.float32).reshape(8, 8, 6)
        sh = shd.NamedSharding(mesh, shd.P("model", "data"))
        block = shd.device_put({"x": x}, {"x": sh})["x"]
        again = shd.gather_tree({"x": block}, {"x": sh})["x"]
        out[("placed", shape)] = dict(block=block, coords=mesh.coords,
                                      round_trip=bool(torch.equal(again, x)),
                                      owned=sh.owned(),
                                      constrain=shd.constrain(
                                          block, ("dp", None)) is block)
        try:
            shd.constrain(block.to("meta"), ("dp",))
        except ValueError as e:
            out[("constrain_meta", shape)] = str(e)
        try:
            shd.lane_sharding((4, 8), w_axis=1)
        except NotImplementedError as e:
            out[("lanes", shape)] = str(e)
        try:
            cfg = smoke_config(get_config("internlm2_1_8b"))
            M.prefill(M.init(0, cfg, device="cpu"),
                      {"tokens": torch.zeros((2, 4), dtype=torch.int32)},
                      cfg, 8)
        except NotImplementedError as e:
            out[("decode", shape)] = str(e)
    # the elastic restore
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    mesh1 = shd.Mesh.over_world(("data",))
    sh1 = {"w": shd.NamedSharding(mesh1, shd.P("data", None))}
    placed = shd.device_put(tree, sh1)
    path = ckpt.save(f"{root}/elastic", 1, placed, shardings=sh1)
    mesh2 = launch_mesh.make_debug_mesh(2, 2)
    sh2 = {"w": shd.NamedSharding(mesh2, shd.P("model", "data"))}
    target = {"w": torch.empty((8, 8), device="meta")}
    restored, step = ckpt.restore(f"{root}/elastic", target, mesh=mesh2,
                                  shardings=sh2)
    out["elastic"] = dict(path=str(path), step=step, block=restored["w"],
                          coords=mesh2.coords)
    ref_back, _ = ckpt.restore(f"{root}/from_reference", target,
                               shardings=sh2)
    out["from_reference"] = ref_back["w"]
    cfg = smoke_config(get_config("deepseek_v2_lite_16b"))
    shd.set_mesh(mesh2)
    sh = M.param_shardings(cfg)
    ckpt.save(f"{root}/sharded_params", 3,
              shd.device_put(M.init(0, cfg, device="cpu"), sh), shardings=sh)
    shd.set_mesh(None)
    return out


def _paths(tree) -> list[str]:
    return [shd._path_name(p) for p in _leaf_paths(tree)]


def _leaf_paths(tree, path=()):
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _leaf_paths(tree[k],
                                                             path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree)
                for q in _leaf_paths(v, path + (i,))]
    return [] if tree is None else [path]


def moe_rank(rank: int, inputs: str) -> dict:
    """moe_block_ep on a 2 x 2 world mesh from the reference's params and
    x (this rank's rows and expert blocks): output, aux, and the
    gradients of sum(out * w) + aux."""
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.moe import moe_block_ep
    data = torch.load(inputs, weights_only=False)
    mesh = launch_mesh.make_debug_mesh(2, 2)
    rules = shd.set_mesh(mesh)
    dp_group = mesh.group(rules.dp)
    out = {"coords": mesh.coords}
    for cf in (8.0, 1.0):
        cfg = ModelConfig(capacity_factor=cf, **data["cfg"])
        p = data["params"]
        sh = shd.param_shardings(p)
        local = shd.device_put(p, sh)
        xsh = shd.batch_shardings(data["x"])
        x = shd.device_put(data["x"], xsh).requires_grad_(True)
        w = shd.device_put(data["w"], xsh)
        leaves = [t.requires_grad_(True) for t in opt_lib.leaves(local)]
        local = opt_lib.unflatten(p, leaves)
        use = dict(local, router=coll.sum_grads(local["router"], dp_group),
                   shared=shd.gather_for_use(local["shared"], sh["shared"]))
        y, aux = moe_block_ep(use, x, cfg)
        loss = coll.sum_replicated(torch.sum(y * w), dp_group) + aux
        grads = torch.autograd.grad(loss, [x] + leaves)
        tag = f"cf{int(cf)}"
        out[tag] = dict(out=y.detach(), aux=float(aux), gx=grads[0],
                        gp=opt_lib.unflatten(p, list(grads[1:])),
                        specs=_specs(sh))
    shd.set_mesh(None)
    return out


def train_rank(rank: int, inputs: str, arch: str, shapes) -> dict:
    """One train step of the f32 smoke config from the given params on a
    world mesh of each of `shapes` (remat on), and on rank 0 the same
    step unsharded: the metrics, and on rank 0 the gathered new params
    and optimizer state of each mesh."""
    data = torch.load(inputs, weights_only=False)
    cfg = f32_smoke(arch)
    params = data["params"]
    toks = data["tokens"]
    batch = {"tokens": toks, "labels": toks}
    if "enc_embeds" in data:
        batch["enc_embeds"] = data["enc_embeds"]
    ts = make_train_step(cfg)
    out = {}
    if rank == 0:
        _, _, m1 = ts(params, opt_lib.init(params), batch)
        out["single"] = {k: float(v) for k, v in m1.items()}
    for shape in shapes:
        mesh = launch_mesh.make_debug_mesh(*shape)
        shd.set_mesh(mesh)
        sh = M.param_shardings(cfg)
        local = shd.device_put(params, sh)
        opt = opt_lib.init(local)
        lb = shd.device_put(batch, shd.batch_shardings(batch))
        p2, o2, m2 = ts(local, opt, lb)
        mine = {"sharded": {k: float(v) for k, v in m2.items()},
                "local_shapes": [tuple(t.shape)
                                 for t in opt_lib.leaves(p2)]}
        full = {"params": shd.gather_tree(p2, sh),
                "master": shd.gather_tree(o2.master, sh),
                "m": shd.gather_tree(o2.m, sh),
                "v": shd.gather_tree(o2.v, sh)}
        if rank == 0:
            mine["full"] = full
            mine["step"] = int(o2.step)
        out[shape] = mine
        shd.set_mesh(None)
    return out
