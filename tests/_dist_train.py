"""The sharded train step of one smoke config on the port's world meshes
against the reference's sharded step (``tests/test_torch_dist_train*.py``).

`runs(arch, tmp)` runs the reference's steps on the 2 x 2 and 4 x 1
meshes of forced host devices
(``tests/_dist_reference.py``), then the port's step from the same params
and tokens on both meshes in one world of four gloo ranks
(``tests/_torch_dist_ranks.py``), remat on, and rank 0's unsharded step.
Returns (the reference's results, {mesh name: the ranks' results, each
with rank 0's unsharded metrics}).
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import model as RM
from repro_torch import interop
from repro_torch.dist import world

import _dist_reference as dref
import _torch_dist_ranks as ranks

DEADLINE_S = 150


def _ref_cfg(arch):
    return dataclasses.replace(ref_smoke_config(ref_get_config(arch)),
                               dtype="float32", cache_dtype="float32")


def runs(arch: str, tmp):
    ref = dref.run("train", tmp / "train.npz", arch)
    treedef = jax.tree.structure(jax.eval_shape(
        lambda: RM.init(jax.random.PRNGKey(0), _ref_cfg(arch))))
    cfg = ranks.f32_smoke(arch)

    def tree(prefix):
        return interop.params_from_reference(jax.tree.unflatten(
            treedef, [ref[f"{prefix}{i}"]
                      for i in range(treedef.num_leaves)]), cfg,
            device="cpu")
    ref["params"] = tree(f"{arch}/params")
    for name in dref.MESHES:
        for field in ("params", "master", "m", "v"):
            ref[f"{name}/{field}"] = tree(f"{arch}/{name}/{field}")
    inputs = {"params": ref["params"], "tokens": torch.as_tensor(
        ref["tokens"])}
    if f"{arch}/enc_embeds" in ref:
        inputs["enc_embeds"] = torch.as_tensor(ref[f"{arch}/enc_embeds"])
    torch.save(inputs, tmp / "inputs.pt")
    shapes = list(dref.MESHES.values())
    res = world.spawn(ranks.train_rank, 4, backend="gloo", root=tmp,
                      deadline_s=DEADLINE_S, threads=1,
                      args=(str(tmp / "inputs.pt"), arch, shapes))
    single = res[0]["single"]
    got = {name: [dict(r[shape], single=single) for r in res]
           for name, shape in dref.MESHES.items()}
    return ref, got


def max_rel(got_tree, want_tree) -> dict:
    """Per field, the largest |got - want| over the leaf's largest |want|."""
    from repro_torch.train import optimizer as opt_lib
    out = []
    for g, w in zip(opt_lib.leaves(got_tree), opt_lib.leaves(want_tree)):
        w = w.numpy()
        out.append(float(np.abs(g.numpy() - w).max()
                         / max(np.abs(w).max(), 1e-30)))
    return max(out)


def check_against_reference(ref, got, arch: str, single_tol: dict) -> None:
    """Every mesh's step against the reference's on the same mesh: loss
    and grad_norm at rtol 1e-4, every new param, master, m and v leaf
    at rtol 1e-4 / atol 1e-5 of the leaf's largest entry (the tolerances
    of tests/test_torch_train.py's train steps); every rank's metrics
    alike; the loss against the port's unsharded step at `single_tol`."""
    from repro_torch.train import optimizer as opt_lib
    for name, rs in got.items():
        tag = f"{arch}/{name}/"
        for r in rs:
            assert r["sharded"] == rs[0]["sharded"], name
            for k in ("loss", "grad_norm", "ce", "aux"):
                np.testing.assert_allclose(r["sharded"][k], ref[tag + k],
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"{name} {k}")
            np.testing.assert_allclose(r["sharded"]["loss"],
                                       r["single"]["loss"], **single_tol,
                                       err_msg=f"{name} against one rank")
        assert rs[0]["step"] == 1
        for field in ("params", "master", "m", "v"):
            for g, w in zip(opt_lib.leaves(rs[0]["full"][field]),
                            opt_lib.leaves(ref[f"{name}/{field}"])):
                w = w.numpy()
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=1e-4,
                    atol=1e-5 * max(np.abs(w).max(), 1e-30),
                    err_msg=f"{name} {field}")
