"""The port's expert-parallel MoE block (``models.moe.moe_block_ep``) on a
2 x 2 world mesh of four gloo ranks, against the reference's
``moe_block_ep`` under ``shard_map`` on a 2 x 2 mesh of forced host
devices (``tests/_dist_reference.py``, one subprocess per file).

Both run the same params and x (256 tokens, 8 experts, top-2, a shared
expert) at capacity factor 8 (no token drops) and 1.0, where each model
column's 64 tokens overflow the local capacity of 16 and drop: only the
drops tell a wrong local capacity. Held per rank, on its own rows and
expert blocks: the output and the aux loss at rtol 1e-5 / atol 1e-6, and
the gradients of sum(out * w) + aux with respect to x and every param at
rtol 1e-4 / atol 1e-5 of the leaf's largest entry (the backward passes
sum the columns' and the data ranks' parts in another order). At factor
8 the output also matches the single-program scatter path within the
reference's own 1e-3 (tests/test_distributed.py).
"""
import jax
import numpy as np
import pytest
import torch

from repro.models.common import ModelConfig as RefModelConfig
from repro.models.moe import init_moe as ref_init_moe
from repro_torch.dist import world
from repro_torch.train import optimizer as opt_lib

import _dist_reference as dref
import _torch_dist_ranks as ranks

DEADLINE_S = 120


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the port's four ranks' results)."""
    tmp = tmp_path_factory.mktemp("dist_moe")
    ref = dref.run("moe", tmp / "moe.npz")
    cfg = RefModelConfig(capacity_factor=8.0, **dref.MOE_CFG)
    treedef = jax.tree.structure(jax.eval_shape(
        lambda: ref_init_moe(jax.random.PRNGKey(0), cfg)))
    n = treedef.num_leaves

    def tree(prefix):
        return jax.tree.map(torch.as_tensor, jax.tree.unflatten(
            treedef, [ref[f"{prefix}{i}"] for i in range(n)]))
    ref["params"] = tree("p")
    for tag in ("cf8_", "cf1_"):
        ref[tag + "gp"] = tree(tag + "gp")
    torch.save({"cfg": dref.MOE_CFG, "params": ref["params"],
                "x": torch.as_tensor(ref["x"]),
                "w": torch.as_tensor(ref["w"])}, tmp / "inputs.pt")
    got = world.spawn(ranks.moe_rank, 4, backend="gloo", root=tmp,
                      deadline_s=DEADLINE_S, threads=1,
                      args=(str(tmp / "inputs.pt"),))
    return ref, got


def _block(full, sharding_spec, coords, sizes):
    """The block of `full` that a rank at `coords` holds under a spec."""
    idx = []
    for d, e in enumerate(tuple(sharding_spec) + (None,) * (
            full.ndim - len(sharding_spec))):
        if e is None:
            idx.append(slice(None))
            continue
        n = sizes[e]
        k = full.shape[d] // n
        idx.append(slice(coords[e] * k, (coords[e] + 1) * k))
    return full[tuple(idx)]


SIZES = {"data": 2, "model": 2}


@pytest.mark.parametrize("cf", [8, 1])
def test_moe_block_ep_matches_reference(runs, cf):
    """Each rank's output rows, aux and gradients against the reference's
    on the same rows and expert blocks."""
    ref, got = runs
    tag = f"cf{cf}"
    for r in got:
        c = r["coords"]
        mine = r[tag]
        rows = slice(c["data"] * 2, (c["data"] + 1) * 2)
        np.testing.assert_allclose(mine["out"].numpy(),
                                   ref[tag + "_out"][rows], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(mine["aux"], ref[tag + "_aux"],
                                   rtol=1e-5)
        gx = ref[tag + "_gx"][rows]
        np.testing.assert_allclose(mine["gx"].numpy(), gx, rtol=1e-4,
                                   atol=1e-5 * np.abs(gx).max())
        for g, want, spec in zip(opt_lib.leaves(mine["gp"]),
                                 opt_lib.leaves(ref[tag + "_gp"]),
                                 mine["specs"]):
            want = _block(want.numpy(), spec, c, SIZES)
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max())


def test_moe_block_ep_layout_and_drops(runs):
    """The experts split E over "model" and D over "data" (w_down: its
    last dim), the router replicated; at factor 1.0 tokens drop (the
    column's busiest expert takes more than the local capacity), and the
    output differs from factor 8's; at factor 8 it matches the scatter
    path within 1e-3."""
    ref, got = runs
    specs = dict(zip(("router", "shared/w_down", "shared/w_gate",
                      "shared/w_up", "w_down", "w_gate", "w_up"),
                     got[0]["cf8"]["specs"]))
    assert specs["router"] == ()
    assert specs["w_gate"] == specs["w_up"] == ("model", "data", None)
    assert specs["w_down"] == ("model", None, "data")
    x = ref["x"].reshape(-1, 16)
    logits = x @ ref["params"]["router"].numpy()
    top2 = np.argsort(-logits, axis=1)[:, :2]
    # each column's 64 tokens at local capacity max(ceil(64*2/8)*1, 8)
    busiest = max(np.bincount(top2[i:i + 64].ravel(), minlength=8).max()
                  for i in range(0, 256, 64))
    assert busiest > 16
    assert not np.allclose(ref["cf1_out"], ref["cf8_out"])
    for r in got:
        rows = slice(r["coords"]["data"] * 2, (r["coords"]["data"] + 1) * 2)
        assert np.abs(r["cf8"]["out"].numpy()
                      - ref["scatter"][rows]).max() < 1e-3
