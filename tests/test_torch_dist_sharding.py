"""The port's model sharding (``repro_torch.dist.sharding`` on a world
mesh) in a world of four gloo ranks: the tree shardings against the
reference's, placement, ``constrain``, the elastic restore and sharded
checkpoints against ``repro.train.checkpoint``, and the launcher's
``--coordinator`` over two processes.

The reference's tree shardings run here on a ``jax.sharding.AbstractMesh``
of the same axes (they read only its shape): the parameter specs on the
port's own tree (one dict per layer, which the reference's rules apply to
by path name), the batch specs, and the cache specs on the reference's
stacked cache, whose per-layer specs are the port's with the stacked
layer axis added. Everything else is exact.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.dist import sharding as ref_shd
from repro.models import model as RM
from repro.train import checkpoint as ref_ckpt
from repro_torch.dist import sharding as shd
from repro_torch.dist import world
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt

import _torch_dist_ranks as ranks

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DEADLINE_S = 120
SHAPES = [(2, 2), (4, 1)]
W = np.arange(64, dtype=np.float32).reshape(8, 8)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the world's root, the four ranks' results)."""
    root = tmp_path_factory.mktemp("dist_sharding")
    ref_ckpt.save(root / "from_reference", 1, {"w": jnp.asarray(W)})
    return root, world.spawn(ranks.sharding_rank, 4, backend="gloo",
                             root=root, deadline_s=DEADLINE_S, threads=1,
                             args=(str(root),))


def _abstract(tree):
    """The port's tree (meta tensors) as ShapeDtypeStructs, same layout."""
    if isinstance(tree, dict):
        return {k: _abstract(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_abstract(v) for v in tree]
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _ref_specs(tree):
    return [tuple(s.spec) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: hasattr(x, "spec"))]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ranks.SPEC_ARCHS)
def test_tree_specs_match_reference(run, arch, shape):
    """Every leaf's spec from param_shardings, batch_shardings and
    cache_shardings, computed in each rank, against the reference's."""
    _, got = run
    ref_shd.set_mesh(AbstractMesh(shape, ("data", "model")))
    try:
        cfg = ranks.smoke_config(ranks.get_config(arch))
        want = _ref_specs(ref_shd.param_shardings(_abstract(
            M.init(0, cfg, device="meta"))))
        toks = jax.ShapeDtypeStruct((8, 32), jnp.int32)
        want_batch = _ref_specs(ref_shd.batch_shardings(
            {"tokens": toks, "labels": toks}))
        rcfg = ref_smoke_config(ref_get_config(arch))
        rcache = jax.eval_shape(lambda: RM.init_cache(rcfg, 8, 16))
        flat, _ = jax.tree_util.tree_flatten_with_path(rcache)
        ref_cache = dict(zip(
            (ref_shd._path_name(p) for p, _ in flat),
            _ref_specs(ref_shd.cache_shardings(rcache, rcfg))))
    finally:
        ref_shd.set_mesh(None)
    for r in got:
        mine = r["specs"][(shape, arch)]
        assert mine["params"] == want
        assert mine["batch"] == want_batch
        assert len(mine["cache"]) == len(mine["cache_paths"])
        for path, spec in zip(mine["cache_paths"], mine["cache"]):
            parts = path.split("/")
            if parts[0] in ("layers", "shared"):   # stacked in the reference
                stacked = ref_cache["/".join([parts[0]] + parts[2:])]
                assert stacked[0] is None and spec == stacked[1:], path
            else:
                assert spec == ref_cache[path], path
    specs = dict(zip(got[0]["specs"][(shape, arch)]["param_paths"],
                     got[0]["specs"][(shape, arch)]["params"]))
    if arch == "deepseek_v2_lite_16b" and shape == (2, 2):
        assert specs["layers/0/moe/w_gate"] == ("model", "data", None)
        assert specs["layers/0/moe/w_down"] == ("model", None, "data")
        assert specs["layers/0/moe/router"] == ()


@pytest.mark.parametrize("shape", SHAPES)
def test_placement_round_trip(run, shape):
    """device_put keeps this rank's block of P("model", "data") (dim 0
    over the model axis, dim 1 over the data axis); the blocks are
    distinct, tile the array, and gather_tree brings it back on every
    rank; one rank owns each block; constrain returns a rank-local
    tensor as it is and refuses one on another device; the lane helpers
    and a decode (prefill) refuse a world mesh."""
    _, got = run
    x = np.arange(64 * 6, dtype=np.float32).reshape(8, 8, 6)
    seen = np.zeros(x.shape, bool)
    n_model, n_data = shape[1], shape[0]
    owners = 0
    for r in got:
        p = r[("placed", shape)]
        c = p["coords"]
        rows, cols = 8 // n_model, 8 // n_data
        want = x[c["model"] * rows:(c["model"] + 1) * rows,
                 c["data"] * cols:(c["data"] + 1) * cols]
        np.testing.assert_array_equal(p["block"].numpy(), want)
        seen[c["model"] * rows:(c["model"] + 1) * rows,
             c["data"] * cols:(c["data"] + 1) * cols] = True
        assert p["round_trip"] and p["constrain"]
        owners += p["owned"]
        assert "rank" in r[("constrain_meta", shape)]
        assert "world mesh" in r[("lanes", shape)]
        assert "sharded decode" in r[("decode", shape)]
    assert seen.all() and owners == 4


def test_elastic_restore_onto_another_mesh(run):
    """Saved from a (4,) data mesh with P("data", None), restored onto
    (2, 2) with P("model", "data"): four distinct blocks that tile the
    array and equal it. The sharded checkpoint is read by
    repro.train.checkpoint.restore; one written by
    repro.train.checkpoint.save restores sharded in the port."""
    root, got = run
    blocks = {}
    for r in got:
        e = r["elastic"]
        assert e["step"] == 1
        c = e["coords"]
        want = W[c["model"] * 4:(c["model"] + 1) * 4,
                 c["data"] * 4:(c["data"] + 1) * 4]
        np.testing.assert_array_equal(e["block"].numpy(), want)
        np.testing.assert_array_equal(r["from_reference"].numpy(), want)
        blocks[(c["model"], c["data"])] = e["block"].numpy()
    assert len(blocks) == 4
    tiled = np.block([[blocks[(0, 0)], blocks[(0, 1)]],
                      [blocks[(1, 0)], blocks[(1, 1)]]])
    np.testing.assert_array_equal(tiled, W)
    back, step = ref_ckpt.restore(root / "elastic", {
        "w": jax.ShapeDtypeStruct((8, 8), jnp.float32)})
    assert step == 1
    np.testing.assert_array_equal(np.asarray(back["w"]), W)


def test_sharded_save_equals_unsharded_save(run, tmp_path):
    """A smoke model's params saved from their 2 x 2 blocks equal, leaf by
    leaf and dtype by dtype, the checkpoint of the unsharded tree."""
    root, _ = run
    cfg = ranks.smoke_config(ranks.get_config("deepseek_v2_lite_16b"))
    ckpt.save(tmp_path, 3, M.init(0, cfg, device="cpu"))
    with np.load(root / "sharded_params" / "step_00000003" / "shards.npz") \
            as got, np.load(tmp_path / "step_00000003" / "shards.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_model_code_under_a_lane_mesh_raises(tmp_path):
    """Without a world, a debug mesh is a one-process lane mesh: constrain
    and the restore onto it raise; the multi-pod mesh raises."""
    lane = launch_mesh.make_debug_mesh(2, 2)
    assert not lane.is_world
    shd.set_mesh(lane)
    try:
        with pytest.raises(NotImplementedError, match="lane mesh"):
            shd.constrain(torch.zeros(4, 4), ("dp", None))
        assert shd.model_rules() is None
    finally:
        shd.set_mesh(None)
    ckpt.save(tmp_path, 1, {"a": torch.ones((4,))})
    with pytest.raises(NotImplementedError, match="lane mesh"):
        ckpt.restore(tmp_path, {"a": torch.ones((4,))}, mesh=lane)
    with pytest.raises(NotImplementedError, match="multi-pod"):
        launch_mesh.make_production_mesh(multi_pod=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_two(tmp_path, port):
    """Both hosts of ``launch.train --coordinator 127.0.0.1:<port>``:
    their (return codes, outputs, errors)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "internlm2_1_8b", "--local-smoke", "--device", "cpu", "--steps",
         "1", "--ckpt-dir", str(tmp_path / f"p{port}_host{i}"),
         "--coordinator", f"127.0.0.1:{port}", "--num-hosts", "2",
         "--host-id", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    res = []
    try:
        for p in procs:
            if res and res[0][0]:    # host 0 failed: host 1 waits in vain
                p.kill()
            out, err = p.communicate(timeout=DEADLINE_S)
            res.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return res


def test_launcher_coordinator_over_two_processes(tmp_path):
    """``launch.train --coordinator`` in two processes joins one gloo
    world of two (each prints its rank), then each trains as the
    reference's hosts do: the same losses. The coordinator is a
    ``host:port`` (the reference's ``jax.distributed.initialize``
    address), so the world meets over TCP: a port found free can be
    taken by another process before host 0 binds it, and then the launch
    is made once more on another port."""
    res = _launch_two(tmp_path, _free_port())
    if any(rc and "address already in use" in err.lower()
           for rc, _, err in res):
        res = _launch_two(tmp_path, _free_port())
    outs = []
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
        outs.append(out)
    for i, out in enumerate(outs):
        assert f"[train] process {i} of 2 (gloo" in out
    losses = [[ln.split("loss=")[1].split()[0] for ln in out.splitlines()
               if "loss=" in ln] for out in outs]
    assert losses[0] == losses[1] and len(losses[0]) == 1
