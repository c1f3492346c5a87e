"""The port's sharded prefill and decode (``models.model.prefill`` and
``decode_step`` under a world mesh) in a world of four gloo ranks, on world
meshes 2 x 2 and 4 x 1, against the reference's sharded decode on the same
meshes of forced host devices (``tests/_dist_reference.py decode``: its
``jax.jit`` prefill and three decode steps with the dry run's in-shardings,
``src/repro/launch/dryrun.py``), and against the port's unsharded decode.

Configs at smoke size in f32: dense GQA (``internlm2_1_8b``), MLA + MoE
(``deepseek_v2_lite_16b``: a leading dense layer, 4 routed experts top-2
and a shared one; expert-parallel over the model axis of 2 x 2), hybrid
(``zamba2_2_7b``: SSM states and the shared attention's caches) and
encoder-decoder (``whisper_large_v3``, whose cache holds each rank's block
of the encoder output's frames, as the reference's ``cache_shardings``
splits them). The MoE config runs as configured and at a capacity at
which no token drops. Each rank's logits rows at every step and its blocks
of the last cache are held at rtol 1e-4 / atol 1e-5 of the leaf's largest
entry (the sharded train tests' tolerances); against the unsharded decode
the logits are held so wherever no token drops (the expert-parallel path
routes each model column's tokens at a local capacity).
"""
import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import model as RM
from repro_torch import interop
from repro_torch.dist import sharding as shd
from repro_torch.dist import world
from repro_torch.train import optimizer as opt_lib

import _dist_reference as dref
import _torch_dist_ranks as ranks

ARCHS = ("internlm2_1_8b", "deepseek_v2_lite_16b", "zamba2_2_7b",
         "whisper_large_v3")
DEADLINE_S = 150
CASES = [(arch, var) for arch in ARCHS for var in
         dref.decode_variants(ref_smoke_config(ref_get_config(arch)))]


def _ref_cfg(arch, cf=None):
    cfg = dataclasses.replace(ref_smoke_config(ref_get_config(arch)),
                              dtype="float32", cache_dtype="float32")
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the four ranks' results): the reference's
    subprocess runs while the port's world does."""
    tmp = tmp_path_factory.mktemp("dist_decode")
    proc = dref.start("decode", tmp / "decode.npz", *ARCHS)
    try:
        inputs = {}
        for arch in ARCHS:
            rcfg = _ref_cfg(arch)
            params = interop.params_from_reference(
                jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(0),
                                                 rcfg)),
                ranks.f32_smoke(arch), device="cpu")
            arrays = dref.decode_inputs(rcfg)
            batch = {"tokens": torch.as_tensor(arrays["tokens"]).long()}
            if "enc_embeds" in arrays:
                batch["enc_embeds"] = torch.as_tensor(arrays["enc_embeds"])
            steps = [torch.as_tensor(t).long() for t in arrays["steps"]]
            for var, cf in dref.decode_variants(rcfg).items():
                inputs[(arch, var)] = dict(
                    capacity_factor=cf, params=params, batch=batch,
                    steps=steps, max_len=dref.DECODE_MAX_LEN)
        torch.save({"runs": inputs}, tmp / "inputs.pt")
        got = world.spawn(ranks.decode_rank, 4, backend="gloo", root=tmp,
                          deadline_s=DEADLINE_S, threads=1,
                          args=(str(tmp / "inputs.pt"),
                                list(dref.MESHES.values())))
    except BaseException:
        proc.kill()
        proc.wait(10)
        raise
    return dref.finish(proc, tmp / "decode.npz"), got


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _ref_cache(ref, arch, var, mesh_name, cfg):
    """The reference's last cache on `mesh_name` as the port's tree."""
    rcache = jax.eval_shape(lambda: RM.init_cache(
        _ref_cfg(arch), dref.DECODE_BATCH[0], dref.DECODE_MAX_LEN))
    treedef = jax.tree.structure(rcache)
    tag = f"{arch}/{var}/{mesh_name}/cache"
    return interop.cache_from_reference(jax.tree.unflatten(
        treedef, [ref[f"{tag}{i}"] for i in range(treedef.num_leaves)]),
        cfg, device="cpu")


@pytest.mark.parametrize("mesh_name", list(dref.MESHES))
@pytest.mark.parametrize("arch,var", CASES)
def test_sharded_decode_matches_reference(runs, arch, var, mesh_name):
    """Every rank's logits rows at the prefill and each decode step, and
    its blocks of the last cache (``cache_shardings``), against the
    reference's sharded decode on the same mesh."""
    ref, got = runs
    shape = dref.MESHES[mesh_name]
    tag = f"{arch}/{var}/{mesh_name}/"
    assert tag + "error" not in ref, str(ref[tag + "error"])
    cfg = dataclasses.replace(
        ranks.f32_smoke(arch),
        capacity_factor=dref.decode_variants(_ref_cfg(arch))[var])
    want_cache = _ref_cache(ref, arch, var, mesh_name, cfg)
    lane = shd.Mesh(["cpu"] * 4, ("data", "model"), shape)
    shd.set_mesh(lane)
    try:
        cache_sh = shd.cache_shardings(want_cache, cfg)
    finally:
        shd.set_mesh(None)
    for r in got:
        mine = r[(arch, var, shape)]
        rows = mine["rows"]
        assert rows.stop - rows.start == (8 // shape[0])
        for i, lg in enumerate(mine["logits"]):
            _close(lg, ref[f"{tag}logits{i}"][rows],
                   f"{tag} step {i} coords {mine['coords']}")
        for g, w, sh in zip(opt_lib.leaves(mine["cache"]),
                            opt_lib.leaves(want_cache),
                            opt_lib.leaves(cache_sh)):
            _close(g, w[sh.index(tuple(w.shape), mine["coords"])],
                   f"{tag} cache coords {mine['coords']}")


@pytest.mark.parametrize("mesh_name", list(dref.MESHES))
@pytest.mark.parametrize("arch,var", [c for c in CASES if c[1] != "cf"])
def test_sharded_decode_matches_unsharded(runs, arch, var, mesh_name):
    """Where no token drops, every rank's logits rows against the port's
    unsharded prefill and decode of the whole batch."""
    _, got = runs
    shape = dref.MESHES[mesh_name]
    single = got[0][(arch, var, "single")]["logits"]
    for r in got:
        mine = r[(arch, var, shape)]
        for i, (lg, want) in enumerate(zip(mine["logits"], single)):
            _close(lg, want[mine["rows"]],
                   f"{arch}/{var}/{mesh_name} step {i} coords "
                   f"{mine['coords']}")
