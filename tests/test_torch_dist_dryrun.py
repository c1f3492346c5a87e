"""The dry run's per-device records under a mesh (``launch.dryrun``).

* Argument bytes: for every cell of ``cells()`` on the reference's 16x16
  and 2x16x16 meshes, the port's ``memory.argument_bytes`` (one rank's
  blocks, traced in a ``Mesh.over_shapes`` world) equals the bytes of the
  reference's in-shardings (``src/repro/launch/dryrun.py``: its
  ``param_shardings``, ``cache_shardings`` and ``batch_shardings``, read
  by ``NamedSharding.shard_shape``) in a subprocess with 512 forced host
  devices. The reference's layers are stacked for ``lax.scan``: its rules
  give the port's per-layer tree (the one the port holds) by path name,
  so the parameters' side is held on that tree, and the batch and the
  cache are the reference's own.
* Collectives: in a world of four gloo ranks at smoke size, the bytes and
  calls that one sharded train or decode step moves through
  ``torch.distributed`` (counted by wrapping its collectives in the rank,
  ``tests/_torch_dist_count.py``) equal the record's ``collectives``.
"""
import _torch_threads  # noqa: F401  (one torch thread)
import pytest

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.dist import world
from repro_torch.launch import dryrun

import _dist_reference as dref
import _torch_dist_count as count

DEADLINE_S = 150
LAYOUTS = ("16x16", "2x16x16")
COUNT_CASES = [
    ("internlm2_1_8b", "train", ShapeSpec("t", 16, 8, "train"), (4, 1)),
    ("deepseek_v2_lite_16b", "train", ShapeSpec("t", 16, 8, "train"),
     (2, 2)),
    ("deepseek_v2_lite_16b", "decode", ShapeSpec("t", 16, 8, "decode"),
     (2, 2)),
    ("whisper_large_v3", "decode", ShapeSpec("t", 16, 8, "decode"), (4, 1)),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's argument bytes, the port's, the ranks' counts):
    the reference's subprocess runs while the port's records and world
    do."""
    tmp = tmp_path_factory.mktemp("dist_dryrun")
    proc = dref.start("argbytes", tmp / "argbytes.npz", devices=512)
    try:
        port = {(a, s, lay): dryrun.device_memory(get_config(a), SHAPES[s],
                                                 lay)["argument_bytes"]
                for a, s in cells() for lay in LAYOUTS}
        counted = world.spawn(count.count_rank, 4, backend="gloo",
                              root=tmp, deadline_s=DEADLINE_S, threads=1,
                              args=(COUNT_CASES,))
    except BaseException:
        proc.kill()
        proc.wait(10)
        raise
    return dref.finish(proc, tmp / "argbytes.npz"), port, counted


@pytest.mark.parametrize("layout", LAYOUTS)
def test_argument_bytes_match_reference(runs, layout):
    ref, port, _ = runs
    assert len(cells()) == 32
    for arch, shape in cells():
        assert port[(arch, shape, layout)] == \
            int(ref[f"{arch}|{shape}|{layout}"]), (arch, shape)


@pytest.mark.parametrize("layout", ["16x16", "2x16x16", "4x1"])
def test_run_cell_records_a_mesh(runs, layout):
    """The record of one cell under each layout: ok, named by the layout,
    its argument bytes those of the reference's in-shardings (16x16 and
    2x16x16), the total its parts, and the collectives' bytes by kind."""
    ref, port, _ = runs
    rec = dryrun.run_cell("deepseek_v2_lite_16b", "decode_32k",
                          layout=layout)
    assert rec["ok"], rec
    assert rec["mesh"] == layout and rec["kind"] == "decode"
    mem = rec["memory"]
    if layout in LAYOUTS:
        assert mem["argument_bytes"] == int(
            ref[f"deepseek_v2_lite_16b|decode_32k|{layout}"])
    assert mem["total_bytes"] == mem["argument_bytes"] \
        + mem["activation_bytes"]
    assert mem["donated_bytes"] == mem["parts"]["cache"]
    assert rec["local_batch"] == 128 // rec["dp"]
    c = rec["collectives"]
    assert c["total_bytes"] == sum(c["bytes"].values()) > 0
    assert (c["counts"]["all-to-all"] > 0) == (layout != "4x1")
    assert rec["flops_per_device"] > 0


@pytest.mark.parametrize("case", range(len(COUNT_CASES)))
def test_collectives_match_torch_distributed(runs, case):
    """What one step moves through torch.distributed, counted on every
    rank, equals the record's collectives, kind by kind."""
    _, _, counted = runs
    arch, kind, _, _ = COUNT_CASES[case]
    for r in counted:
        got = r[(arch, kind)]
        rec = got["record"]
        for k in ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all"):
            b, n = got["counted"].get(k, (0.0, 0))
            assert rec["counts"][k] == n, (k, rec, got["counted"])
            assert rec["bytes"][k] == pytest.approx(b, rel=0, abs=1e-6), k
        assert counted[0][(arch, kind)]["counted"] == got["counted"]
