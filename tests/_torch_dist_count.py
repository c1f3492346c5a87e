"""A rank program that counts what ``torch.distributed``'s collectives
move (``tests/test_torch_dist_dryrun.py``). Importing this module wraps the
flat collectives of ``torch.distributed`` before the port's
``dist.collectives`` binds them; while `COUNTING` is on, each call adds
the bytes a member moves, by the ring factors of the reference's
``parse_collectives`` (all-reduce 2(g-1)/g R, all-gather (g-1)/g R,
reduce-scatter (g-1) R, all-to-all (g-1)/g R; R the result's bytes on
this member, g the group's size), and one to its kind's count."""
import torch
import torch.distributed as dist

COUNTING = False
TALLY: dict = {}


def _add(kind, result, group):
    if not COUNTING:
        return
    g = dist.get_world_size(group)
    r = result.numel() * result.element_size()
    moved = {"all-reduce": 2 * r * (g - 1) / g,
             "all-gather": r * (g - 1) / g,
             "reduce-scatter": r * (g - 1),
             "all-to-all": r * (g - 1) / g}[kind]
    b, n = TALLY.get(kind, (0.0, 0))
    TALLY[kind] = (b + moved, n + 1)


def _wrap(name, kind, result_arg):
    fn = getattr(dist, name, None)
    if fn is None:
        return

    def counted(*args, group=None, **kw):
        _add(kind, args[0] if result_arg else kw.get("tensor", args[0]),
             group)
        return fn(*args, group=group, **kw)
    counted.wrapped = fn
    setattr(dist, name, counted)


for _name, _kind in (("all_gather_single", "all-gather"),
                     ("all_gather_into_tensor", "all-gather"),
                     ("reduce_scatter_single", "reduce-scatter"),
                     ("reduce_scatter_tensor", "reduce-scatter"),
                     ("all_to_all_single", "all-to-all")):
    _wrap(_name, _kind, True)
_wrap("all_reduce", "all-reduce", False)


def count_rank(rank: int, cases) -> dict:
    """For each (arch, kind, ShapeSpec, mesh shape) of `cases`: the
    collectives one sharded train or decode step of the smoke config
    moves on this rank, counted at ``torch.distributed``, beside
    ``launch.dryrun.device_record``'s ``collectives`` for the same step,
    computed here."""
    global COUNTING
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    import _torch_dist_ranks as ranks
    assert getattr(coll._GATHER, "wrapped", None) is not None
    assert getattr(coll._SCATTER, "wrapped", None) is not None
    meshes = {}
    out = {}
    for arch, kind, shape, mesh_shape in cases:
        cfg = ranks.smoke_config(ranks.get_config(arch))
        rec = dryrun.device_record(cfg, shape, "x".join(
            map(str, mesh_shape)))
        if mesh_shape not in meshes:
            meshes[mesh_shape] = launch_mesh.make_debug_mesh(*mesh_shape)
        shd.set_mesh(meshes[mesh_shape])
        sh = M.param_shardings(cfg)
        local = shd.device_put(M.init(0, cfg, device="cpu"), sh)
        g = torch.Generator().manual_seed(7)
        toks = torch.randint(0, cfg.vocab, (shape.global_batch,
                                            shape.seq_len if kind == "train"
                                            else 1), generator=g)
        rows = shd.batch_rows(shape.global_batch)
        TALLY.clear()
        if kind == "train":
            opt = opt_lib.init(local)
            batch = {"tokens": toks.to(torch.int32),
                     "labels": toks.to(torch.int32)}
            lb = shd.device_put(batch, shd.batch_shardings(batch))
            step = make_train_step(cfg, microbatches=rec["microbatches"])
            COUNTING = True
            step(local, opt, lb)
        else:
            cache = M.init_cache(cfg, rows.stop - rows.start,
                                 shape.seq_len, device="cpu")
            COUNTING = True
            M.decode_step(local, cache, toks[rows], shape.seq_len - 1, cfg,
                          shardings=sh)
        COUNTING = False
        shd.set_mesh(None)
        out[(arch, kind)] = dict(counted=dict(TALLY),
                                 record=rec["collectives"])
    return out
