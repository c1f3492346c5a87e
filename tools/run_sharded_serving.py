#!/usr/bin/env python3
"""Sharded serving over every visible card of one host: one process a card
(``repro_torch.dist.world.spawn``, NCCL, a ``file://`` store under
``build/``), the model's parameters and cache split over a world mesh
(``models.model.prefill``/``decode_step`` under ``dist.sharding``).

    python3 tools/run_sharded_serving.py             # on four cards

(the per-device records it sizes the cells by, without a card:
``python -m repro_torch.launch.dryrun --arch deepseek_v2_lite_16b
--shape decode_32k --mesh 4x1``)

(0) ``chip_smoke.py`` phase 35's sharded decode on (4, 1)
    (``chip_smoke.sharded_decode``): ``deepseek_v2_lite_16b`` at full
    width cut to ``SHARD_LAYERS`` layers, a prefill of the launcher's
    batch and its decode steps against the same on one card, in f32
    (gated at ``SHARD_DECODE_TOL``) and in bf16 (read, not gated).
(a) ``deepseek_v2_lite_16b``'s ``decode_32k`` cell at full width: a
    128 x 32,768 MLA cache placed from a seed under ``cache_shardings``
    (each rank fills its rows), the parameters from a seed under
    ``param_shardings``, DECODE_STEPS decode steps at position 32,767, on
    (4, 1) at its full 27 layers and on (2, 2) (the experts split over the
    model axis, expert-parallel) at the deepest cut whose dry-run record
    (``launch.dryrun.device_record``) fits a card. Per card: ms a step,
    the peak against the record's per-device total, and the share of one
    profiled step's wall that NCCL kernels take.
(b) ``deepseek_67b`` at full width, which one card cannot hold, on
    (4, 1): 32 slots (8 replicas x 4 lanes, ``max_len`` 64) serve the
    launcher's 10-minute bursty script under AAPA
    (``launch.serve.serve``), its classifier trained on ``aapaset_ci`` on
    each card. Every rank's summary and decision log must be equal, and
    equal to the same script's at smoke width on the CPU (the scheduler
    never reads the logits; the CPU run classifies with rank 0's
    classifier). Per card: the run's wall, decode steps, ms a step over
    TIMED_STEPS more steps, the NCCL share of a profiled step, the peak,
    and the kernel launches of the run (``kernels.ops.launch_counts``:
    the classifier's ``window_features`` and ``gbdt_tables`` on every
    card).

Parameters are drawn block by block on each card (`seeded_blocks`): no
card ever holds a whole tree. Prints the cards' names and power limits,
a line per result, and as the last line a JSON object of the numbers,
also written to ``chiprun_out/sharded_serving.json``. CUDA and NCCL
only: the CPU's check of the same sharded decode and serving paths is
the gloo worlds of ``tests/test_torch_dist_decode.py`` and
``tests/test_torch_dist_serve.py``.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

CELL_ARCH = "deepseek_v2_lite_16b"
SERVE_ARCH = "deepseek_67b"
DECODE_STEPS = 4
TIMED_STEPS = 4
MINUTES = 10
DEADLINE_S = 1800


def card() -> torch.device:
    """This rank's card (``world.spawn`` sets it)."""
    return torch.device("cuda", torch.cuda.current_device())


def config(arch: str, n_layers: int | None = None):
    """`arch` at full width, cut to `n_layers` where given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if n_layers is None else \
        dataclasses.replace(cfg, n_layers=n_layers)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def seeded_blocks(cfg, sh, dev, seed: int = 0):
    """This rank's blocks of random parameters for `cfg` under `sh`, drawn
    on `dev` from generators seeded by each leaf's index and its block's
    offsets in the whole leaf, so ranks holding one block draw the same
    values: vectors (norm scales) ones, the embedding N(0, 0.02^2), every
    other matrix N(0, 1 / fan-in)."""
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    full = M.init(0, cfg, device="meta")
    blocks = []
    for i, ((path, t), s) in enumerate(zip(_paths(full),
                                           opt_lib.leaves(sh))):
        shape = s.shard_shape(tuple(t.shape))
        if t.dim() <= 1:
            blocks.append(torch.ones(shape, dtype=t.dtype, device=dev))
            continue
        starts = tuple(x.start or 0 for x in s.index(tuple(t.shape)))
        g = torch.Generator(device=dev)
        g.manual_seed(hash((seed, i) + starts) % (2 ** 63))
        std = 0.02 if path[-1] == "embed" else t.shape[-2] ** -0.5
        blocks.append(torch.randn(shape, generator=g, device=dev)
                      .mul_(std).to(t.dtype))
    return opt_lib.unflatten(full, blocks)


def plan(layout: str) -> tuple[int, dict]:
    """The deepest cut of CELL_ARCH whose decode_32k record fits a card
    on `layout`, and its record."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    for n in range(config(CELL_ARCH).n_layers, 1, -1):
        cfg = config(CELL_ARCH, n)
        mem = dryrun.device_memory(cfg, SHAPES["decode_32k"], layout)
        if mem["argument_bytes"] + mem["activation_bytes"] \
                <= dryrun.CARD_BYTES:
            return n, dryrun.device_record(cfg, SHAPES["decode_32k"],
                                           layout)
    raise RuntimeError(f"no cut of {CELL_ARCH} fits a card on {layout}")


def _nccl_share(prof, wall_ms: float) -> dict | None:
    spans = {"nccl": [], "other": []}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans["nccl" if "nccl" in e.name.lower() else "other"].append(
                (e.time_range.start, e.time_range.end))
    busy = cs._union_ms(spans["nccl"] + spans["other"])
    if busy <= 0:              # the profiler saw no device time
        return None
    nccl = cs._union_ms(spans["nccl"])
    return dict(wall_ms=wall_ms, busy_ms=busy, nccl_ms=nccl,
                nccl_share=nccl / wall_ms,
                exposed_nccl_ms=busy - cs._union_ms(spans["other"]))


def _profiled(fn, dev):
    """The NCCL share of `fn`'s wall under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    return _nccl_share(prof, wall)


def cell_rank(rank: int, runs) -> dict:
    """Parts (0) and (a) on one rank: (a) for each (mesh shape, layers) of
    `runs`."""
    from repro_torch.configs import SHAPES
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    dev = card()
    shape = SHAPES["decode_32k"]
    out = {"rank": rank, "card": torch.cuda.get_device_name(dev),
           "check": {d: cs.sharded_decode(rank, (4, 1), cs.SHARD_LAYERS,
                                          dev, d)
                     for d in ("float32", "bfloat16")}}
    for mesh_shape, n_layers in runs:
        cfg = config(CELL_ARCH, n_layers)
        mesh = launch_mesh.make_debug_mesh(*mesh_shape, device="cuda")
        cs.warm_groups(mesh, dev)
        rules = shd.set_mesh(mesh)
        if not (rules.mp and cfg.n_experts % rules.axis_size("mp") == 0):
            raise RuntimeError("the MoE layers would not take the "
                               "expert-parallel path")
        sh = M.param_shardings(cfg)
        local = seeded_blocks(cfg, sh, dev)
        rows = shd.batch_rows(shape.global_batch)
        cache = M.init_cache(cfg, rows.stop - rows.start, shape.seq_len,
                             device=dev)
        for i, leaf in enumerate(opt_lib.leaves(cache)):
            g = torch.Generator(device=dev)
            g.manual_seed(hash((1, i, rows.start)) % (2 ** 63))
            leaf.normal_(generator=g)
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab, (DECODE_STEPS + 1, shape.global_batch, 1)),
            device=dev)[:, rows]
        pos = shape.seq_len - 1
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        ms, finite = [], True
        with torch.no_grad():
            for i in range(DECODE_STEPS):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                logits, cache = M.decode_step(local, cache, toks[i], pos,
                                              cfg, shardings=sh)
                torch.cuda.synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                finite &= bool(torch.isfinite(logits.float()).all())
            peak = torch.cuda.max_memory_allocated(dev)
            prof = _profiled(lambda: M.decode_step(
                local, cache, toks[-1], pos, cfg, shardings=sh), dev)
        if not finite:
            raise RuntimeError(f"{mesh_shape}: logits not finite")
        out[str(mesh_shape)] = dict(
            layers=n_layers, local_batch=rows.stop - rows.start, ms=ms,
            peak_bytes=peak, held_bytes=held, profiled=prof,
            logits_shape=list(logits.shape))
        shd.set_mesh(None)
        del local, cache, logits
        torch.cuda.empty_cache()
    return out


def serve_rank(rank: int, minutes: int, root: str) -> dict:
    """Part (b) on one rank."""
    from repro_torch.core import gbdt, pipeline
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M
    dev = card()
    cfg = config(SERVE_ARCH)
    # the AAPAset build places its chunks by a lane mesh: before the world
    # mesh is active
    trained = pipeline.train_classifier(
        "aapaset_ci", gbdt.GBDTConfig(n_rounds=10, depth=3),
        root=f"{root}/rank{rank}", cache=False, device="cuda")
    mesh = launch_mesh.make_debug_mesh(torch.distributed.get_world_size(),
                                       1, device="cuda")
    cs.warm_groups(mesh, dev)
    shd.set_mesh(mesh)
    sh = M.param_shardings(cfg)
    t0 = time.perf_counter()
    local = seeded_blocks(cfg, sh, dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        eng, auto = launcher.serve(
            minutes, "aapa", trained, local, cfg,
            launcher.bursty_rates(minutes), np.random.default_rng(0),
            device="cuda")
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        toks = np.ones((eng.max_replicas * eng.lanes, 1), np.int64)
        ms = []
        for i in range(TIMED_STEPS):
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            eng._decode(toks, i)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t1) * 1e3)
        prof = _profiled(lambda: eng._decode(toks, 0), dev)
    peak = torch.cuda.max_memory_allocated(dev)
    finite = bool(torch.isfinite(eng.last_logits.float()).all())
    shd.set_mesh(None)
    return dict(rank=rank, card=torch.cuda.get_device_name(dev),
                summary=eng.summary(), trace=auto.decision_trace(),
                decode_steps=eng.decode_steps, wall_s=wall, init_s=init_s,
                ms=ms, profiled=prof, peak_bytes=peak, finite=finite,
                rows=[eng.rows.start, eng.rows.stop], launches=launches,
                trained=trained.to("cpu") if rank == 0 else None)


def cpu_summary(trained, minutes: int) -> dict:
    """The same script at smoke width on the CPU with `trained`."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M
    cfg = smoke_config(get_config(SERVE_ARCH))
    eng, auto = launcher.serve(
        minutes, "aapa", trained, M.init(0, cfg, device="cpu"), cfg,
        launcher.bursty_rates(minutes), np.random.default_rng(0),
        device="cpu", log=lambda *_: None)
    return dict(summary=eng.summary(), trace=auto.decision_trace())


def _same_trace(a, b) -> bool:
    return all(np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f)), equal_nan=True)
               for f in a._fields)


def main() -> int:
    from repro_torch.configs import SHAPES
    from repro_torch.dist import world
    if not torch.cuda.is_available():
        print("run_sharded_serving: CUDA is not available", file=sys.stderr)
        return 1
    n = torch.cuda.device_count()
    if n != 4:
        print(f"run_sharded_serving: needs four cards, found {n}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    cards = smi.splitlines()
    cs.log(f"cards ({n}):\n{smi}")
    root = cs.scratch_dir() / "sharded_serving"
    kw = dict(backend="nccl", root=root, deadline_s=DEADLINE_S)
    out = {"cards": cards, "n": n}

    # (a) the decode_32k cell
    full = config(CELL_ARCH).n_layers
    n22, rec22 = plan("2x2")
    n41, rec41 = plan("4x1")
    if n41 != full:
        raise RuntimeError(f"the dry run puts {n41} layers on (4, 1)")
    recs = {"(4, 1)": rec41, "(2, 2)": rec22}
    t0 = time.perf_counter()
    part_a = world.spawn(cell_rank, n, args=(
        [((4, 1), full), ((2, 2), n22)],), **kw)
    out["cell"] = dict(wall_s=time.perf_counter() - t0, ranks=part_a,
                       records={k: v["memory"] | {
                           "collectives": v["collectives"]}
                           for k, v in recs.items()})
    for d, c in part_a[0]["check"].items():
        for i, e in enumerate(c["errors"]):
            cs.log(f"[sharded decode] (4, 1) {d}: "
                   f"{'prefill' if i == 0 else f'step {i}'} logits rel. "
                   f"err {e['rel']:.3g} against one card (gate "
                   f"{cs.SHARD_DECODE_TOL if d == 'float32' else None}), "
                   f"max |diff| {e['max_abs']:.4g}; greedy tokens equal: "
                   f"{e['greedy'] == e['greedy_single']}")
        by_rank = [[round(x, 3) for x in r["check"][d]["ms"]]
                   for r in part_a]
        cs.log(f"[sharded decode] (4, 1) {d}: decode {by_rank} ms a step "
               f"by rank, on one card "
               f"{[round(x, 3) for x in c['single_ms']]} [{cards[0]}]")
    for key, layers in (("(4, 1)", full), ("(2, 2)", n22)):
        want = recs[key]["memory"]["total_bytes"]
        for r in part_a:
            m = r[key]
            prof = m["profiled"]
            cs.log(f"[decode_32k] {CELL_ARCH} mesh {key} at {layers} of "
                   f"{full} layers, rank {r['rank']} ({r['card']}): local "
                   f"batch {m['local_batch']}, "
                   f"{[round(x, 3) for x in m['ms']]} ms a step at position "
                   f"{SHAPES['decode_32k'].seq_len - 1}, peak "
                   f"{m['peak_bytes']} bytes "
                   f"against the dry run's {want} "
                   f"({m['peak_bytes'] / want - 1:+.2%}), NCCL share of a "
                   f"profiled step "
                   f"{None if prof is None else round(prof['nccl_share'], 4)}"
                   f" [{cards[r['rank']]}]")

    # (b) deepseek_67b serving the launcher's script
    t0 = time.perf_counter()
    part_b = world.spawn(serve_rank, n, args=(MINUTES, str(root)), **kw)
    out["serve_wall_s"] = time.perf_counter() - t0
    cpu = cpu_summary(part_b[0]["trained"], MINUTES)
    same = all(r["summary"] == part_b[0]["summary"]
               and _same_trace(r["trace"], part_b[0]["trace"])
               for r in part_b)
    same_cpu = part_b[0]["summary"] == cpu["summary"] \
        and _same_trace(part_b[0]["trace"], cpu["trace"])
    for r in part_b:
        prof = r["profiled"]
        cs.log(f"[serve] {SERVE_ARCH} on (4, 1), rank {r['rank']} "
               f"({r['card']}): rows {r['rows']}, {r['decode_steps']} decode "
               f"steps in the {MINUTES}-minute script ({r['wall_s']:.1f} s), "
               f"decode {[round(x, 1) for x in r['ms']]} ms a step, NCCL "
               f"share of a profiled step "
               f"{None if prof is None else round(prof['nccl_share'], 4)} "
               f"({prof}), peak {r['peak_bytes']} bytes, params drawn in "
               f"{r['init_s']:.1f} s, logits finite {r['finite']}, kernel "
               f"launches in the run {r['launches']} [{cards[r['rank']]}]")
    cs.log(f"[serve] summary {part_b[0]['summary']}; every rank's summary "
           f"and decisions equal: {same}; equal to the CPU's at smoke "
           f"width: {same_cpu}")
    for r in part_b:
        r.pop("trace")
        r.pop("trained")
    out["serve"] = dict(ranks=part_b, cpu_summary=cpu["summary"],
                        ranks_equal=same, cpu_equal=same_cpu)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "sharded_serving.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(smi)
    print(json.dumps(out, default=str))
    # the AAPA classifier's kernels ran on every card
    kernels = all(
        r["launches"].get(k, 0) > 0 for r in part_b
        for k in ("window_features", "gbdt_tables"))
    if not (same and same_cpu and kernels
            and all(r["finite"] for r in part_b)):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
