#!/usr/bin/env python3
"""Model sharding of ``deepseek_v2_lite_16b`` over every visible card of
one host: one process a card (``repro_torch.dist.world.spawn``, NCCL, a
``file://`` store under ``build/``).

    python3 tools/run_sharded_training.py            # on the cards
    python3 tools/run_sharded_training.py --reckon   # the bytes, no card

1. ``chip_smoke.py``'s phase 35 over meshes (2, 2) and (4, 1) of four
   cards ((n, 1) on n cards): the full-width config cut to
   ``chip_smoke.SHARD_LAYERS`` layers, two sharded steps of the
   launcher's 8 x 64 batch, the first held against rank 0's unsharded
   step (``chip_smoke.check_step``: the loss, grad_norm, each leaf's new
   first moment and the new params), and one step without dropped tokens
   held so against its own unsharded step (``chip_smoke.SHARD_TOL``).
2. The deep run: before it, each layout's bytes a card are reckoned by
   ``launch.dryrun.device_memory``, the memory of the dry run's per-device
   record of the step (`reckon`: the params and the f32 master, m and v,
   the batch, and the larger of the backward's working set (with a
   gathered layer and its gradient) and AdamW's: the gradients, the new
   state beside the old and its f64 temporaries); the layout with the
   fewest runs the deepest cut whose reckoning fits CARD_SHARE of a
   card's memory (all 27 layers when they fit), DEEP_STEPS steps at one
   microbatch. Gate: finite losses. Per card: each step's wall and peak
   memory, and under ``torch.profiler`` the share of one step's wall
   that NCCL kernels take (the union of their spans, which include
   waiting for the other ranks), the union of every kernel's spans
   (busy) and the time in which only NCCL kernels ran (exposed).
3. Resume: RESUME_LAYERS layers at full width on the (n, 1) mesh with
   deterministic algorithms, steps 1-2, a sharded checkpoint
   (``train.checkpoint.save(..., shardings=...)``) at step 2, steps 3-4;
   restored onto fresh state (``restore(..., shardings=...)``), steps
   3-4 again equal the uninterrupted run bit for bit (losses and every
   rank's blocks of params, master, m and v).

Prints the cards' names and power limits, a line per result, and as the
last line a JSON object of the numbers, also written to
``chiprun_out/sharded_training.json``. ``--reckon`` prints the
reckoning of every layout and depth. The same sharded step on the CPU, in
gloo ranks, is held against the reference by ``tests/test_torch_dist_*``.
"""
import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

DEEP_STEPS = 3
RESUME_LAYERS = 2
# the share of a card's memory the deep run's reckoned peak may take
CARD_SHARE = 0.85
DEADLINE_S = 1500


def reckon(n_layers: int, shape) -> dict:
    """Bytes a card of `shape` = (data, model) holds for one sharded step
    of SHARD_ARCH cut to `n_layers` on the launcher's batch: the memory of
    ``launch.dryrun``'s per-device record (see the module docstring)."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    cfg = cs.shard_cfg(n_layers)
    rows, seq = cs.TRAIN_BATCH
    mem = dryrun.device_memory(cfg,
                             ShapeSpec("launcher", seq, rows, "train"),
                             f"{shape[0]}x{shape[1]}")
    parts = mem["parts"]
    return dict(layers=n_layers, shape=list(shape),
                params=sum(t.numel() for t in opt_lib.leaves(
                    M.init(0, cfg, device="meta"))),
                params_a_card=mem["params_per_device"],
                state_bytes=parts["params"] + parts["opt"],
                grad_bytes=parts["params"],
                layer_bytes=parts["gathered_layer"],
                f64_bytes=parts["f64_temps"],
                peak_bytes=mem["argument_bytes"] + mem["activation_bytes"])


def layouts(n: int) -> list[tuple[int, int]]:
    return [(d, n // d) for d in range(n, 0, -1) if n % d == 0]


def deep_rank(rank: int, shape, n_layers: int, steps: int) -> dict:
    """Part 2 on one rank: `steps` sharded steps of the launcher's batch,
    the last under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = cs.shard_cfg(n_layers)
    mesh = launch_mesh.make_debug_mesh(*shape, device=dev.type)
    cs.warm_groups(mesh, dev)
    shd.set_mesh(mesh)
    sh = M.param_shardings(cfg)
    full = M.init(0, cfg, device=dev)
    cs.same_init(full)
    local = shd.device_put(full, sh)
    del full
    torch.cuda.empty_cache()
    opt = opt_lib.init(local)
    batch = cs.launcher_batch(cfg, dev)
    lb = shd.device_put(batch, shd.batch_shardings(batch))
    ts = make_train_step(cfg)
    walls, peaks, losses, share, busy = [], [], [], None, None
    for step in range(steps):
        last = step == steps - 1
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) if last else \
                contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            local, opt, m = ts(local, opt, lb)
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated(dev))
        losses.append(float(m["loss"]))
    spans = {"nccl": [], "other": []}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans["nccl" if "nccl" in e.name.lower() else "other"].append(
                (e.time_range.start, e.time_range.end))
    busy_ms = cs._union_ms(spans["nccl"] + spans["other"])
    if busy_ms > 0:        # else the profiler saw no device time
        wall_ms = walls[-1] * 1e3
        nccl_ms = cs._union_ms(spans["nccl"])
        share = nccl_ms / wall_ms
        busy = dict(busy_ms=busy_ms, nccl_ms=nccl_ms, wall_ms=wall_ms,
                    exposed_nccl_ms=busy_ms - cs._union_ms(spans["other"]))
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"deep run: losses {losses}")
    shd.set_mesh(None)
    return dict(rank=rank, card=torch.cuda.get_device_name(dev),
                walls_s=walls, peak_bytes=peaks,
                losses=losses, collective_share=share, profiled=busy,
                params_a_card=sum(t.numel() for t in opt_lib.leaves(local)))


def resume_rank(rank: int, shape, n_layers: int, root: str) -> dict:
    """Part 3 on one rank (see the module docstring)."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = cs.shard_cfg(n_layers)
    mesh = launch_mesh.make_debug_mesh(*shape, device=dev.type)
    cs.warm_groups(mesh, dev)
    shd.set_mesh(mesh)
    full = M.init(0, cfg, device="meta")
    state_full = {"params": full, "opt": opt_lib.init(full)}
    state_sh = shd.param_shardings(state_full)
    sh = state_sh["params"]
    local = shd.device_put(M.init(0, cfg, device=dev), sh)
    opt = opt_lib.init(local)
    ts = make_train_step(cfg)
    rng_batches = [cs.launcher_batch(cfg, "cpu")]
    g = torch.Generator().manual_seed(1)
    for _ in range(3):
        t = torch.randint(0, cfg.vocab, cs.TRAIN_BATCH, generator=g,
                          dtype=torch.int32)
        rng_batches.append({"tokens": t, "labels": t})
    bsh = shd.batch_shardings(rng_batches[0])
    batches = [shd.device_put(b, bsh) for b in rng_batches]
    for b in batches[:2]:
        local, opt, _ = ts(local, opt, b)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ckpt.save(f"{root}/ckpt", 2, {"params": local, "opt": opt},
              shardings=state_sh)
    save_s = time.perf_counter() - t0
    runs = []
    for b in batches[2:]:
        local, opt, m = ts(local, opt, b)
        runs.append(float(m["loss"]))
    t0 = time.perf_counter()
    state, step = ckpt.restore(f"{root}/ckpt", state_full,
                               shardings=state_sh)
    torch.cuda.synchronize(dev)
    restore_s = time.perf_counter() - t0
    p2, o2 = state["params"], state["opt"]
    again = []
    for b in batches[2:]:
        p2, o2, m = ts(p2, o2, b)
        again.append(float(m["loss"]))
    same = again == runs and all(
        torch.equal(a, b) for a, b in zip(opt_lib.leaves((p2, o2)),
                                          opt_lib.leaves((local, opt))))
    ok = torch.tensor([float(same)], device=dev)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    if step != 2 or not bool(ok.item()):
        raise RuntimeError(f"resume on rank {rank}: losses {runs} then "
                           f"{again}, every rank the same bits: "
                           f"{bool(ok.item())}")
    shd.set_mesh(None)
    return dict(rank=rank, losses=runs, save_s=save_s,
                restore_s=restore_s, bytes=sum(
                    math.prod(t.shape) * t.element_size()
                    for t in opt_lib.leaves(state_full)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reckon", action="store_true")
    args = ap.parse_args()
    if args.reckon:
        for shape in layouts(4):
            for n_layers in (27, 20, 17, 16, 15, cs.SHARD_LAYERS):
                print(json.dumps(reckon(n_layers, shape)))
        return 0
    if not torch.cuda.is_available():
        print("run_sharded_training: CUDA is not available",
              file=sys.stderr)
        return 1
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.dist import world
    n = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    cs.log(f"cards ({n}):\n{smi}")
    root = cs.scratch_dir() / "sharded_training"
    kw = dict(backend="nccl", root=root, deadline_s=DEADLINE_S)
    out = {"cards": smi.splitlines(), "n": n}

    shapes = [(2, 2), (4, 1)] if n == 4 else [(n, 1)]
    t0 = time.perf_counter()
    part1 = world.spawn(cs.sharded_step_rank, n, args=(
        shapes, cs.SHARD_LAYERS, 2), **kw)
    out["cut_depth"] = dict(wall_s=time.perf_counter() - t0, ranks=part1)
    for variant in cs.SHARD_TOL:
        un = part1[0]["variants"][variant]["unsharded"]
        cs.log(f"[cut depth] {variant}: {cs.SHARD_LAYERS} layers at full "
               f"width ({un['n_params']} parameters): unsharded on card 0 "
               f"loss {un['loss']} grad_norm {un['grad_norm']} wall "
               f"{un['wall_s']:.3f} s peak {un['peak_bytes']} bytes")
        for r in part1:
            for shape, m in r["variants"][variant]["meshes"].items():
                e = m["errors"]
                cs.log(f"[cut depth] {variant}: mesh {shape} rank "
                       f"{r['rank']} ({r['card']}): losses {m['losses']} "
                       f"grad_norm {m['first']['grad_norm']}, walls "
                       f"{m['walls_s']} s, peaks {m['peak_bytes']} bytes, "
                       f"NCCL set-up {m['nccl_s']:.3f} s, "
                       f"{m['local_params']} parameters here"
                       + ("" if e is None else
                          f"; against the unsharded step: "
                          f"{cs.shard_readings(e)}"))

    budget = CARD_SHARE * torch.cuda.get_device_properties(0).total_memory
    plans = {shape: reckon(27, shape) for shape in layouts(n)}
    best = min(plans, key=lambda s: plans[s]["peak_bytes"])
    depth = max(d for d in range(2, 28)
                if reckon(d, best)["peak_bytes"] <= budget)
    plan = reckon(depth, best)
    out["reckoning"] = dict(budget_bytes=budget, full={str(k): v for k, v in
                                                       plans.items()},
                            run=plan)
    cs.log(f"[deep] reckoned peak a card at 27 layers: "
           f"{ {str(k): v['peak_bytes'] for k, v in plans.items()} } bytes "
           f"against {budget:.4g}; running {depth} layers on {best} "
           f"(reckoned {plan['peak_bytes']} bytes a card)")
    t0 = time.perf_counter()
    part2 = world.spawn(deep_rank, n, args=(best, depth, DEEP_STEPS), **kw)
    out["deep"] = dict(wall_s=time.perf_counter() - t0, layers=depth,
                       shape=list(best), ranks=part2)
    for r in part2:
        cs.log(f"[deep] rank {r['rank']} ({r['card']}): losses "
               f"{r['losses']}, walls {r['walls_s']} s, peaks "
               f"{r['peak_bytes']} bytes, collective share of the profiled "
               f"step {r['collective_share']} ({r['profiled']}), "
               f"{r['params_a_card']} parameters here")

    t0 = time.perf_counter()
    part3 = world.spawn(resume_rank, n, args=(
        (n, 1), RESUME_LAYERS, str(root)), **kw)
    out["resume"] = dict(wall_s=time.perf_counter() - t0, ranks=part3)
    r = part3[0]
    cs.log(f"[resume] {RESUME_LAYERS} layers on ({n}, 1): steps 3-4 losses "
           f"{r['losses']} again bit for bit after a sharded checkpoint of "
           f"{r['bytes']} bytes (save {r['save_s']:.2f} s, restore "
           f"{r['restore_s']:.2f} s on rank 0)")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "sharded_training.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(smi)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
