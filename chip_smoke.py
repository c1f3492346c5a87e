#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Print the card (``nvidia-smi`` name and power limit) and build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed).
2. ``plant_block`` kernel vs its plain PyTorch version on the card:
   100,003 random lanes (not a multiple of the block size), S=30,
   n_ticks in {14, 29, 3}; rtol/atol 1e-5.
3. ``episode_block`` kernel vs its plain version (the blocked simulate):
   HPA on ``burst_storm(n_workloads=4099, minutes=30)`` at control
   intervals 15 and 7 (remainder block); rtol 3e-6 / atol 1e-4 on all 12
   MinuteOut fields.
4. The unfused path (``simulate(..., decide_kernel=False)``: one
   ``plant_block`` launch per control period) against the fused episode
   kernel on ``archetype_mix(n_workloads=1024, minutes=120)``.
5. The main path at fleet scale, the paper's Table IV baseline row: HPA
   over ``burst_storm(n_workloads=100_000, minutes=1440, seed=0)``,
   default SimConfig (ci=15), ``make_simulator(w_chunk=25_000)`` on the
   episode kernel, then ``metrics.pooled`` and ``evals.rei.rei``.
6. Each kernel against its plain version once more at the shapes its
   path gives it (``episode_block`` on one 25,000 x 1440 chunk of the
   fleet, ``plant_block`` at 1024 lanes x S=30 x 14 ticks), with the
   tolerances above, and per-kernel times at those shapes (CUDA events;
   ``plant_block`` and its plain version replayed from a CUDA graph, so
   the host's per-launch overhead is not counted), against the card's
   bound.
7. One more fleet run under ``torch.profiler``: device time by kernel and
   the device's busy share of the wall time.

Phases 4 and 5 each reset the kernels' launch counts just before they
run and read them just after; a path whose kernel was never launched
fails. Kernel-vs-plain comparisons and timing launches are not counted.

Output: progress lines, then a JSON line of per-kernel numbers, then the
``nvidia-smi`` line, then the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores

# f32 operations per lane and tick, counted from the CUDA sources:
# flow_tick 28 (5 of them divisions), pipeline pop 3, cooldown decay 2,
# total replicas 1 (plant_block); the episode kernel adds the minute fold
# (11) in place of the cooldown decay and, per control-period head,
# decide + limiter + scaling (52) plus the HPA window max (buf_len).
PLANT_OPS_PER_TICK = 34
EPISODE_OPS_PER_TICK = 42
EPISODE_OPS_PER_HEAD = 52

PLANT_TOL = dict(rtol=1e-5, atol=1e-5)
EPISODE_TOL = dict(rtol=3e-6, atol=1e-4)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: bool = True):
    """(mean device time of `fn` over `iters` calls bracketed by CUDA
    events, the last call's result); one warm-up call first unless the
    caller already ran it."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        result = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, result


def graph_ms(fn, iters: int) -> float:
    """Device time per call of `fn`: `iters` calls captured in one CUDA
    graph, one replay bracketed by CUDA events (no host launch overhead
    inside the timed region)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # allocator and lazy init
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got, want, tol, what: str) -> float:
    worst = 0.0
    for i, (a, e) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, e, **tol, msg=lambda m: f"{what}[{i}]: {m}")
        worst = max(worst, float((a - e).abs().max()))
    return worst


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plant_bytes(B: int, S: int, T: int) -> float:
    # read 7 state columns + pipeline; write 6 state columns, pipeline
    # and 7 per-tick arrays
    return 4.0 * B * (7 + S + 6 + S + 7 * T)


def plant_inputs(rng, B: int, S: int, dev):
    pipeline = rng.gamma(1.0, 0.6, (B, S)).astype(np.float32)
    cols = (rng.gamma(2.0, 2.0, B), pipeline, rng.gamma(1.0, 25.0, B),
            rng.gamma(1.0, 5.0, B), rng.random(B), rng.uniform(0.0, 20.0, B),
            pipeline.sum(axis=1), rng.gamma(2.0, 30.0, B))
    return [torch.as_tensor(np.asarray(c, np.float32), device=dev)
            for c in cols]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.evals import metrics, rei
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.scaling import registry, scenarios
    from repro_torch.sim import cluster

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 1. build
    t0 = time.perf_counter()
    _build.extension()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(s.name for s in _build.SOURCES)})")

    # ---- 2. plant_block kernel vs plain
    rng = np.random.default_rng(0)
    B, S = 100_003, 30
    plant_err = 0.0
    for n_ticks in (14, 29, 3):
        args = plant_inputs(rng, B, S, dev)
        ks, kt = ops.plant_tick_block(*args, n_ticks=n_ticks)
        rs, rt = ref.plant_block_ref(*args, n_ticks=n_ticks)
        plant_err = max(plant_err,
                        max_abs_err(ks, rs, PLANT_TOL, f"state T={n_ticks}"),
                        max_abs_err(kt, rt, PLANT_TOL, f"ticks T={n_ticks}"))
    torch.cuda.synchronize()
    log(f"[plant_block] B={B} S={S} n_ticks=14/29/3 match the plain "
        f"version, max_abs_err={plant_err}")

    # ---- 3. episode_block kernel vs plain
    sc = scenarios.burst_storm(n_workloads=4099, minutes=30)
    rates = torch.as_tensor(sc.rates, device=dev)
    episode_err = 0.0
    for ci in (15, 7):
        cfg = cluster.SimConfig(control_interval_sec=ci)
        ctrl = registry.make("hpa", cfg)
        got = ops.episode_block(rates, ctrl, cfg)
        want = ref.episode_block_ref(rates, ctrl, cfg)
        episode_err = max(episode_err, max_abs_err(
            got, want, EPISODE_TOL, f"episode ci={ci}"))
    torch.cuda.synchronize()
    log(f"[episode_block] burst_storm 4099x30 ci=15/7 matches the plain "
        f"version, max_abs_err={episode_err}")

    # ---- 4. unfused path (plant_block per control period) vs fused
    cfg = cluster.SimConfig()
    ctrl = registry.make("hpa", cfg)
    mix = torch.as_tensor(
        scenarios.archetype_mix(n_workloads=1024, minutes=120).rates,
        device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    unfused = cluster.simulate(mix, ctrl, cfg, decide_kernel=False)
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    unfused_counts = ops.launch_counts()
    if unfused_counts["plant_block"] == 0:
        raise RuntimeError(f"unfused path launched no plant_block kernel: "
                           f"{unfused_counts}")
    fused = cluster.simulate(mix, ctrl, cfg)
    paths_err = max_abs_err(unfused, fused, EPISODE_TOL, "unfused vs fused")
    log(f"[paths] archetype_mix 1024x120: unfused path ({unfused_s:.3f} s,"
        f" launches {unfused_counts}) agrees with the fused kernel, "
        f"max_abs_err={paths_err}")

    # ---- 5. main path at fleet scale
    W, M, w_chunk = 100_000, 1440, 25_000
    t0 = time.perf_counter()
    fleet = scenarios.burst_storm(n_workloads=W, minutes=M, seed=0)
    fleet_rates = torch.as_tensor(fleet.rates, device=dev)
    log(f"[fleet] burst_storm {W}x{M} generated in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({fleet_rates.numel() * 4 / 1e6:.0f} MB of rates on the card)")
    sim = cluster.make_simulator(ctrl, cfg, w_chunk=w_chunk)

    def main_path():
        """Episode, then pooled metrics and REI: (out, wall of the
        episode, pool, score)."""
        t0 = time.perf_counter()
        out = sim(fleet_rates)
        torch.cuda.synchronize()
        episode_s = time.perf_counter() - t0
        pool = metrics.pooled(out)
        score = rei.rei(pool.slo_violation_rate, pool.replica_minutes,
                        pool.scaling_actions, minutes=M, n_workloads=W)
        torch.cuda.synchronize()
        return out, episode_s, pool, score

    main_path()                               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, episode_s, pool, score = main_path()
    main_s = time.perf_counter() - t0
    main_counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if main_counts["episode_block"] == 0:
        raise RuntimeError(f"main path launched no episode_block kernel: "
                           f"{main_counts}")
    if tuple(out.served.shape) != (W, M):
        raise RuntimeError(f"MinuteOut shape {tuple(out.served.shape)}")
    for name, v in (*pool._asdict().items(), *score._asdict().items()):
        if not torch.isfinite(v).all():
            raise RuntimeError(f"non-finite {name}: {v}")
    if not all(bool(torch.isfinite(f).all()) for f in out):
        raise RuntimeError("non-finite MinuteOut values")
    served = float(out.served.double().sum())
    arrivals = float(fleet_rates.double().sum())
    if served > arrivals + 1e-3 * arrivals:
        raise RuntimeError(f"served {served} exceeds arrivals {arrivals}")
    log(f"[fleet] episode wall {episode_s:.4f} s "
        f"({W * M / episode_s:.6g} lane-minutes/s), episode + metrics + "
        f"REI {main_s:.4f} s, peak device memory {peak} bytes, "
        f"launches {main_counts}")
    log(f"[fleet] pooled slo_violation_rate={float(pool.slo_violation_rate)}"
        f" replica_minutes={float(pool.replica_minutes)}"
        f" scaling_actions={float(pool.scaling_actions)}"
        f" p95_ms={float(pool.p95_response_ms)}"
        f" rei={float(score.rei)} served={served} arrivals={arrivals}")

    # ---- 6. kernels vs plain at their paths' shapes, and their times
    chunk = fleet_rates[:w_chunk]
    ep_ms, got = cuda_ms(lambda: ops.episode_block(chunk, ctrl, cfg),
                         iters=3)
    # one plain run (~3.5M eager launches); phases 3-4 warmed its path
    ep_plain_ms, want = cuda_ms(
        lambda: ref.episode_block_ref(chunk, ctrl, cfg), iters=1,
        warmup=False)
    ep_main_err = max_abs_err(got, want, EPISODE_TOL,
                              f"episode {w_chunk}x{M}")
    episode_err = max(episode_err, ep_main_err)
    del got, want
    log(f"[episode_block] fleet chunk {w_chunk}x{M} ci="
        f"{cfg.control_interval_sec} matches the plain version, "
        f"max_abs_err={ep_main_err}")
    buf_len = int(ctrl.hyper["buf_len"])
    ci, n_full, rem = cluster._ci_blocks(cfg)
    heads = n_full + (rem > 0)
    downs = float(out.downs[:w_chunk].double().sum())
    ep_ops = (w_chunk * M * (60 * EPISODE_OPS_PER_TICK
                             + heads * (EPISODE_OPS_PER_HEAD + buf_len))
              + downs * cfg.startup_sec)
    ep_bound, ep_by = bound_ms(13.0 * 4 * w_chunk * M, ep_ops)

    Bu = mix.shape[0]
    pb = plant_inputs(np.random.default_rng(1), Bu, cfg.startup_sec, dev)
    T = ci - 1
    pb_k = ops.plant_tick_block(*pb, n_ticks=T)
    pb_r = ref.plant_block_ref(*pb, n_ticks=T)
    pb_main_err = max(
        max_abs_err(pb_k[0], pb_r[0], PLANT_TOL, f"state B={Bu} T={T}"),
        max_abs_err(pb_k[1], pb_r[1], PLANT_TOL, f"ticks B={Bu} T={T}"))
    plant_err = max(plant_err, pb_main_err)
    del pb_k, pb_r
    log(f"[plant_block] B={Bu} S={cfg.startup_sec} n_ticks={T} "
        f"matches the plain version, max_abs_err={pb_main_err}")
    pb_ms = graph_ms(lambda: ops.plant_tick_block(*pb, n_ticks=T),
                     iters=20)
    pb_plain_ms = graph_ms(lambda: ref.plant_block_ref(*pb, n_ticks=T),
                           iters=3)
    pb_host_ms, _ = cuda_ms(lambda: ops.plant_tick_block(*pb, n_ticks=T),
                            iters=20)
    pb_bound, pb_by = bound_ms(plant_bytes(Bu, cfg.startup_sec, T),
                               Bu * T * PLANT_OPS_PER_TICK)
    big = plant_inputs(np.random.default_rng(2), B, S, dev)
    big_ms = graph_ms(lambda: ops.plant_tick_block(*big, n_ticks=T),
                      iters=20)
    big_plain_ms = graph_ms(lambda: ref.plant_block_ref(*big, n_ticks=T),
                            iters=3)
    big_bound, big_by = bound_ms(plant_bytes(B, S, T),
                                 B * T * PLANT_OPS_PER_TICK)
    log(f"[timing] episode_block {w_chunk}x{M}: {ep_ms} ms, plain "
        f"{ep_plain_ms} ms, bound {ep_bound} ms ({ep_by})")
    log(f"[timing] plant_block B={Bu} S={S} T={T}: {pb_ms} ms "
        f"(eager back-to-back calls: {pb_host_ms} ms each), plain "
        f"{pb_plain_ms} ms, bound {pb_bound} ms ({pb_by})")
    log(f"[timing] plant_block B={B} S={S} T={T}: {big_ms} ms, plain "
        f"{big_plain_ms} ms, bound {big_bound} ms ({big_by})")

    # ---- 7. where the fleet run's device time goes
    del out, pool, score
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        main_path()
        prof_s = time.perf_counter() - t0
    by_kernel = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and e.self_device_time_total > 0), reverse=True)
    device_ms = sum(t for t, _, _ in by_kernel) / 1e3
    log(f"[profile] fleet episode + metrics + REI: wall {prof_s:.4f} s "
        f"under the profiler, device busy {device_ms:.3f} ms "
        f"({device_ms / (prof_s * 1e3):.4f} of wall)")
    for t, n, key in by_kernel[:10]:
        log(f"[profile]   {t / 1e3:10.3f} ms  x{n:<6d} {key[:90]}")

    kernels = [
        dict(name="plant_block", route="cuda",
             source="src/repro_torch/kernels/csrc/plant_block.cu",
             replaces="src/repro/kernels/plant_block.py:96",
             launches=unfused_counts["plant_block"], max_abs_err=plant_err,
             ms=pb_ms, plain_ms=pb_plain_ms, bound_ms=pb_bound,
             bound_by=pb_by, library_ms=None),
        dict(name="episode_block", route="cuda",
             source="src/repro_torch/kernels/csrc/episode_block.cu",
             replaces="src/repro/kernels/episode_block.py:210",
             launches=main_counts["episode_block"],
             max_abs_err=episode_err, ms=ep_ms, plain_ms=ep_plain_ms,
             bound_ms=ep_bound, bound_by=ep_by, library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
