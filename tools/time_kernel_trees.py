#!/usr/bin/env python3
"""Time the ``holt_winters``, ``window_features``, ``gbdt_tables`` and
``plant_block`` kernels and the reclassification of several source trees
in turns on one card.

    python3 tools/time_kernel_trees.py TREE [TREE ...] [--rounds 2]

Each TREE is a directory that holds a ``src/repro_torch`` package (``.``
is this checkout), typically two versions of the kernels to compare.
Round after round, each tree runs in a process of its own (the order
reversed every other round: A B, B A, ...), builds its kernels into its
own ``build/`` and, with CUDA events (one warm-up call, then the mean of
10 calls):

- ``kernels.ops.extract_features_fused`` (38 features, the
  classification path's launch) and ``kernels.ops.window_features`` (28)
  over the 301,650 AAPAset windows (``generate_traces(n_functions=150,
  n_days=14, seed=0)``, 60-minute windows at stride 10);
- ``kernels.ops.holt_winters`` at period 60 over a 100,000 x 2,880 split
  of seeded gamma rates made on the card (the calibration split's shape);
- ``forecast.conformal.calibrate`` of Holt-Winters at alpha 0.9 over that
  split (host clock, ending in a synchronize, after a warm-up call);
- ``kernels.ops.gbdt_logits`` of the tree's ``chip_smoke.
  seeded_classifier`` (60 rounds x 4 classes, depth 4) over those
  windows' 38 features, and the host's time to enqueue one such launch
  (the mean of 100 calls without a synchronize);
- the classification path, features -> logits -> calibrated archetype
  with that classifier (chip_smoke.py phase 8's path): the median of 20
  host-clock runs, each ending in a synchronize, after a warm-up run;
- ``kernels.ops.plant_tick_block`` (the default ci's 14 ticks, S=30) on
  ``chip_smoke.plant_inputs`` at 1024 and 100,003 lanes, 20 launches
  replayed from one CUDA graph (chip_smoke.py phase 6's timing);
- the wide ``window_features`` kernel (38 features) at 65, 90, 120, 211,
  360 and 1,024 samples on those traces' windows at stride 140
  (chip_smoke.py phase 8's ~21,000 windows a width), and forced at 45
  (the AAPAset windows' first 45 samples) and 64 (the traces' 64-minute
  windows at stride 10) beside the generic kernel on the same windows;
- ``kernels.policy_signals.reclassify_cuda`` with that classifier on a
  ``scenarios.burst_storm`` 25,000 x 1440 chunk at stride 10 with
  ``history_len`` 90 and 120 (chip_smoke.py phase 9's launch).

Every run prints a fingerprint of each output (sums of its bit
patterns), and the script fails if two trees' fingerprints differ: the
trees must compute the same features and forecasts.

Output: one JSON line per tree run, a summary line per measurement, then
the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

WIDE_WIDTHS = (65, 90, 120, 211, 360, 1024)
FORCED_WIDTHS = (45, 64)
HISTORY_LENS = (90, 120)
MEASURES = ("window_features_38_ms", "window_features_28_ms",
            "holt_winters_ms", "calibrate_s", "gbdt_tables_ms",
            "gbdt_tables_enqueue_us", "classify_path_ms",
            "plant_block_1024_ms", "plant_block_100003_ms",
            *(f"wide_{w}_ms" for w in WIDE_WIDTHS),
            *(f"{v}_{w}_ms" for w in FORCED_WIDTHS
              for v in ("generic", "wide")),
            *(f"reclassify_{h}_ms" for h in HISTORY_LENS))


def cuda_ms(fn, iters: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def fingerprint(t) -> int:
    import torch
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    weights = torch.arange(1, bits.shape[-1] + 1, device=t.device,
                           dtype=torch.int64)
    return int((bits * weights).sum())


def child(tree: Path) -> None:
    """Time one tree's kernels; prints one JSON line."""
    sys.path.insert(0, str(tree.resolve() / "src"))
    sys.path.insert(0, str(tree.resolve()))
    import time

    import numpy as np
    import torch
    from chip_smoke import graph_ms, plant_inputs, seeded_classifier
    from repro_torch.data import azure_synth, windows
    from repro_torch.forecast import conformal
    from repro_torch.forecast import registry as forecast_registry
    from repro_torch.kernels import _build, ops, policy_signals
    from repro_torch.kernels import window_features as wf
    from repro_torch.scaling import scenarios
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.extension()
    row = dict(build_s=time.perf_counter() - t0)
    traces = azure_synth.generate_traces(n_functions=150, n_days=14, seed=0)
    wins = torch.as_tensor(windows.make_windows(traces).windows, device=dev)
    row["window_features_38_ms"] = cuda_ms(
        lambda: ops.extract_features_fused(wins))
    row["window_features_28_ms"] = cuda_ms(lambda: ops.window_features(wins))
    gen = torch.Generator(device=dev).manual_seed(1)
    split = torch.empty((100_000, 2_880), device=dev).exponential_(
        1 / 60.0, generator=gen)
    row["holt_winters_ms"] = cuda_ms(lambda: ops.holt_winters(split))
    fcst = forecast_registry.make("holt_winters")
    conformal.calibrate(fcst, split, alpha=0.9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    band = conformal.calibrate(fcst, split, alpha=0.9)
    torch.cuda.synchronize()
    row["calibrate_s"] = time.perf_counter() - t0
    feats = ops.extract_features_fused(wins)
    cls = seeded_classifier(feats.cpu().numpy(), dev)
    params = cls.params
    row["gbdt_tables_ms"] = cuda_ms(lambda: ops.gbdt_logits(params, feats))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        ops.gbdt_logits(params, feats)
    row["gbdt_tables_enqueue_us"] = (time.perf_counter() - t0) * 1e4
    walls = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cls(ops.extract_features_fused(wins))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    row["classify_path_ms"] = float(np.median(walls[1:]))
    plants = {}
    for lanes in (1024, 100_003):
        args = plant_inputs(np.random.default_rng(lanes), lanes, 30, dev)
        row[f"plant_block_{lanes}_ms"] = graph_ms(
            lambda: ops.plant_tick_block(*args, n_ticks=14), iters=20)
        state, ticks = ops.plant_tick_block(*args, n_ticks=14)
        plants[lanes] = sum(fingerprint(t) for t in (*state, *ticks))
    wide = []
    for width in WIDE_WIDTHS:
        x = torch.as_tensor(windows.make_windows(
            traces, window=width, stride=140).windows, device=dev)
        row[f"wide_{width}_ms"] = cuda_ms(
            lambda: wf.window_features_cuda(x, freq=True))
        wide.append(fingerprint(wf.window_features_cuda(x, freq=True)))
    for width in FORCED_WIDTHS:
        x = (wins[:, :width].contiguous() if width <= wins.shape[1] else
             torch.as_tensor(windows.make_windows(traces, window=width)
                             .windows, device=dev))
        for variant in ("generic", "wide"):
            row[f"{variant}_{width}_ms"] = cuda_ms(
                lambda: wf.window_features_cuda(x, freq=True,
                                                variant=variant))
            wide.append(fingerprint(wf.window_features_cuda(
                x, freq=True, variant=variant)))
    del x
    storm = torch.as_tensor(scenarios.burst_storm(
        n_workloads=25_000, minutes=1440, seed=0).rates, device=dev)
    for hl in HISTORY_LENS:
        row[f"reclassify_{hl}_ms"] = cuda_ms(
            lambda: policy_signals.reclassify_cuda(storm, cls, 10, hl),
            iters=3)
        arch, conf = policy_signals.reclassify_cuda(storm, cls, 10, hl)
        wide += [fingerprint(arch), fingerprint(conf)]
    row["fingerprint"] = [*wide, fingerprint(feats),
                          fingerprint(ops.window_features(wins)),
                          fingerprint(ops.holt_winters(split)),
                          float(band.q), float(band.scale),
                          fingerprint(ops.gbdt_logits(params, feats)),
                          plants[1024], plants[100_003]]
    print(json.dumps({"tree": str(tree), **row}), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trees", nargs="*", type=Path)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child is not None:
        child(args.child)
        return 0
    import torch
    if not torch.cuda.is_available() or not args.trees:
        print("time_kernel_trees: needs a CUDA device and at least one "
              "tree", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    runs = []
    for r in range(args.rounds):
        for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
            res = subprocess.run([sys.executable, __file__, "--child",
                                  str(tree)], capture_output=True, text=True,
                                 timeout=1800, env=dict(os.environ))
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    same = len({json.dumps(run["fingerprint"]) for run in runs}) == 1
    for key in MEASURES:
        times = {str(t): [run[key] for run in runs if run["tree"] == str(t)]
                 for t in args.trees}
        print(f"[summary] {key}: " + ", ".join(
            f"{t} {v}" for t, v in times.items()), flush=True)
    print(f"[summary] same outputs in every tree: {same}")
    print(smi)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
