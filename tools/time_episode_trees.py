#!/usr/bin/env python3
"""Time the episode kernel of several source trees in turns on one card.

    python3 tools/time_episode_trees.py TREE [TREE ...] [--rounds 2]

Each TREE is a directory that holds a ``src/repro_torch`` package (``.``
is this checkout), typically two versions of the episode kernel to
compare. The script makes the inputs once: one 25,000 x 1440 chunk of
the HPA fleet row's rates (``burst_storm(n_workloads=100_000,
minutes=1440, seed=0)``, its first 25,000 lanes), the seeded GBDT +
calibration of ``chip_smoke.py``'s size (60 rounds x 4 classes, depth 4,
64 bins; edges are quantiles of the features of 20,000 windows of that
chunk) and a conformal band of Holt-Winters calibrated at alpha 0.9 on a
2,000 x 2,880 ``burst_storm`` split. Then, round after round, each tree
runs in a process of its own (the order reversed every other round:
A B, B A, ...), builds its kernels into its own ``build/``, and times
``kernels.ops.episode_block`` under the seven fleet configurations (HPA,
predictive, predictive conservative with the band, kpa, AAPA, AAPA with
the band, hybrid with the band; default SimConfig, ci 15) with CUDA
events, one warm-up launch and 3 timed launches each. Where a tree has
the pre-pass (``kernels.ops.policy_signals``) the pre-pass and the plant
pass are timed alone too. Every run also prints a fingerprint of each
episode's 12 MinuteOut fields (sums of their bit patterns, per lane and
weighted by minute), and the script fails if two trees' fingerprints
differ: the trees must compute the same episode.

Output: one JSON line per tree run, then a summary line per
configuration, then the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

W, M, CHUNK = 100_000, 1440, 25_000
CONFIGS = {
    "hpa": ("hpa", {}),
    "predictive": ("predictive", {}),
    "predictive_conservative_band": ("predictive",
                                     dict(band=True, conservative=True)),
    "kpa": ("kpa", {}),
    "aapa": ("aapa", dict(classify=True)),
    "aapa_band": ("aapa", dict(classify=True, band=True)),
    "hybrid_band": ("hybrid", dict(classify=True, band=True)),
}


def make_inputs(path: Path) -> None:
    """The rates chunk, the classifier's arrays and the band, into an
    npz (this checkout's package, on the CPU)."""
    import torch
    from repro_torch.core import features, gbdt
    from repro_torch.forecast import conformal
    from repro_torch.forecast import registry as forecast_registry
    from repro_torch.scaling import scenarios
    rates = np.ascontiguousarray(scenarios.burst_storm(
        n_workloads=W, minutes=M, seed=0).rates[:CHUNK])
    rng = np.random.default_rng(0)
    lanes = rng.integers(0, CHUNK, 20_000)
    starts = rng.integers(0, M - 60, 20_000)
    wins = np.stack([rates[b, s:s + 60] for b, s in zip(lanes, starts)])
    feats = features.extract_features(torch.as_tensor(wins)).numpy()
    c = gbdt.GBDTConfig()
    n_int = 2 ** c.depth - 1
    shape = (c.n_rounds, c.n_classes)
    split = torch.as_tensor(scenarios.burst_storm(
        n_workloads=2_000, minutes=2 * M, seed=1).rates)
    band = conformal.calibrate(forecast_registry.make("holt_winters"), split,
                               alpha=0.9, device="cpu")
    np.savez(path, rates=rates,
             feat=rng.integers(0, feats.shape[1], shape + (n_int,)),
             thresh=rng.integers(0, c.n_bins - 1, shape + (n_int,)),
             leaf=rng.normal(0.0, 0.15, shape + (n_int + 1,)),
             edges=gbdt.compute_bin_edges(feats, c.n_bins),
             base=np.log(np.float32([0.55, 0.15, 0.15, 0.15])),
             cal=np.stack([rng.normal(0.55, 0.1, 4), rng.normal(0.55, 0.1, 4),
                           rng.normal(0.0, 0.1, 4)]),
             band=np.float64([float(band.q), band.alpha, float(band.scale)]))


def cuda_ms(fn, iters: int = 3) -> float:
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


def fingerprint(out) -> list[int]:
    """Per field: the bit patterns summed with per-lane weights, and
    weighted by minute (a change of any value or its place shows)."""
    import torch
    B, Mm = out[0].shape
    gen = torch.Generator().manual_seed(0)
    lane_w = torch.randint(1, 2 ** 20, (B,), generator=gen).to(
        out[0].device, torch.int64)
    minute_w = torch.arange(1, Mm + 1, device=out[0].device,
                            dtype=torch.int64)
    prints = []
    for f in out:
        bits = f.contiguous().view(torch.int32).to(torch.int64)
        prints.append(int((bits.sum(1) * lane_w).sum()))
        prints.append(int((bits * minute_w).sum()))
    return prints


def child(tree: Path, inputs: Path) -> None:
    """Time one tree's episode kernel; prints one JSON line."""
    sys.path.insert(0, str(tree.resolve() / "src"))
    import time

    import torch
    from repro_torch.core import calibration, gbdt
    from repro_torch.core.pipeline import Classify
    from repro_torch.forecast import conformal
    from repro_torch.kernels import _build, ops
    from repro_torch.scaling import registry
    from repro_torch.sim import cluster
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.extension()
    build_s = time.perf_counter() - t0
    z = np.load(inputs)
    chunk = torch.as_tensor(z["rates"], device=dev)
    cls = Classify(gbdt.from_arrays(z["feat"], z["thresh"], z["leaf"],
                                    z["edges"], z["base"], device=dev),
                   calibration.from_arrays(*z["cal"], device=dev))
    q, alpha, scale = z["band"]
    band = conformal.ConformalBand(torch.tensor(np.float32(q), device=dev),
                                   float(alpha),
                                   torch.tensor(np.float32(scale),
                                                device=dev))
    cfg = cluster.SimConfig()
    rows = {}
    for label, (name, kw) in CONFIGS.items():
        kw = dict(kw)
        if kw.get("classify"):
            kw["classify"] = cls
        if kw.get("band"):
            kw["band"] = band
        ctrl = registry.make(name, cfg, **kw)
        torch.cuda.reset_peak_memory_stats()
        row = dict(ms=cuda_ms(lambda: ops.episode_block(chunk, ctrl, cfg)),
                   peak_bytes=torch.cuda.max_memory_allocated())
        if hasattr(ops, "policy_signals") and name in ("predictive", "aapa",
                                                       "hybrid"):
            from repro_torch.kernels import episode_block
            row["prepass_ms"] = cuda_ms(
                lambda: ops.policy_signals(chunk, ctrl, cfg))
            sig = ops.policy_signals(chunk, ctrl, cfg)
            row["plant_ms"] = cuda_ms(
                lambda: episode_block.plant_pass_cuda(chunk, ctrl, cfg, sig))
            del sig
        row["fingerprint"] = fingerprint(ops.episode_block(chunk, ctrl, cfg))
        rows[label] = row
    print(json.dumps({"tree": str(tree), "build_s": build_s, "rows": rows}),
          flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trees", nargs="*", type=Path)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    p.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child is not None:
        child(args.child, args.inputs)
        return 0
    import torch
    if not torch.cuda.is_available() or not args.trees:
        print("time_episode_trees: needs a CUDA device and at least one "
              "tree", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs.npz"
        make_inputs(inputs)
        runs = []
        for r in range(args.rounds):
            for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
                res = subprocess.run(
                    [sys.executable, __file__, "--child", str(tree),
                     "--inputs", str(inputs)], capture_output=True,
                    text=True, timeout=1800, env=dict(os.environ))
                if res.returncode != 0:
                    print(res.stdout + res.stderr, file=sys.stderr)
                    return 1
                line = res.stdout.strip().splitlines()[-1]
                print(line, flush=True)
                runs.append(json.loads(line))
    ok = True
    for label in CONFIGS:
        prints = {json.dumps(run["rows"][label]["fingerprint"])
                  for run in runs}
        same = len(prints) == 1
        ok = ok and same
        times = {str(t): [run["rows"][label]["ms"] for run in runs
                          if run["tree"] == str(t)] for t in args.trees}
        print(f"[summary] {label}: " + ", ".join(
            f"{t} {ms}" for t, ms in times.items())
              + f"; same episode in every tree: {same}", flush=True)
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
