#!/usr/bin/env python3
"""Time ``chip_smoke.py`` phase 23's unsharded fleet row of several source
trees in turns on one card.

    python3 tools/time_fleet_trees.py TREE [TREE ...] [--rounds 2]

Each TREE is a directory that holds a ``src/repro_torch`` package and a
``chip_smoke.py`` (``.`` is this checkout), typically a parent commit
unpacked with ``git archive`` and this one. The trees' kernels are built
first, all at once, each into its tree's own ``build/``; the 100,000 x
1440 ``burst_storm`` rates of phase 23's HPA + AAPA row (25,000-lane
chunks, seed 0) are generated once on the host by this checkout and
saved under ``build/``. Round after round each tree runs in a process of
its own (the order reversed every other round: A B, B A, ...), with the
AAPA lanes classified by the tree's ``chip_smoke.seeded_classifier``
(seed 0, bin edges from seeded normal features), no mesh, and measures
on the host clock (each run ending in a synchronize; one warm-up run,
then the median of `--reps`):

- ``one_dispatch_s``: ``evals.fleet.make_fleet_runner`` over the host
  rates [C, Wc, M], what ``run_fleet``'s one-dispatch mode times;
- ``stream_s``: ``evals.fleet.make_chunk_folder`` over the same chunks
  fed from the host, what ``run_fleet``'s stream times (without a
  generator);
- ``runner_s``: building that runner (``make_fleet_runner``);
- each mode's peak device memory above what the process held before.

Every run prints a fingerprint of each mode's pooled metrics
(``evals.metrics.finalize`` of the accumulators: a hash of their bytes);
the script fails if two runs' differ. The raw accumulators are not
compared: the histogram's ``index_add_`` adds floats with atomics, so its
last bits vary from run to run, below what the metrics' quantiles read.
Output: one JSON line per tree run, a summary line per measurement, then
the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RATES = ROOT / "build" / "fleet_rows" / "rates_1e5.npy"
MEASURES = ("one_dispatch_s", "stream_s", "runner_s",
            "one_dispatch_peak_bytes", "stream_peak_bytes")


def fleet_spec(fleet):
    return fleet.spec("fleet_1e5", policies=("hpa", "aapa"),
                      scenario="burst_storm", n_workloads=100_000,
                      w_chunk=25_000, minutes=1440, seed=0)


def child(tree: Path, reps: int) -> None:
    """Time one tree's fleet row; prints one JSON line."""
    sys.path.insert(0, str(tree.resolve() / "src"))
    sys.path.insert(0, str(tree.resolve()))
    import numpy as np
    import torch
    from chip_smoke import seeded_classifier
    from repro_torch.evals import fleet
    from repro_torch.evals import metrics
    from repro_torch.kernels import _build
    _build.extension()
    dev = torch.device("cuda", 0)
    sp = fleet_spec(fleet)
    rates = np.load(RATES)
    feats = np.random.default_rng(0).normal(size=(4096, 38)).astype(
        np.float32)
    cls = seeded_classifier(feats, dev)
    edges = metrics.response_edges(sp.bins, sp.sim_config().resp_cap_sec,
                                   device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def peak(fn):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - held

    row = dict(tree=str(tree))
    row["runner_s"], run = timed(
        lambda: fleet.make_fleet_runner(sp, cls, device=dev))
    fold = fleet.make_chunk_folder(sp, cls, device=dev)

    def stream():
        acc = fleet._acc0(sp, dev)
        for c in range(rates.shape[0]):
            acc = fold(acc, rates[c])
        return acc

    prints = {}
    for key, fn in (("one_dispatch", lambda: run(rates)),
                    ("stream", stream)):
        fn()
        walls = []
        for _ in range(reps):
            wall, acc = timed(fn)
            walls.append(wall)
        row[f"{key}_s"] = statistics.median(walls)
        row[f"{key}_walls"] = walls
        row[f"{key}_peak_bytes"] = peak(fn)
        prints[key] = hashlib.sha256(b"".join(
            a.cpu().numpy().tobytes()
            for a in metrics.finalize(acc, edges))).hexdigest()
    row["fingerprint"] = prints
    print(json.dumps(row), flush=True)


def build_all(trees) -> None:
    """Every tree's kernels at once, each into its own build/."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; _build.extension()")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(t.resolve() / "src")]) for t in trees]
    try:
        if any(p.wait(timeout=1200) != 0 for p in procs):
            raise RuntimeError("a tree's kernels did not build")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def make_rates() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.evals import fleet
    RATES.parent.mkdir(parents=True, exist_ok=True)
    np.save(RATES, fleet.build_rates(fleet_spec(fleet)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trees", nargs="*", type=Path)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child is not None:
        child(args.child, args.reps)
        return 0
    import torch
    if not torch.cuda.is_available() or not args.trees:
        print("time_fleet_trees: needs a CUDA device and at least one tree",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    build_all(args.trees)
    print(f"[time_fleet_trees] built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    make_rates()
    print(f"[time_fleet_trees] rates in {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = []
    try:
        for r in range(args.rounds):
            for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
                res = subprocess.run(
                    [sys.executable, __file__, "--child", str(tree),
                     "--reps", str(args.reps)], capture_output=True,
                    text=True, timeout=900, env=dict(os.environ))
                if res.returncode != 0:
                    print(res.stdout + res.stderr, file=sys.stderr)
                    return 1
                line = res.stdout.strip().splitlines()[-1]
                print(line, flush=True)
                runs.append(json.loads(line))
    finally:
        RATES.unlink(missing_ok=True)
    same = len({json.dumps(run["fingerprint"]) for run in runs}) == 1
    for key in MEASURES:
        times = {str(t): [run[key] for run in runs if run["tree"] == str(t)]
                 for t in args.trees}
        print(f"[summary] {key}: " + ", ".join(
            f"{t} {v}" for t, v in times.items()), flush=True)
    print(f"[summary] same pooled metrics in every run: {same}")
    print(smi)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
