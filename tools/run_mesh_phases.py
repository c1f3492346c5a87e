#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 34 (the fleet plane over a device mesh)
without the rest of the script, and time the fleet row over every
visible card against one card.

    python3 tools/run_mesh_phases.py

Builds the kernels, builds AAPAset and trains the classifier on the card
(phases 21-22), runs ``bench_autoscaling``'s SPEC matrix and phase 23's
100,000 x 1440 HPA + AAPA fleet row (one dispatch and streamed) without
a mesh on the first card, then phase 34 against them (the production
mesh over every visible card and a logical mesh of four entries on the
first; each gate raises as inside ``chip_smoke.py``). Then, at 100,000
and 400,000 lanes, the one-dispatch row on the first card alone and over
the production mesh: wall, lane-minutes/s and, by card under
``torch.profiler`` (``chip_smoke.busy_by_card``), the union of its
kernel and copy spans (busy), of its kernels' and of its copies', and
the idle share of the profiled wall. The last line is a JSON object of those
numbers. Run from the repository root; on one card the production mesh
is that card.
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


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.dist import sharding as shd
    from repro_torch.evals import fleet, matrix
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as launch_mesh
    if not torch.cuda.is_available():
        print("run_mesh_phases: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    cs.log(f"cards ({torch.cuda.device_count()}):\n{smi}")
    _build.extension()
    cs.log(f"[phases] build {time.perf_counter() - t_start:.1f} s")
    built, loader, _ = cs.aapaset_phase(dev)
    tcls, _, _ = cs.training_phase(loader, dev)
    spec_ = cs.bench_spec(matrix)
    pool, per_w, _, _ = cs.run_matrix(matrix, spec_, tcls, "SPEC")
    sp = fleet.spec("fleet_1e5", policies=("hpa", "aapa"),
                    scenario="burst_storm", n_workloads=cs.FLEET_LANES,
                    w_chunk=cs.FLEET_CHUNK, minutes=cs.FLEET_MINUTES, seed=0)
    rates = fleet.build_rates(sp)
    one = fleet.run_fleet(sp, classify=tcls, warmup=True, chunks=rates,
                          device=dev)
    streamed = fleet.run_fleet(sp, classify=tcls, stream=True, device=dev)
    t0 = time.perf_counter()
    cs.mesh_phase(tcls, one, streamed, rates, (spec_, pool, per_w), tcls,
                  built)
    cs.log(f"[phases] phase 34 {time.perf_counter() - t0:.1f} s")

    rows = {}
    t0 = time.perf_counter()
    # the 4 x 10^5 fleet's first chunks are the 10^5 fleet's (chunk c is
    # drawn from (seed, c) alone)
    all_rates = fleet.build_rates(dataclasses.replace(
        sp, n_workloads=4 * cs.FLEET_LANES))
    cs.log(f"[scaling] {4 * cs.FLEET_LANES} x {cs.FLEET_MINUTES} rates "
           f"generated in {time.perf_counter() - t0:.1f} s")
    for lanes in (cs.FLEET_LANES, 4 * cs.FLEET_LANES):
        big = dataclasses.replace(sp, name=f"fleet_{lanes}",
                                  n_workloads=lanes)
        rates = all_rates[:big.n_chunks]
        for label, mesh in (("one card", None),
                            ("production mesh",
                             launch_mesh.make_production_mesh())):
            shd.set_mesh(mesh)
            try:
                res = fleet.run_fleet(big, classify=tcls, warmup=True,
                                      chunks=rates, device=dev)
                busy = cs.busy_by_card(lambda: fleet.run_fleet(
                    big, classify=tcls, chunks=rates, device=dev))
            finally:
                shd.set_mesh(None)
            m = res.meta
            key = f"{lanes} {label}"
            rows[key] = dict(wall_s=m["wall_s"],
                             lane_minutes_per_sec=m["lane_minutes_per_sec"],
                             n_devices=m["n_devices"], mesh=m["mesh"],
                             peak_device_bytes=m["peak_device_bytes"],
                             busy_ms=busy,
                             slo_violation_rate=res.pooled
                             .slo_violation_rate.tolist(),
                             rei=res.rei.rei.tolist())
            cs.log(f"[scaling {key}] {m['n_devices']} card(s), mesh "
                   f"{m['mesh']}: wall {m['wall_s']:.4f} s "
                   f"({m['lane_minutes_per_sec']:.6g} lane-minutes/s), "
                   f"peak {m['peak_device_bytes']} bytes, under the "
                   f"profiler by card {busy}")
        a, b = rows[f"{lanes} one card"], rows[f"{lanes} production mesh"]
        if a["slo_violation_rate"] != b["slo_violation_rate"] or \
                a["rei"] != b["rei"]:
            raise RuntimeError(f"{lanes} lanes: the mesh's pooled metrics "
                               "differ from one card's")
    print(json.dumps(dict(card=smi, cards=torch.cuda.device_count(),
                          rows=rows,
                          total_s=time.perf_counter() - t_start)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
