#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 24-26 (decision telemetry and an obs
card in worker processes side by side, then tuning) on one H100 without
the rest of the script.

    python3 tools/run_telemetry_phases.py

Builds the kernels, builds AAPAset and trains the classifier on the card
(phases 21-22, which phases 24-25 classify with), runs phase 23's
untraced one-dispatch fleet (what phase 24's fleet capture is held
against), then phases 24-25 and 26, each timed on the host clock; the
last line is a JSON object of those walls. Each phase raises on a failed
gate as it does inside ``chip_smoke.py``. Run from the repository root.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.evals import fleet
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("run_telemetry_phases: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    print("card", torch.cuda.get_device_name(0), flush=True)
    _build.extension()
    print(f"[phases] build {time.perf_counter() - t0:.1f} s", flush=True)
    _, loader, _ = cs.aapaset_phase(dev)
    tcls, info, _ = cs.training_phase(loader, dev)
    sp = fleet.spec("fleet_1e5", policies=("hpa", "aapa"),
                    scenario="burst_storm", n_workloads=cs.FLEET_LANES,
                    w_chunk=cs.FLEET_CHUNK, minutes=cs.FLEET_MINUTES, seed=0)
    one = fleet.run_fleet(sp, classify=tcls, warmup=True)
    print(f"[phases] one-dispatch {one.meta['wall_s']:.4f} s", flush=True)
    walls = {}
    for phase, run in (("24-25", lambda: cs.telemetry_phases(
            tcls, one, info["dataset_id"])), ("26", cs.tuning_phase)):
        t = time.perf_counter()
        run()
        walls[phase] = time.perf_counter() - t
        print(f"[phases] phase {phase} {walls[phase]:.1f} s", flush=True)
    print(json.dumps(dict(walls=walls, total=time.perf_counter() - t0)))
    return 0


# phase 24 spawns worker processes, which import this module again
if __name__ == "__main__":
    sys.exit(main())
