#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 27-29 (the model substrate at smoke size,
the AAPA-scaled serving endpoint at full width, the same script on the
CPU) on one H100 without the rest of the script.

    python3 tools/run_serving_phases.py

Builds the kernels, then runs the phases with their gates as
``chip_smoke.py`` does, each timed on the host clock; the last line is a
JSON object of the serving phase's numbers. Run from the repository
root.
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
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("run_serving_phases: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print("card", torch.cuda.get_device_name(0), flush=True)
    t0 = time.perf_counter()
    _build.extension()
    print(f"[phases] build {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cs.model_phase(dev)
    serving = cs.serving_phase(dev)
    print(f"[phases] 27-29 {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(serving))
    return 0


if __name__ == "__main__":
    sys.exit(main())
