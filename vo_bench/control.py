#!/usr/bin/env python3
"""Reads the numbers that ``correct`` compares, for the program and for the
control, on several seeds, to set and check a cell's limits.

    python3 vo_bench/control.py --workload <name> --seeds 1 2 3 --seconds 5

For each seed: the cell's set-up and a window of ``--seconds`` at the
cell's own load, then the sample the run would draw.  The program's
reading compares its frames with the reference in float32; the control's
puts the reference computed in bfloat16 (Jacobians, residuals and
normal-equation sums; ``reference.tracker.evaluate``) in the program's
place, on the same frames from the same states.  Prints one JSON line a
seed and a last line with the largest program reading and the smallest
control reading of each number beside the cell's limit.  The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import harness  # noqa: E402


def readings(cell_name: str, seed: int, seconds: float, device, samples: int = 0):
    """(program numbers, control numbers) of one seed."""
    import torch

    import judge
    from reference import tracker as ref

    cell = harness.find_cell(harness.load_manifest(), cell_name)
    cfg = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    limits = harness.load_json("limits", cell_name)
    ctx = SimpleNamespace(config=cfg, traffic=traffic, seed=seed, device=device,
                          device_name=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    driver = harness.load_module("drivers", traffic["driver"]).Driver(ctx)
    driver.prepare()
    driver.run(seconds, False)
    picked = driver.samples(samples or int(limits["samples"]), seed, int(limits["start_samples"]))
    seqs = driver.seqs
    driver.free()
    settings = ref.Settings.from_config(cfg)
    band = float(limits["flow_band_px"])
    sound = judge.reference_readings(settings, cfg["intrinsics"], seqs, picked, device)
    lower = judge.reference_readings(settings, cfg["intrinsics"], seqs, picked, device, eval_dtype=torch.bfloat16)
    return (judge.compare(settings, picked, sound, band),
            judge.compare(settings, judge.as_samples(picked, lower), sound, band))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)

    import torch

    import judge

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    limits = harness.load_json("limits", args.workload)
    worst, best = {}, {}
    for seed in args.seeds:
        prog, ctrl = readings(args.workload, seed, args.seconds, device)
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl}), flush=True)
        for k in judge.NUMBERS:
            worst[k] = max(worst.get(k, 0.0), prog[k])
            best[k] = min(best.get(k, float("inf")), ctrl[k])
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "numbers": {k: {"program_max": worst[k], "control_min": best[k], "limit": limits[k]}
                                  for k in judge.NUMBERS}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
