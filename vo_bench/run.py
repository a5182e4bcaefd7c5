#!/usr/bin/env python3
"""Runs one cell of ``BENCHMARK.json`` once, on the card, and prints its result.

    python3 vo_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up renders the cell's traffic from the seed on the device, builds the
system under test (the port, ``visual_odometry_rs_tpu_torch``) from the
configuration file, and warms it up.  The window then runs for ``--seconds``.
With ``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` a fixed slice at the start of the window runs under
``torch.profiler`` and the result carries the per-layer metrics, each read
by ``metrics/<name>.py``.  After the window the plain reference
(``reference/``) tracks a sample of the window's frames again and decides
``correct`` (``judge.py``).  The last line of standard output is the result
as one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error.

The run fails, printing no result, without a CUDA device (or with fewer
than the cell asks for), or if a module of the JAX stack or of the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from types import SimpleNamespace

_T_IMPORT = time.perf_counter()
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the checkout: the port

import harness  # noqa: E402


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def run_cell(cfg: dict, traffic: dict, limits: dict, per_layer: list, end_to_end: list,
             seed: int, seconds: float, trace: bool, device, started: float, driver_cls=None):
    """One run of a cell: its result line as a dict.  ``started`` is the
    ``time.perf_counter()`` value at which the process started.
    ``driver_cls`` replaces the traffic's driver (the fault tests)."""
    import torch

    import judge
    from reference import tracker as ref

    on_cuda = device.type == "cuda"
    ctx = SimpleNamespace(config=cfg, traffic=traffic, seed=seed, device=device,
                          device_name=torch.cuda.get_device_name(device) if on_cuda else "cpu")
    driver = (driver_cls or harness.load_module("drivers", traffic["driver"]).Driver)(ctx)
    driver.prepare()
    setup_s = time.perf_counter() - started
    record = driver.run(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0

    metrics = {}
    if trace:
        for m in per_layer:
            value = harness.load_module("metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = driver.end_to_end(record)
        values["setup_s"] = setup_s
        for m in end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    attempted, failed = driver.counts(record)
    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_cuda else "cpu", "kind": ctx.device_name, "count": 1,
                         "memory_peak_bytes": peak}}
    if trace and record["trace"] is not None:
        tr, window = record["trace"], record["trace_window"]
        result["device"]["busy_s"] = harness.covered([(s, e) for s, e, _ in tr["device"]], [window])
        result["device"]["window_s"] = window[1] - window[0]
        within = record["trace_spans"] if record["kind"] == "live" else [window]
        result["breakdown"] = harness.breakdown(tr, within)

    samples = driver.samples(int(limits["samples"]), seed, int(limits["start_samples"]))
    seqs = driver.seqs
    driver.free()
    settings = ref.Settings.from_config(cfg)
    readings = judge.reference_readings(settings, cfg["intrinsics"], seqs, samples, device)
    numbers = judge.compare(settings, samples, readings, float(limits["flow_band_px"]))
    # a reading that is not finite (no flow on one side) fails its limit; JSON has no inf
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else 1e300, "limit": float(limits[k])}
              for k in judge.NUMBERS}
    result["correct"] = judge.verdict(numbers, limits) and len(samples) > 0
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    started = time.perf_counter() - process_age()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    manifest = harness.load_manifest()
    cell = harness.find_cell(manifest, args.workload)
    cfg = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    limits = harness.load_json("limits", cell["name"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    result = run_cell(
        cfg, traffic, limits, harness.cell_metrics(manifest, "per_layer", cell["name"]),
        harness.cell_metrics(manifest, "end_to_end", cell["name"]), args.seed, args.seconds,
        bool(args.trace), device, started,
    )
    found = harness.forbidden_modules(sys.modules)  # everything this process loaded, the window's too
    if found:
        print(f"modules of the JAX stack or package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
