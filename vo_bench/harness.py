"""What every cell shares: finding its files by name, the statistics, the
reduction of a profiler trace, and the check of the loaded modules.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness reads ``configs/<config>.json`` and ``traffic/<traffic>.json``,
runs the driver ``drivers/<traffic["driver"]>.py``, reads each per-layer
metric with ``metrics/<metric name>.py`` and holds the result to the limits
of ``limits/<cell>.json``.  A new cell, mix, driver or metric is a new file.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BENCH_DIR = Path(__file__).resolve().parent
REPO_DIR = BENCH_DIR.parent
# top-level module names no run may load: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "visual_odometry_rs_tpu")


def load_manifest(path: Optional[Path] = None) -> dict:
    return json.loads((path or REPO_DIR / "BENCHMARK.json").read_text())


def find_cell(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, root: Path = BENCH_DIR) -> dict:
    """``<root>/<kind>/<name>.json``: a configuration, a traffic mix or a cell's limits."""
    return json.loads((root / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str, root: Path = BENCH_DIR):
    """The module of ``<root>/<kind>/<name>.py`` (a driver or a metric's reader)."""
    path = root / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(f"vo_bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(manifest: dict, group: str, cell: str) -> List[dict]:
    """The metrics of ``group`` (``end_to_end`` or ``per_layer``) that ``cell`` reports."""
    return [m for m in manifest[group] if cell in m.get("workloads", [cell])]


def forbidden_modules(modules: Iterable[str]) -> List[str]:
    """The loaded modules whose whole top-level name is forbidden."""
    return sorted({name for name in modules if name.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``% of
    the values at or below it.  A missing value (``inf``) sorts last."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint sorted intervals covering the same points."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Iterable[Tuple[float, float]], within: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``intervals`` inside the union of ``within``."""
    a, b = union(intervals), union(within)
    total, j = 0.0, 0
    for s, e in b:
        while j < len(a) and a[j][1] <= s:
            j += 1
        k = j
        while k < len(a) and a[k][0] < e:
            total += max(0.0, min(e, a[k][1]) - max(s, a[k][0]))
            k += 1
    return total


def gaps(intervals: Iterable[Tuple[float, float]], within: Iterable[Tuple[float, float]]):
    """The stretches of ``within`` that no interval covers."""
    a = union(intervals)
    out = []
    for s, e in union(within):
        cur = s
        for bs, be in a:
            if be <= cur:
                continue
            if bs >= e:
                break
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
        if cur < e:
            out.append((cur, e))
    return out


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

SPAN_PREFIX = "vo_bench."
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")


def reduce_profile(prof) -> dict:
    """The parts of a ``torch.profiler`` run that the metrics read, from its
    raw events, with times in seconds on the profiler's clock:

    - ``device``: (start, end, name) of every operation on the device;
    - ``launches``: start of every host call that launches a kernel;
    - ``spans``: (start, end, name) of the benchmark's own annotations;
    - ``host_ops``: (start, end, name) of the host's ``aten::`` operators.
    """
    from torch.autograd import DeviceType

    device, launches, spans, host_ops = [], [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, end = ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN_PREFIX):  # an annotation's copy on the device's timeline
                device.append((start, end, name))
        elif name.startswith(SPAN_PREFIX):
            spans.append((start, end, name))
        elif name.startswith(LAUNCH_PREFIXES):
            launches.append(start)
        elif name.startswith("aten::"):
            host_ops.append((start, end, name))
    return {"device": device, "launches": sorted(launches), "spans": sorted(spans),
            "host_ops": sorted(host_ops)}


def spans_named(trace: dict, name: str) -> List[Tuple[float, float]]:
    return [(s, e) for s, e, n in trace["spans"] if n == name]


def count_in(points: Sequence[float], within: Iterable[Tuple[float, float]]) -> int:
    """How many points lie inside the intervals."""
    return sum(bisect.bisect_left(points, e) - bisect.bisect_left(points, s) for s, e in union(within))


def device_seconds(trace: dict, contains: str) -> Tuple[float, int]:
    """Summed device seconds and count of the operations whose name contains ``contains``."""
    hits = [e - s for s, e, n in trace["device"] if contains in n]
    return sum(hits), len(hits)


def breakdown(trace: dict, within: List[Tuple[float, float]], top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps by what
    the host was doing: each gap inside ``within`` goes to the innermost
    host operator running at its middle, else to ``host: python``."""
    ops: Dict[str, float] = {}
    for s, e, n in trace["device"]:
        ops[n[:120]] = ops.get(n[:120], 0.0) + (e - s)
    host = trace["host_ops"]
    idle: Dict[str, float] = {}
    starts = [s for s, _, _ in host]
    for gs, ge in gaps([(s, e) for s, e, _ in trace["device"]], within):
        mid = 0.5 * (gs + ge)
        best = None
        i = bisect.bisect_right(starts, mid) - 1
        # scan back over operators that started before the middle; nested
        # ones start later, so the first that covers it is the innermost
        for j in range(i, max(-1, i - 64), -1):
            s, e, n = host[j]
            if e >= mid:
                best = n
                break
        key = best or "host: python"
        idle[key] = idle.get(key, 0.0) + (ge - gs)

    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(ops), "idle_gaps": top_of(idle)}
