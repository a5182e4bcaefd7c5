"""The table of peaks and the least time of the solver kernel ``lm_solve_level``.

A launch solves one pyramid level of every lane it is given.  What it
needs, counted once each: the candidates (x, y, inverse depth and template
value in f32, a valid byte, a 6-float Jacobian row: 41 B), the level's u8
image and the 128-float record, a lane; and per evaluation the warp and
domain test of every candidate (47 f32 operations, counted in
``csrc/residual_eval.cuh``).  The sampling and sums of the candidates that
land inside (71 more) depend on the pose and are left out, so the least
time is a lower bound and the share never overstates.  The least time is
the larger of bytes over the card's bandwidth and operations over its f32
rate outside the tensor cores.
"""

from __future__ import annotations

from typing import Iterable, Optional

import harness

# NVIDIA's data sheet of the H100 SXM (dense, 700 W): HBM3 bytes a second and
# f32 operations a second outside the tensor cores
PEAKS = {"H100": {"bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}}
CANDIDATE_BYTES = 4 * 4 + 1 + 6 * 4
RECORD_BYTES = 128 * 4
FLOPS_WARP = 47


def peaks(device_name: str) -> Optional[dict]:
    for key, peak in PEAKS.items():
        if key in device_name:
            return peak
    return None


def launch_bytes(n: int, height: int, width: int, lanes: int) -> int:
    return lanes * (n * CANDIDATE_BYTES + height * width + RECORD_BYTES)


def launch_flops(n: int, evaluations: int) -> int:
    """``evaluations`` summed over the launch's lanes."""
    return evaluations * n * FLOPS_WARP


def least_seconds(launches: Iterable[dict], peak: dict) -> float:
    """Summed least time of launches given as dicts of ``n`` (candidate slots
    a lane), ``height``, ``width``, ``lanes`` and ``evaluations`` (all lanes)."""
    total = 0.0
    for ln in launches:
        by_bytes = launch_bytes(ln["n"], ln["height"], ln["width"], ln["lanes"]) / peak["bytes_per_s"]
        by_ops = launch_flops(ln["n"], ln["evaluations"]) / peak["f32_flops_per_s"]
        total += max(by_bytes, by_ops)
    return total


def share_pct(record: dict, kernel: str) -> Optional[float]:
    """Per cent of the roofline the launches of ``kernel`` reached in a traced
    slice: least time over device time, a launch on average (the tracer now
    and then drops a kernel's record).  None without a trace, a launch or a
    known card."""
    tr, launches = record["trace"], record["solver_launches"]
    peak = peaks(record["device_name"])
    if tr is None or not launches or peak is None:
        return None
    device_s, count = harness.device_seconds(tr, kernel)
    if count == 0 or device_s <= 0.0:
        return None
    return 100.0 * (least_seconds(launches, peak) / len(launches)) / (device_s / count)
