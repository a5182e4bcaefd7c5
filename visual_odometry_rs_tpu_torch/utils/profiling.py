"""Tracing and profiling with ``torch.profiler``.

``trace(log_dir)`` and ``annotate(name)`` are the JAX package's hooks
(``visual_odometry_rs_tpu/utils/profiling.py``): a trace of a block of work
written as a Chrome trace file that TensorBoard and Perfetto load, and a
named region in it (and, on CUDA, an NVTX range).  The JAX module's
``nan_debug`` has no counterpart: torch has no switch that raises on the
first NaN an operation makes, and the tracker makes NaNs by design (the
flow of padding candidates, the NaN-energy acceptance).

``profile_device(fn)`` runs ``fn`` under the profiler and sums up what the
tracker's metrics read: how many kernels the host launched, how many
device→host copies it waited for, how long the device was busy, and the
device time by kernel name.  ``python -m
visual_odometry_rs_tpu_torch.utils.profiling`` profiles ten tracked frames
of the synthetic 640x480 sequence, one profile per frame, and prints that
summary for each and the kernels and host operators of a steady frame.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict, NamedTuple


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host operators and, where
    CUDA is present, its kernels and copies) and write it to
    ``log_dir/trace_<pid>_<ns>.pt.trace.json`` when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region of the trace (``record_function``); on CUDA also an
    NVTX range, which an external CUDA profiler shows."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class DeviceProfile(NamedTuple):
    wall_ms: float  # host clock around fn, profiler on, ending in a synchronize
    launches: int  # host calls that launch a kernel (cudaLaunchKernel*)
    device_to_host_copies: int  # each one a host read of the device
    device_busy_ms: float  # summed device time of kernels and copies
    kernel_ms: Dict[str, float]  # device time by kernel name
    kernel_calls: Dict[str, int]
    host_op_calls: Dict[str, int]  # calls of each aten operator on the host
    host_ms: Dict[str, float]  # host time by event name (operators, CUDA and collective calls; nested ones overlap)

    @property
    def busy_share(self) -> float:
        return self.device_busy_ms / self.wall_ms if self.wall_ms else 0.0


def profile_device(fn: Callable[[], None]) -> DeviceProfile:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activities)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    # the raw events: ``key_averages`` builds an event tree in Python, which
    # takes minutes for the 10^5 launches of a pose-graph solve
    launches = copies = 0
    busy_us = 0.0
    kernel_ms: Dict[str, float] = {}
    kernel_calls: Dict[str, int] = {}
    host_op_calls: Dict[str, int] = {}
    host_ms: Dict[str, float] = {}
    for event in prof.profiler.kineto_results.events():
        name = event.name()
        if event.device_type() == DeviceType.CUDA:
            # device-side entries (kernels, copies) carry their own device time
            device_us = event.duration_ns() / 1e3
            busy_us += device_us
            kernel_ms[name] = kernel_ms.get(name, 0.0) + device_us / 1e3
            kernel_calls[name] = kernel_calls.get(name, 0) + 1
            if name.startswith("Memcpy DtoH"):
                copies += 1
            continue
        host_ms[name] = host_ms.get(name, 0.0) + event.duration_ns() / 1e6
        if name.startswith("cudaLaunchKernel"):
            launches += 1
        elif name.startswith("aten::"):
            host_op_calls[name] = host_op_calls.get(name, 0) + 1
    return DeviceProfile(
        wall_ms, launches, copies, busy_us / 1e3, kernel_ms, kernel_calls, host_op_calls, host_ms
    )


def main() -> int:
    import torch

    from ..dataset import synthetic
    from ..models import tracker as tracker_mod

    frames, warm, height, width = 10, 6, 480, 640
    seq = synthetic.generate_sequence(
        nb_frames=warm + frames, height=height, width=width, seed=0,
        twist_per_frame=[0.01, 0.004, 0.0, 0.0, 0.002, 0.001],
    )
    config = tracker_mod.TrackerConfig(height=height, width=width, bucket_candidates=True)
    ts = seq.timestamps
    trk = tracker_mod.init_tracker(
        config, seq.intrinsics, float(ts[0]), seq.depths[0], float(ts[0]), seq.grays[0]
    )

    def track(first, last):
        for f in range(first, last):
            trk.track(float(ts[f]), seq.depths[f], float(ts[f]), seq.grays[f])

    track(1, warm)
    print(f"device: {torch.cuda.get_device_name(0)}")
    # one profile per frame, so that frames with and without a keyframe
    # switch can be told apart
    steady = []
    for f in range(warm, warm + frames):
        switches = trk.keyframe_switches
        prof = profile_device(lambda: track(f, f + 1))
        switched = trk.keyframe_switches > switches
        print(f"frame {f}: {'switch' if switched else 'steady'} {prof.wall_ms:.3f} ms (profiler on), "
              f"{prof.launches} kernel launches, {prof.device_to_host_copies} device→host copies, "
              f"device busy {prof.device_busy_ms:.3f} ms = {100 * prof.busy_share:.2f}%, "
              f"LM iterations {sum(trk.last_nb_iters)}, evaluations {sum(trk.last_nb_evals)}")
        if not switched:
            steady.append(prof)
    last = steady[-1]
    print(f"steady frames: {len(steady)}; median {statistics.median(p.wall_ms for p in steady):.3f} ms, "
          f"launches {statistics.median(p.launches for p in steady)}, device busy "
          f"{100 * statistics.median(p.busy_share for p in steady):.2f}%")
    print("device time by kernel, last steady frame:")
    for name, ms in sorted(last.kernel_ms.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {1e3 * ms:9.1f} us {last.kernel_calls[name]:5d} calls  {name[:90]}")
    print("host operators by calls, last steady frame:")
    for name, calls in sorted(last.host_op_calls.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {calls:5d}  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
