"""Tracing and profiling: the program's spans, and ``torch.profiler``.

``span(name, id=None, **counts)`` marks a stretch of the program's host
work at a layer boundary: the tracker's frame (``vors.track``), a clip of
the batched driver (``vors.clip``) and their parts (uploads, solves, the
keyframe precompute, the host's reads of the device).  A span records its
name, start and end, the span that encloses it on its thread, the request
``id`` (the enclosing span's unless given) and integer counts.  Records go
into a bounded buffer in memory (``spans()``, ``clear()``); nothing is
written while the program runs.  Spans record only while a
``torch.profiler`` run is active or inside ``recording()``; otherwise
``span`` returns one shared no-op object after a flag check.  Times are
``time.time_ns()``, the Unix-epoch clock of the profiler's events
(``kineto_results.events()``, ``start_ns()``), so an idle gap on the
device's timeline can be laid against the innermost span the host was in.
A span is not a ``record_function`` range: the profiler copies those onto
the device's timeline, where they would read as device work.

``trace(log_dir)`` writes a block's ``torch.profiler`` trace as a Chrome
trace file that TensorBoard and Perfetto load, with the block's spans as
events on the same timestamps.  The JAX module's ``nan_debug`` has no
counterpart: torch has no switch that raises on the first NaN an operation
makes, and the tracker makes NaNs by design (the flow of padding
candidates, the NaN-energy acceptance).

``profile_device(fn)`` runs ``fn`` under the profiler and sums up what the
tracker's metrics read: how many kernels the host launched, how many
device→host copies it waited for, how long the device was busy, the
device time by kernel name and the spans' self time by name.  ``python -m
visual_odometry_rs_tpu_torch.utils.profiling`` profiles ten tracked frames
of the synthetic 640x480 sequence, one profile per frame, and prints that
summary for each and the kernels and host operators of a steady frame.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import statistics
import threading
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

from torch.autograd import profiler as _autograd_profiler

BUFFER_SPANS = 65536


class Span(NamedTuple):
    """One recorded span; times in ns on ``time.time_ns()``'s clock."""

    name: str
    start_ns: int
    end_ns: int
    serial: int  # this span's number, unique in the process
    parent: Optional[int]  # the enclosing span's ``serial`` on the same thread
    id: Optional[int]  # the request: a frame number, a clip's first frame
    counts: Dict[str, int]
    thread: int  # the native id of the thread that ran it


# a ``Span``'s fields as a plain tuple: the record is made when it is read
_buffer: collections.deque = collections.deque(maxlen=BUFFER_SPANS)
_serials = itertools.count()
_local = threading.local()  # .stack: the open spans of this thread; .thread: its native id
_recording_lock = threading.Lock()
_recording = 0  # open ``recording()`` blocks


class _NoSpan:
    """What ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def count(self, **counts) -> None:
        pass


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "id", "counts", "serial", "parent", "start_ns", "stack", "thread")

    def __init__(self, name: str, id: Optional[int], counts: Dict[str, int]):
        self.name, self.id, self.counts = name, id, counts

    def count(self, **counts) -> None:
        """Set counts before the span closes."""
        self.counts.update(counts)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        outer = stack[-1] if stack else None
        self.parent = outer.serial if outer is not None else None
        if self.id is None and outer is not None:
            self.id = outer.id
        self.serial = next(_serials)
        self.stack, self.thread = stack, _local.thread
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        _buffer.append((self.name, self.start_ns, end, self.serial, self.parent, self.id, self.counts, self.thread))
        return None


def span(name: str, id: Optional[int] = None, **counts: int):
    """A span of the program's host work, as a context manager whose value
    takes ``.count(k=v)``.  Records only under an active ``torch.profiler``
    run or inside ``recording()``."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _NO_SPAN
    return _OpenSpan(name, id, counts)


@contextlib.contextmanager
def recording():
    """Record spans inside the block without running the profiler."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def spans() -> List[Span]:
    """The recorded spans, in the order they closed (the newest
    ``BUFFER_SPANS`` of them)."""
    return [Span._make(r) for r in list(_buffer)]


def clear() -> None:
    """Empty the buffer of recorded spans."""
    _buffer.clear()


def self_ns(records: Iterable[Span]) -> Dict[str, int]:
    """Summed self time by span name: each span's duration less that of its
    children among ``records`` (children on one thread do not overlap)."""
    records = list(records)
    children: Dict[int, int] = {}
    for s in records:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + (s.end_ns - s.start_ns)
    out: Dict[str, int] = {}
    for s in records:
        out[s.name] = out.get(s.name, 0) + (s.end_ns - s.start_ns) - children.get(s.serial, 0)
    return out


def _add_spans(path: str, records: List[Span]) -> None:
    """Append ``records`` to the Chrome trace at ``path`` as complete events
    of the process, on the trace's time base (µs since
    ``baseTimeNanoseconds`` where the trace has one)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "vors_span", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, **s.counts}}
        for s in records)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host operators and, where
    CUDA is present, its kernels and copies) and write it, with the spans
    the block recorded, to ``log_dir/trace_<pid>_<ns>.pt.trace.json`` when
    the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    begin = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in spans() if s.start_ns >= begin])


def _union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of the intervals."""
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


class DeviceProfile(NamedTuple):
    wall_ms: float  # host clock around fn, profiler on, ending in a synchronize
    launches: int  # host calls that launch a kernel (cudaLaunchKernel*)
    device_to_host_copies: int  # each one a host read of the device
    device_busy_ms: float  # the union of the device's intervals (kernels, copies; streams overlap)
    kernel_ms: Dict[str, float]  # device time by kernel name
    kernel_calls: Dict[str, int]
    host_op_calls: Dict[str, int]  # calls of each aten operator on the host
    host_ms: Dict[str, float]  # host time by event name (operators, CUDA and collective calls; nested ones overlap)
    span_ms: Dict[str, float]  # self time of the program's spans by name (``self_ns``)

    @property
    def busy_share(self) -> float:
        return self.device_busy_ms / self.wall_ms if self.wall_ms else 0.0


def profile_device(fn: Callable[[], None]) -> DeviceProfile:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activities).
    The device's busy time is the union of its operations' intervals, so
    work on overlapping streams counts once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    begin = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    # the raw events: ``key_averages`` builds an event tree in Python, which
    # takes minutes for the 10^5 launches of a pose-graph solve
    launches = copies = 0
    device: List[Tuple[int, int]] = []
    kernel_ms: Dict[str, float] = {}
    kernel_calls: Dict[str, int] = {}
    host_op_calls: Dict[str, int] = {}
    host_ms: Dict[str, float] = {}
    for event in prof.profiler.kineto_results.events():
        name = event.name()
        if event.device_type() == DeviceType.CUDA:
            # device-side entries (kernels, copies) carry their own device time
            device.append((event.start_ns(), event.end_ns()))
            kernel_ms[name] = kernel_ms.get(name, 0.0) + event.duration_ns() / 1e6
            kernel_calls[name] = kernel_calls.get(name, 0) + 1
            if name.startswith("Memcpy DtoH"):
                copies += 1
            continue
        host_ms[name] = host_ms.get(name, 0.0) + event.duration_ns() / 1e6
        if name.startswith("cudaLaunchKernel"):
            launches += 1
        elif name.startswith("aten::"):
            host_op_calls[name] = host_op_calls.get(name, 0) + 1
    span_ms = {k: v / 1e6 for k, v in self_ns(s for s in spans() if s.start_ns >= begin).items()}
    return DeviceProfile(
        wall_ms, launches, copies, _union_ns(device) / 1e6, kernel_ms, kernel_calls, host_op_calls, host_ms,
        span_ms,
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
        print("  spans, self ms: " + ", ".join(
            f"{name} {ms:.3f}" for name, ms in sorted(prof.span_ms.items(), key=lambda kv: -kv[1])))
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
    # the program records into the package's module, not into this copy run as ``__main__``
    from visual_odometry_rs_tpu_torch.utils import profiling

    raise SystemExit(profiling.main())
