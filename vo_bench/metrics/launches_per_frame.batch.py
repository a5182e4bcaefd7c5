"""Kernel launches the host made a lane-frame (``cudaLaunchKernel*`` calls in
the profiler's trace inside the traced clips, over their lane-frames)."""

import harness


def read(record):
    tr, spans = record["trace"], record["trace_spans"]
    if tr is None or not spans or not record["traced_lane_frames"]:
        return None
    return harness.count_in(tr["launches"], spans) / record["traced_lane_frames"]
