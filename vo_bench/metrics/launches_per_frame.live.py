"""Kernel launches the host made a frame (``cudaLaunchKernel*`` calls in the
profiler's trace inside the traced frames' spans)."""

import harness


def read(record):
    tr, spans = record["trace"], record["trace_spans"]
    if tr is None or not spans:
        return None
    return harness.count_in(tr["launches"], spans) / len(spans)
