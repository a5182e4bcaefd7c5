"""Per cent of the time a frame is in flight (inside ``Tracker.track``) in
which no operation runs on the device: the union of the device's intervals
in the profiler's trace, over the traced frames' spans.  Between frames the
camera sets the pace, so that time is left out."""

import harness


def read(record):
    tr, spans = record["trace"], record["trace_spans"]
    if tr is None or not spans:
        return None
    total = sum(e - s for s, e in harness.union(spans))
    busy = harness.covered([(s, e) for s, e, _ in tr["device"]], spans)
    return 100.0 * (1.0 - busy / total)
