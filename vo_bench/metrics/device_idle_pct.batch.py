"""Per cent of the traced clips' stretch in which no operation runs on the
device: the union of the device's intervals in the profiler's trace, over
the stretch from the first traced clip's start to the last one's end."""

import harness


def read(record):
    tr, window = record["trace"], record["trace_window"]
    if tr is None or window is None:
        return None
    busy = harness.covered([(s, e) for s, e, _ in tr["device"]], [window])
    return 100.0 * (1.0 - busy / (window[1] - window[0]))
