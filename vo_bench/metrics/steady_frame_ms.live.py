"""Host milliseconds of a ``Tracker.track`` call on frames that kept their
keyframe: the median, over the window's frames outside the traced slice."""

import statistics


def read(record):
    ms = [1e3 * (f["end"] - f["start"]) for f in record["frames"] if not f["switched"] and not f["traced"]]
    return statistics.median(ms) if ms else None
