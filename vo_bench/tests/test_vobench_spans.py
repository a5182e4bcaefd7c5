"""The metrics that read the program's spans, on a made-up record and
span buffer (``spans.py``), on the CPU."""

import pytest

import harness
from visual_odometry_rs_tpu_torch.utils import profiling

T0 = 1_790_000_000  # a Unix time, in s: the profiler's clock
LIVE = ("solve_ms.live", "read_wait_ms.live", "precompute_ms.live")
BATCH = ("upload_ms.batch", "precompute_ms.batch", "read_wait_ms.batch")


def _ns(ms):
    return T0 * 1_000_000_000 + round(ms * 1e6)


def _spans(rows):
    """(name, start ms, end ms, parent row or None, counts) → records."""
    return [profiling.Span(name, _ns(s), _ns(e), i, parent, 0, counts, 1)
            for i, (name, s, e, parent, counts) in enumerate(rows)]


def _record(kind, windows_ms):
    spans = [(T0 + 1e-3 * s, T0 + 1e-3 * e) for s, e in windows_ms]
    return {"kind": kind, "trace": {"device": [], "launches": [], "spans": [], "host_ops": []},
            "trace_spans": spans, "trace_window": (spans[0][0], spans[-1][1])}


# three traced frames (0-10, 40-50 and 80-110 ms), the last one a switch,
# and a frame outside the traced slice
LIVE_SPANS = _spans([
    ("vors.track", 1, 9, None, {"switched": 0}), ("vors.solve", 2, 5, 0, {}), ("vors.read.track", 6, 6.5, 0, {}),
    ("vors.track", 41, 49, None, {"switched": 0}), ("vors.solve", 41, 45, 3, {}), ("vors.read.track", 46, 47, 3, {}),
    ("vors.track", 81, 109, None, {"switched": 1}), ("vors.solve", 82, 85, 6, {}),
    ("vors.read.track", 86, 86.2, 6, {}), ("vors.precompute", 87, 107, 6, {"lanes": 1}),
    ("vors.read.bucket", 100, 101, 9, {}),
    ("vors.track", 201, 209, None, {"switched": 0}), ("vors.solve", 202, 208, 11, {}),
])
# two traced clips (0-100 and 100.5-200 ms) and the outputs' read of each
BATCH_SPANS = _spans([
    ("vors.clip", 1, 95, None, {}), ("vors.upload", 1, 31, 0, {}), ("vors.step", 31, 60, 0, {}),
    ("vors.read.switch_mask", 40, 41, 2, {}), ("vors.precompute", 41, 51, 2, {"lanes": 3}),
    ("vors.step", 60, 95, 0, {}), ("vors.read.switch_mask", 70, 72, 5, {}),
    ("vors.precompute", 72, 80, 5, {"lanes": 2}), ("vors.read.outputs", 95, 99, None, {}),
    ("vors.clip", 101, 190, None, {}), ("vors.upload", 101, 141, 9, {}), ("vors.step", 141, 190, 9, {}),
    ("vors.read.switch_mask", 150, 151, 11, {}), ("vors.read.outputs", 190, 196, None, {}),
])


def _read(name, record):
    return harness.load_module("metrics", name).read(record)


@pytest.mark.parametrize("name, expected", [
    ("solve_ms.live", 3.5),  # steady frames' solves: 3 and 4 ms
    ("read_wait_ms.live", 0.75),  # steady frames' reads: 0.5 and 1 ms
    ("precompute_ms.live", 20.0),
    ("upload_ms.batch", 35.0),  # 30 and 40 ms
    ("precompute_ms.batch", 9.0),  # 10 + 8 and none
    ("read_wait_ms.batch", 7.0),  # 1 + 2 + 4 and 1 + 6 ms
])
def test_span_metrics_on_made_up_spans(monkeypatch, name, expected):
    live = name in LIVE
    monkeypatch.setattr(profiling, "spans", lambda: LIVE_SPANS if live else BATCH_SPANS)
    if live:
        record = _record("live", [(0, 10), (40, 50), (80, 110)])
    else:
        record = _record("offline_batch", [(0, 100), (100.5, 200)])
    assert _read(name, record) == pytest.approx(expected, abs=1e-6)


@pytest.mark.parametrize("name", LIVE + BATCH)
def test_span_metrics_read_nothing_without_spans(monkeypatch, name):
    record = _record("live", [(0, 10)])
    monkeypatch.setattr(profiling, "spans", lambda: LIVE_SPANS + BATCH_SPANS)
    assert _read(name, dict(record, trace=None, trace_spans=[], trace_window=None)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])  # a trace, but the program recorded nothing
    assert _read(name, record) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    assert _read(name, record) is None
