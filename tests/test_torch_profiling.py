"""The program's spans (``utils/profiling.py``): when they record, what a
record holds, the clock they share with the profiler, and the span tree of
a ``Tracker.track`` call and of a ``batched_track_sequence`` clip (60x80,
on the CPU)."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.parallel import batch as tbatch
from visual_odometry_rs_tpu_torch.utils import profiling

H, W = 60, 80
KW = dict(height=H, width=W, nb_levels=3, candidate_cap=512, bucket_candidates=True)
NEVER, ALWAYS = 1e9, 0.0  # flow thresholds: no keyframe switch, a switch every frame


@pytest.fixture
def clean():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def seq():
    return tsyn.generate_sequence(nb_frames=4, height=H, width=W, seed=3,
                                  twist_per_frame=[0.02, 0.0, 0.0, 0.0, 0.0, 0.0])


def _children(records):
    """serial → the records of its children, in the order they closed."""
    out = {}
    for s in records:
        out.setdefault(s.parent, []).append(s)
    return out


def test_off_records_nothing_and_returns_the_shared_no_op(clean):
    first = profiling.span("vors.track", id=3, switched=0)
    assert first is profiling.span("vors.solve")
    with first as s:
        s.count(switched=1)
    assert profiling.spans() == []


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("on", [_profiled, profiling.recording], ids=["profiler", "recording"])
def test_spans_record_parent_id_and_counts_per_thread(clean, on):
    def worker():
        with profiling.span("vors.clip", id=9, lanes=2):
            with profiling.span("vors.step"):
                pass

    with on():
        with profiling.span("vors.track", id=7, switched=0) as root:
            with profiling.span("vors.upload", bytes=12):
                thread = threading.Thread(target=worker)
                thread.start()
                thread.join(timeout=30)
            with profiling.span("vors.solve", id=8):
                pass
            root.count(switched=1)
    assert not thread.is_alive()
    by_name = {s.name: s for s in profiling.spans()}
    assert set(by_name) == {"vors.track", "vors.upload", "vors.solve", "vors.clip", "vors.step"}
    track, upload, solve = by_name["vors.track"], by_name["vors.upload"], by_name["vors.solve"]
    assert (track.parent, track.id, track.counts) == (None, 7, {"switched": 1})
    assert (upload.parent, upload.id, upload.counts) == (track.serial, 7, {"bytes": 12})
    assert (solve.parent, solve.id) == (track.serial, 8)
    assert track.start_ns <= upload.start_ns <= upload.end_ns <= solve.start_ns <= solve.end_ns <= track.end_ns
    # the other thread's spans nest on its own stack, not under the open upload
    clip, step = by_name["vors.clip"], by_name["vors.step"]
    assert (clip.parent, clip.id, clip.counts) == (None, 9, {"lanes": 2})
    assert (step.parent, step.id) == (clip.serial, 9)
    assert clip.thread != track.thread == threading.get_native_id()
    assert profiling.span("vors.track") is profiling.span("vors.solve")  # off again


def test_the_buffer_keeps_the_newest_spans(clean):
    with profiling.recording():
        for i in range(profiling.BUFFER_SPANS + 5):
            with profiling.span("vors.step", id=i):
                pass
    kept = profiling.spans()
    assert len(kept) == profiling.BUFFER_SPANS and kept[-1].id == profiling.BUFFER_SPANS + 4


def test_spans_share_the_profilers_clock(clean, tmp_path):
    x = torch.randn(128, 128)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("vors.solve", lanes=2):
            torch.mm(x, x)
    (sp,) = profiling.spans()
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    slack = 50_000
    assert sp.start_ns - slack <= mm.start_ns() <= mm.end_ns() <= sp.end_ns + slack
    # the exported trace holds the span on the operators' time base (µs)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (ev,) = [e for e in events if e.get("cat") == "vors_span"]
    (op,) = [e for e in events if e.get("name") == "aten::mm"]
    assert ev["name"] == "vors.solve" and ev["args"] == {"id": None, "lanes": 2}
    assert ev["ts"] - 50 <= op["ts"] <= op["ts"] + op["dur"] <= ev["ts"] + ev["dur"] + 50


@pytest.mark.parametrize("threshold", [NEVER, ALWAYS], ids=["steady", "switch"])
def test_track_span_tree(clean, seq, threshold):
    config = ttracker.TrackerConfig(**KW, flow_threshold=threshold)
    trk = ttracker.init_tracker(config, seq.intrinsics, 0.0, seq.depths[0], 0.0, seq.grays[0], device="cpu")
    trk.track(1.0, seq.depths[1], 1.0, seq.grays[1])  # not recorded
    assert profiling.spans() == []
    with profiling.recording():
        trk.track(2.0, seq.depths[2], 2.0, seq.grays[2])
    records = profiling.spans()
    kids = _children(records)
    (root,) = kids[None]
    switched = int(threshold == ALWAYS)
    assert (root.name, root.id, root.counts) == ("vors.track", 2, {"switched": switched})
    names = [s.name for s in kids[root.serial]]
    assert names == ["vors.upload", "vors.solve", "vors.read.track"] + ["vors.precompute"] * switched
    upload, _, read = kids[root.serial][:3]
    assert upload.counts == {"bytes": seq.grays[2].nbytes}
    assert read.counts == {"bytes": 4 * (2 + 2 * config.nb_levels + 7)}
    assert all(s.id == 2 for s in records)
    if switched:
        pre = kids[root.serial][3]
        assert pre.counts == {"lanes": 1}
        assert [(s.name, s.counts) for s in kids[pre.serial]] == [
            ("vors.upload", {"bytes": seq.depths[2].nbytes}), ("vors.read.bucket", {})]
    assert len(records) == 4 + 3 * switched


def test_clip_span_tree(clean, seq):
    config = ttracker.TrackerConfig(**KW, flow_threshold=NEVER)
    depths = np.stack([np.stack([seq.depths[f], seq.depths[f]]) for f in (1, 2, 3)])  # (F, B, H, W)
    grays = np.stack([np.stack([seq.grays[f], seq.grays[f]]) for f in (1, 2, 3)])
    state = tbatch.batched_init_state(config, seq.intrinsics, depths[0], grays[0], device="cpu")
    with profiling.recording():
        # lane 0 pends from an earlier clip, so it alone switches on the first frame
        _, (poses, diags) = tbatch.batched_track_sequence(
            config, seq.intrinsics, state, depths, grays, pending0=torch.tensor([True, False]), frame_offset=5)
        host = tbatch.outputs_to_numpy(poses, diags)[2]
    assert host.switched.sum(axis=1).tolist() == [1, 0, 0]
    kids = _children(profiling.spans())
    clip, outputs = kids[None]
    assert (clip.name, clip.id, clip.counts) == ("vors.clip", 5, {"lanes": 2, "frames": 3})
    row = 7 + 4 + config.nb_levels  # q, t, four flags, the iterations of each level
    assert (outputs.name, outputs.id, outputs.counts) == ("vors.read.outputs", None, {"bytes": 3 * 2 * row * 4})
    assert [(s.name, s.id) for s in kids[clip.serial]] == [
        ("vors.upload", 5), ("vors.step", 5), ("vors.step", 6), ("vors.step", 7)]
    assert kids[clip.serial][0].counts == {"bytes": depths.nbytes + grays.nbytes}
    for t, step in enumerate(kids[clip.serial][1:]):
        steps = [(s.name, s.id, s.counts) for s in kids[step.serial]]
        assert steps == [("vors.solve", 5 + t, {}), ("vors.read.switch_mask", 5 + t, {})] + (
            [("vors.precompute", 5, {"lanes": 1})] if t == 0 else [])


def test_busy_time_counts_overlapping_intervals_once():
    # two streams overlapping 5-10, a third interval inside the second, a gap, one more
    assert profiling._union_ns([(0, 10), (5, 20), (6, 7), (30, 40)]) == 30
    assert profiling._union_ns([]) == 0
