"""``utils/types.py::upload_clip`` on the CPU: a clip's depth maps and
images come back exactly as ``depth_tensor``/``image_tensor`` return them,
contiguous or lane-sliced as ``parallel/mesh.py::shard_batch`` hands a
device its lanes, and nothing is staged.  ``upload_lanes`` on the CPU: a
frame's picked lane rows, widened, land in their rows of the destination
and no other row is written.  ``FrameStager`` into a CPU tensor: frames
arrive whole and in order on a helper thread, the caller's array is not
read once it is closed, the helper's errors reach the caller, and no
thread outlives it.  Page-locked staging is CUDA's;
``tests/test_torch_kernel_cuda.py`` holds it against these paths on the
card."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu_torch.utils import profiling
from visual_odometry_rs_tpu_torch.utils.types import (FrameStager, depth_tensor, image_tensor, upload_clip,
                                                    upload_lanes)

EDGES = [0, 1, 32767, 32768, 65535]  # u16 values that an int16 reading would get wrong


def _clip(frames=2, lanes=4, size=16):
    rng = np.random.default_rng(13)
    depths = rng.integers(0, 1 << 16, (frames, lanes, size, size), dtype=np.uint16)
    depths[..., 0, : len(EDGES)] = EDGES
    imgs = rng.integers(0, 1 << 8, (frames, lanes, size, size), dtype=np.uint8)
    return depths, imgs


LAYOUTS = {
    "contiguous": lambda x: x,
    "lane_slice": lambda x: x[:, 2:4],  # shard_batch's view for the second of two devices
    "reversed": lambda x: x[::-1],  # a negative stride: torch cannot view it
}


CASES = [(layout, kind) for layout in LAYOUTS for kind in ("numpy", "tensor")
         if (layout, kind) != ("reversed", "tensor")]  # torch tensors have no negative strides


@pytest.mark.parametrize("layout,kind", CASES)
def test_upload_clip_on_the_cpu_is_the_frame_converters(layout, kind):
    depths, imgs = (LAYOUTS[layout](x) for x in _clip())
    if kind == "tensor":
        depths, imgs = torch.from_numpy(depths), torch.from_numpy(imgs)
    got_d, got_i, staged = upload_clip(depths, imgs, "cpu")
    assert staged == 0
    assert (got_d.dtype, got_i.dtype, got_d.device.type) == (torch.int32, torch.uint8, "cpu")
    assert torch.equal(got_d, depth_tensor(depths, "cpu")) and torch.equal(got_i, image_tensor(imgs, "cpu"))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(depths).astype(np.int32))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(imgs))
    assert got_d[..., 0, : len(EDGES)].unique().tolist() == EDGES


FRAME_LAYOUTS = {
    "contiguous": lambda clip: clip[1],
    "lane_slice": lambda clip: clip[1, 2:4],  # shard_batch's view: the second of two devices' lanes
    "reversed": lambda clip: clip[1, ::-1],  # lanes in reverse, a negative stride: torch cannot view it
}
FRAME_CASES = [(layout, kind) for layout in FRAME_LAYOUTS for kind in ("numpy", "tensor")
               if (layout, kind) != ("reversed", "tensor")]
PICKS = {"none": lambda b: [], "one": lambda b: [b - 1], "all": lambda b: list(range(b))[::-1]}


@pytest.mark.parametrize("pick", sorted(PICKS))
@pytest.mark.parametrize("layout,kind", FRAME_CASES)
def test_upload_lanes_on_the_cpu_writes_the_picked_rows(layout, kind, pick):
    depth = FRAME_LAYOUTS[layout](_clip()[0])
    if kind == "tensor":
        depth = torch.from_numpy(depth)
    picked = PICKS[pick](depth.shape[0])
    into = torch.full(depth.shape, -1, dtype=torch.int32)
    staged = upload_lanes(depth, torch.tensor(picked, dtype=torch.int64), into)
    assert staged == 0
    want = np.asarray(depth).astype(np.int32)
    for b in range(depth.shape[0]):
        np.testing.assert_array_equal(into[b].numpy(), want[b] if b in picked else -1)
        if b in picked:
            assert into[b, 0, : len(EDGES)].tolist() == EDGES


def test_upload_lanes_refuses_other_dtypes():
    with pytest.raises(TypeError):
        upload_lanes(np.zeros((2, 4, 4), np.int32), torch.tensor([0]), torch.zeros((2, 4, 4), dtype=torch.int32))


STAGER_CASES = [(layout, kind) for layout in ("contiguous", "lane_slice") for kind in ("numpy", "tensor")]


@pytest.mark.parametrize("layout,kind", STAGER_CASES)
def test_frame_stager_copies_frames_whole_and_in_order(layout, kind):
    imgs = LAYOUTS[layout](_clip(frames=4)[1])
    want = imgs.copy()
    src = torch.from_numpy(imgs) if kind == "tensor" else imgs
    dest = torch.full(want.shape, 7, dtype=torch.uint8)
    profiling.clear()
    try:
        with profiling.recording(), FrameStager(src, dest, first_id=20) as stager:
            for t in range(len(want)):
                stager.wait(t)
                np.testing.assert_array_equal(dest[t].numpy(), want[t])
        records = [s for s in profiling.spans() if s.name == "vors.stage"]
    finally:
        profiling.clear()
    assert [(s.id, s.counts) for s in records] == [(20 + t, {"bytes": want[t].nbytes}) for t in range(len(want))]
    assert all(a.end_ns <= b.start_ns for a, b in zip(records, records[1:]))
    assert {s.thread for s in records} != {threading.get_native_id()}
    imgs[...] = 0  # the caller refills its clip once the stager is closed
    np.testing.assert_array_equal(dest.numpy(), want)


def test_frame_stager_raises_the_helpers_error_on_the_callers_thread():
    imgs = _clip(frames=3)[1]
    src = [imgs[0], imgs[1, :, :-1], imgs[2]]  # frame 1 does not fit its destination
    dest = torch.zeros(imgs.shape, dtype=torch.uint8)
    before = threading.active_count()
    with FrameStager(src, dest) as stager:
        stager.wait(0)
        np.testing.assert_array_equal(dest[0].numpy(), imgs[0])
        with pytest.raises(ValueError):
            stager.wait(1)
    assert threading.active_count() == before
    assert not dest[2].any()  # the helper stopped at the frame it failed on


class _SlowFrames:
    """A clip whose frames after the first take 200 ms each to read; it
    records every read."""

    def __init__(self, imgs):
        self.imgs, self.reads = imgs, []

    def __getitem__(self, t):
        self.reads.append(t)
        if t:
            time.sleep(0.2)
        return self.imgs[t]


def test_frame_stager_leaves_no_thread_when_the_loop_raises():
    imgs = _clip(frames=6)[1]
    src, dest = _SlowFrames(imgs), torch.zeros(imgs.shape, dtype=torch.uint8)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="a step failed"):
        with FrameStager(src, dest) as stager:
            stager.wait(0)
            raise RuntimeError("a step failed")
    assert threading.active_count() == before
    assert src.reads in ([0], [0, 1])  # the helper stopped after the frame it was reading
    np.testing.assert_array_equal(dest[: len(src.reads)].numpy(), imgs[: len(src.reads)])
    assert not dest[len(src.reads):].any()


def test_frame_stager_of_one_frame_starts_no_thread(monkeypatch):
    started = []

    class Counted(threading.Thread):
        def start(self):
            started.append(self.name)
            super().start()

    monkeypatch.setattr(threading, "Thread", Counted)
    imgs = _clip(frames=2)[1]
    dest = torch.zeros(imgs.shape, dtype=torch.uint8)
    with FrameStager(imgs[:1], dest[:1]) as stager:
        assert stager.wait(0)  # copied before the stager returned
    assert started == []
    with FrameStager(imgs, dest) as stager:
        stager.wait(1)
    assert len(started) == 1
    np.testing.assert_array_equal(dest.numpy(), imgs)


def test_frame_stager_stress_under_a_short_switch_interval():
    """More stagers than cores at once, each read on a thread of its own, the
    interpreter switching threads every microsecond: every frame is whole
    when its wait returns, and every thread ends."""
    imgs = _clip(frames=32, lanes=2, size=8)[1]
    wrong = []

    def consume(k):
        dest = torch.zeros(imgs.shape, dtype=torch.uint8)
        with FrameStager(imgs, dest, first_id=k) as stager:
            for t in range(len(imgs)):
                stager.wait(t)
                if not np.array_equal(dest[t].numpy(), imgs[t]):
                    wrong.append((k, t))

    threads = [threading.Thread(target=consume, args=(k,)) for k in range((os.cpu_count() or 4) + 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and wrong == []
