"""``utils/types.py::upload_clip`` on the CPU: a clip's depth maps and
images come back exactly as ``depth_tensor``/``image_tensor`` return them,
contiguous or lane-sliced as ``parallel/mesh.py::shard_batch`` hands a
device its lanes, and nothing is staged.  ``upload_lanes`` on the CPU: a
frame's picked lane rows, widened, land in their rows of the destination
and no other row is written.  Page-locked staging is CUDA's;
``tests/test_torch_kernel_cuda.py`` holds it against these paths on the
card."""

import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu_torch.utils.types import depth_tensor, image_tensor, upload_clip, upload_lanes

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
