"""The keyframe precompute kernels (``csrc/precompute.cu`` through
``ops/precompute.py``) against their plain version,
``models.tracker.precompute_keyframe_reference``, on the card.  Every test
needs a CUDA device and skips without one; the file imports no JAX:

    python -m pytest --noconftest tests/test_torch_precompute_cuda.py -q

Every comparison is bit-equal (``torch.equal``): the kernels do each float
operation of the plain version in its order and rounding, so the keyframe,
the per-level counts, and the poses and diagnostics of a batched clip are
the plain version's bits.
"""

import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu_torch.dataset import synthetic
from visual_odometry_rs_tpu_torch.models import tracker
from visual_odometry_rs_tpu_torch.ops import precompute as precompute_ops
from visual_odometry_rs_tpu_torch.ops import pyramid
from visual_odometry_rs_tpu_torch.parallel import batch

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

FIELDS = tracker.LANE_FIELDS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _frames(height, width, lanes, holes=0.0, seed=0):
    """(lanes, H, W) int32 depths and u8 images: frames of a few synthetic
    sequences, with a share ``holes`` of depth pixels set to 0."""
    per_seq = 8
    seqs = [synthetic.generate_sequence(nb_frames=min(per_seq, lanes), height=height, width=width,
                                        seed=seed + s, motion_scale=0.03)
            for s in range(-(-lanes // per_seq))]
    depths = np.stack([s.depths[f] for s in seqs for f in range(len(s.depths))][:lanes]).astype(np.int32)
    grays = np.stack([s.grays[f] for s in seqs for f in range(len(s.grays))][:lanes])
    if holes > 0:
        depths[np.random.default_rng(seed).random(depths.shape) < holes] = 0
    return seqs[0].intrinsics, depths, grays


def _inputs(device, height, width, lanes, levels, holes=0.1, lane_axis=True):
    intrinsics, depths, grays = _frames(height, width, lanes, holes)
    depth = torch.from_numpy(depths).to(device)
    img = torch.from_numpy(grays).to(device)
    if not lane_axis:
        depth, img = depth[0], img[0]
    return intrinsics.to(device), depth, pyramid.mean_pyramid(levels, img)


def _assert_keyframes_equal(kf, ref):
    assert len(kf.levels) == len(ref.levels)
    for lvl, (obs, want) in enumerate(zip(kf.levels, ref.levels)):
        for f in FIELDS:
            got, exp = getattr(obs, f), getattr(want, f)
            assert got.dtype == exp.dtype and got.shape == exp.shape, (lvl, f)
            assert torch.equal(got, exp), f"level {lvl} {f}: {(got != exp).sum().item()} entries differ"
        for got, exp in zip(obs.intrinsics, want.intrinsics):
            assert torch.equal(got, exp), lvl


CASES = {
    # name: (height, width, lanes, levels, cap, holes, selector, lane_axis)
    "one_lane_no_axis": (480, 640, 1, 6, 8192, 0.1, "coarse_to_fine", False),
    "lanes_1": (480, 640, 1, 6, 8192, 0.1, "coarse_to_fine", True),
    "lanes_9": (480, 640, 9, 6, 8192, 0.1, "coarse_to_fine", True),
    "lanes_32": (480, 640, 32, 6, 8192, 0.0, "coarse_to_fine", True),
    "odd_61x83_3_levels": (61, 83, 3, 3, 8192, 0.1, "coarse_to_fine", True),
    "cap_below_known": (480, 640, 3, 6, 600, 0.0, "coarse_to_fine", True),
    "zero_depth": (120, 160, 2, 4, 1024, 1.0, "coarse_to_fine", True),
    "dso_fixed": (240, 320, 3, 5, 4096, 0.1, "dso_fixed", True),
    "dso_fixed_odd": (61, 83, 2, 3, 512, 0.1, "dso_fixed", True),
    "levels_7": (480, 640, 2, 7, 8192, 0.1, "coarse_to_fine", True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_reference(cuda_device, case):
    height, width, lanes, levels, cap, holes, selector, lane_axis = CASES[case]
    config = tracker.TrackerConfig(height=height, width=width, nb_levels=levels, candidate_cap=cap,
                                   candidate_selector=selector, dso_target=800)
    intrinsics, depth, pyr = _inputs(cuda_device, height, width, lanes, levels, holes, lane_axis)
    before = precompute_ops.keyframe_levels.launches
    kf, counts = tracker.precompute_keyframe_counts(config, tracker.level_intrinsics(intrinsics, levels), depth, pyr)
    assert precompute_ops.keyframe_levels.launches == before + 2
    ref = tracker.precompute_keyframe_reference(config, intrinsics, depth, pyr)
    torch.cuda.synchronize()
    _assert_keyframes_equal(kf, ref)
    want = torch.stack([obs.valid.sum(dim=-1) for obs in ref.levels], dim=-1).to(torch.int32)
    assert torch.equal(counts, want)
    if case == "cap_below_known":  # the cap truncates level 0
        assert int(want[..., 0].min()) == cap
    if case == "zero_depth":
        assert int(want.sum()) == 0
    _assert_keyframes_equal(tracker.precompute_keyframe(config, intrinsics, depth, pyr), ref)


def test_given_finest_mask(cuda_device):
    config = tracker.TrackerConfig(height=120, width=168, nb_levels=4, candidate_cap=2048)
    intrinsics, depth, pyr = _inputs(cuda_device, 120, 168, 3, 4)
    mask = torch.rand(depth.shape, generator=torch.Generator().manual_seed(1)).to(cuda_device) < 0.2
    kf = tracker.precompute_keyframe(config, intrinsics, depth, pyr, finest_mask=mask)
    _assert_keyframes_equal(kf, tracker.precompute_keyframe_reference(config, intrinsics, depth, pyr, mask))


@pytest.mark.parametrize("selector", ["coarse_to_fine", "dso_fixed"])
def test_into_rows(cuda_device, selector):
    """Lanes precomputed into rows of a batched keyframe are what the
    reference on the picked lanes and ``index_copy`` give; other rows stay.
    Without ``into`` the picked lanes are the result."""
    config = tracker.TrackerConfig(height=240, width=320, nb_levels=5, candidate_cap=4096,
                                   candidate_selector=selector, dso_target=800)
    intrinsics, depth, pyr = _inputs(cuda_device, 240, 320, 9, 5)
    start = tracker.precompute_keyframe_reference(config, intrinsics, depth.flip(0), [p.flip(0) for p in pyr])
    lanes = torch.tensor([3, 0, 7], device=cuda_device)
    kf = tracker.map_keyframe(lambda x: x.clone(), start)
    levels = tracker.level_intrinsics(intrinsics, 5)
    _, counts = tracker.precompute_keyframe_counts(config, levels, depth, pyr, lanes=lanes, into=kf)
    picked, picked_counts = tracker.precompute_keyframe_counts(config, levels, depth, pyr, lanes=lanes)
    new = tracker.precompute_keyframe_reference(
        config, intrinsics, depth.index_select(0, lanes), [p.index_select(0, lanes) for p in pyr])
    want = tracker.map_keyframe(lambda old, fresh: old.index_copy(0, lanes, fresh), start, new)
    torch.cuda.synchronize()
    _assert_keyframes_equal(kf, want)
    _assert_keyframes_equal(picked, new)
    want_counts = torch.stack([obs.valid.sum(dim=-1) for obs in new.levels], dim=-1).to(torch.int32)
    assert torch.equal(counts, want_counts) and torch.equal(picked_counts, want_counts)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _twin_counts(config, levels, depth_map, img_pyramid, finest_mask=None, *, lanes=None, into=None):
    """``precompute_keyframe_counts`` with the plain version forced."""
    if lanes is not None:
        depth_map, img_pyramid = depth_map.index_select(0, lanes), [p.index_select(0, lanes) for p in img_pyramid]
    kf = tracker.precompute_keyframe_reference(config, levels[0][0], depth_map, img_pyramid, finest_mask)
    counts = torch.stack([obs.valid.sum(dim=-1) for obs in kf.levels], dim=-1).to(torch.int32)
    if into is None:
        return kf, counts
    for old, fresh in zip(into.levels, kf.levels):
        for f in FIELDS:
            getattr(old, f).index_copy_(0, lanes, getattr(fresh, f))
    return into, counts


@pytest.mark.parametrize("selector", ["coarse_to_fine", "dso_fixed"])
def test_clip_matches_twin(cuda_device, monkeypatch, selector):
    """An 8-frame clip of 6 lanes with switches: poses, diagnostics and the
    final keyframe equal to the same clip with the plain version forced,
    and the caller's state unchanged."""
    height, width, frames, lanes = 240, 320, 8, 6
    config = tracker.TrackerConfig(height=height, width=width, nb_levels=5, candidate_cap=4096,
                                   flow_threshold=0.4, candidate_selector=selector, dso_target=800)
    seqs = [synthetic.generate_sequence(nb_frames=frames + 1, height=height, width=width, seed=20 + b,
                                        motion_scale=0.01 * (b + 1)) for b in range(lanes)]
    depths = np.stack([np.stack([s.depths[f] for s in seqs]) for f in range(frames + 1)])
    grays = np.stack([np.stack([s.grays[f] for s in seqs]) for f in range(frames + 1)])
    intrinsics = seqs[0].intrinsics

    def run():
        state = batch.batched_init_state(config, intrinsics, depths[0], grays[0], device=cuda_device)
        kept = batch._map_state(lambda x: x.clone(), state)
        final, (poses, diags) = batch.batched_track_sequence(config, intrinsics, state, depths[1:], grays[1:])
        torch.cuda.synchronize()
        for got, exp in zip(_leaves(state), _leaves(kept)):
            assert torch.equal(got, exp)  # the caller's state is never written
        return final, poses, diags

    before = precompute_ops.keyframe_levels.launches
    final, poses, diags = run()
    assert precompute_ops.keyframe_levels.launches > before + 2
    monkeypatch.setattr(tracker, "precompute_keyframe_counts", _twin_counts)
    before = precompute_ops.keyframe_levels.launches
    final_ref, poses_ref, diags_ref = run()
    assert precompute_ops.keyframe_levels.launches == before
    assert int(diags_ref.switched.sum()) > 0
    for got, exp in zip((*poses, *diags), (*poses_ref, *diags_ref)):
        assert torch.equal(got, exp)
    _assert_keyframes_equal(final.kf, final_ref.kf)
    assert torch.equal(final.keyframe_pose.q, final_ref.keyframe_pose.q)


def test_bucketed_tracker(cuda_device):
    """The host ``Tracker`` buckets by the counts the kernel writes: the same
    slices as the reference's valid sums give."""
    seq = synthetic.generate_sequence(nb_frames=2, height=480, width=640, seed=5)
    config = tracker.TrackerConfig(height=480, width=640, bucket_candidates=True)
    trk = tracker.init_tracker(config, seq.intrinsics, 0.0, seq.depths[0], 0.0, seq.grays[0], device=cuda_device)
    pyr = pyramid.mean_pyramid(config.nb_levels, torch.from_numpy(seq.grays[0]).to(cuda_device))
    ref = tracker.precompute_keyframe_reference(
        config, trk.intrinsics, torch.from_numpy(seq.depths[0].astype(np.int32)).to(cuda_device), pyr)
    _assert_keyframes_equal(trk.keyframe_data, trk._maybe_bucket(ref))
