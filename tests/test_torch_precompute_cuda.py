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
from visual_odometry_rs_tpu_torch.utils import profiling

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
    kf, counts = tracker.precompute_keyframe_counts(config, intrinsics, depth, pyr)
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
    reference on the picked lanes and ``index_copy`` give; other rows stay."""
    config = tracker.TrackerConfig(height=240, width=320, nb_levels=5, candidate_cap=4096,
                                   candidate_selector=selector, dso_target=800)
    intrinsics, depth, pyr = _inputs(cuda_device, 240, 320, 9, 5)
    start = tracker.precompute_keyframe_reference(config, intrinsics, depth.flip(0), [p.flip(0) for p in pyr])
    lanes = torch.tensor([3, 0, 7], device=cuda_device)
    kf = tracker.map_keyframe(lambda x: x.clone(), start)
    tracker.precompute_keyframe_into(config, intrinsics, depth, pyr, lanes, kf)
    new = tracker.precompute_keyframe_reference(
        config, intrinsics, depth.index_select(0, lanes), [p.index_select(0, lanes) for p in pyr])
    want = tracker.map_keyframe(lambda old, fresh: old.index_copy(0, lanes, fresh), start, new)
    torch.cuda.synchronize()
    _assert_keyframes_equal(kf, want)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _twin_into(config, intrinsics, depth_map, img_pyramid, lanes, kf, levels=None):
    new = tracker.precompute_keyframe_reference(
        config, intrinsics, depth_map.index_select(0, lanes), [p.index_select(0, lanes) for p in img_pyramid])
    for old, fresh in zip(kf.levels, new.levels):
        for f in FIELDS:
            getattr(old, f).index_copy_(0, lanes, getattr(fresh, f))


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
    monkeypatch.setattr(tracker, "precompute_keyframe", tracker.precompute_keyframe_reference)
    monkeypatch.setattr(tracker, "precompute_keyframe_into", _twin_into)
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


def test_spans_count_kernel_lanes(cuda_device, monkeypatch):
    """``kernel_lanes`` of each ``vors.precompute`` span is what the launcher
    counted across the span: its ``lanes`` through the kernels, 0 with the
    plain version forced."""
    height, width, lanes = 120, 160, 4
    config = tracker.TrackerConfig(height=height, width=width, nb_levels=4, candidate_cap=1024, flow_threshold=0.2)
    seqs = [synthetic.generate_sequence(nb_frames=6, height=height, width=width, seed=40 + b,
                                        motion_scale=0.02 * (b + 1)) for b in range(lanes)]
    depths = np.stack([np.stack([s.depths[f] for s in seqs]) for f in range(6)])
    grays = np.stack([np.stack([s.grays[f] for s in seqs]) for f in range(6)])

    def spans():
        profiling.clear()
        with profiling.recording():
            state = batch.batched_init_state(config, seqs[0].intrinsics, depths[0], grays[0], device=cuda_device)
            batch.batched_track_sequence(config, seqs[0].intrinsics, state, depths[1:], grays[1:])
            trk = tracker.init_tracker(config, seqs[0].intrinsics, 0.0, seqs[0].depths[0], 0.0, seqs[0].grays[0],
                                       device=cuda_device)
            for f in range(1, 6):
                trk.track(float(f), seqs[0].depths[f], float(f), seqs[0].grays[f])
        return [s.counts for s in profiling.spans() if s.name == "vors.precompute"]

    counts = spans()
    assert len(counts) >= 2 and all(c["kernel_lanes"] == c["lanes"] > 0 for c in counts)
    monkeypatch.setattr(tracker, "precompute_keyframe_counts", lambda config, intrinsics, depth, pyr, **kw: (
        tracker.precompute_keyframe_reference(config, intrinsics, depth, pyr, kw.get("finest_mask")), None))
    monkeypatch.setattr(tracker, "precompute_keyframe_into", _twin_into)
    counts = spans()
    assert len(counts) >= 2 and all(c["kernel_lanes"] == 0 and c["lanes"] > 0 for c in counts)
