"""The keyframe precompute's one dispatch on the CPU:
``precompute_keyframe_counts`` (and ``precompute_keyframe`` through it)
runs the plain version there, ``precompute_keyframe_reference``, bit for
bit, and gives each level's valid count; with ``lanes`` and ``into`` it
writes the picked lanes' rows and leaves the others; the kernels' launcher
refuses CPU tensors.  The kernels themselves are held to the plain version
on the card (``tests/test_torch_precompute_cuda.py``).  Small shapes, one
thread.
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

H, W, LEVELS, LANES = 45, 62, 3, 3


@pytest.fixture(scope="module")
def scene():
    seqs = [synthetic.generate_sequence(nb_frames=3, height=H, width=W, seed=s, motion_scale=0.03)
            for s in range(LANES)]
    depths = np.stack([np.stack([s.depths[f] for s in seqs]) for f in range(3)]).astype(np.int32)
    depths[0, 1, 10:20, 5:30] = 0  # a hole in lane 1's first depth map
    grays = np.stack([np.stack([s.grays[f] for s in seqs]) for f in range(3)])
    return seqs[0].intrinsics, depths, grays


def _equal(a, b):
    return all(torch.equal(getattr(x, f), getattr(y, f)) for x, y in zip(a.levels, b.levels)
               for f in tracker.LANE_FIELDS)


@pytest.mark.parametrize("selector", ["coarse_to_fine", "dso_fixed"])
def test_cpu_runs_the_reference(scene, selector):
    intrinsics, depths, grays = scene
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=300,
                                   candidate_selector=selector, dso_target=300)
    depth, pyr = torch.from_numpy(depths[0]), pyramid.mean_pyramid(LEVELS, torch.from_numpy(grays[0]))
    ref = tracker.precompute_keyframe_reference(config, intrinsics, depth, pyr)
    assert _equal(tracker.precompute_keyframe(config, intrinsics, depth, pyr), ref)
    kf, counts = tracker.precompute_keyframe_counts(config, tracker.level_intrinsics(intrinsics, LEVELS), depth, pyr)
    assert _equal(kf, ref)
    assert counts.dtype == torch.int32 and counts.shape == (LANES, LEVELS)
    assert counts.tolist() == [[int(obs.valid[b].sum()) for obs in ref.levels] for b in range(LANES)]
    if selector == "coarse_to_fine":
        assert counts[0, 0] == 300  # the cap truncates level 0
    # one lane without a lane axis is the same lane
    one = tracker.precompute_keyframe(config, intrinsics, depth[2], [p[2] for p in pyr])
    assert _equal(one, tracker.map_keyframe(lambda x: x[2], ref))


def test_into_writes_the_picked_rows(scene):
    intrinsics, depths, grays = scene
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=300)
    pyr0, pyr1 = (pyramid.mean_pyramid(LEVELS, torch.from_numpy(g)) for g in grays[:2])
    start = tracker.precompute_keyframe(config, intrinsics, torch.from_numpy(depths[0]), pyr0)
    kf = tracker.map_keyframe(torch.clone, start)
    lanes = torch.tensor([2, 0])
    out, counts = tracker.precompute_keyframe_counts(
        config, tracker.level_intrinsics(intrinsics, LEVELS), torch.from_numpy(depths[1]), pyr1, lanes=lanes, into=kf)
    new = tracker.precompute_keyframe(config, intrinsics, torch.from_numpy(depths[1]), pyr1)
    assert out is kf
    for b, src in enumerate((new, start, new)):  # rows 0 and 2 replaced, row 1 kept
        assert _equal(tracker.map_keyframe(lambda x: x[b], kf), tracker.map_keyframe(lambda x: x[b], src))
    assert counts.tolist() == [[int(obs.valid[b].sum()) for obs in new.levels] for b in (2, 0)]


def test_clip_leaves_the_callers_state(scene):
    intrinsics, depths, grays = scene
    config = tracker.TrackerConfig(height=H, width=W, nb_levels=LEVELS, candidate_cap=300, flow_threshold=0.0)
    state = batch.batched_init_state(config, intrinsics, depths[0], grays[0], device="cpu")
    kept = tracker.map_keyframe(torch.clone, state.kf)
    final, (_, diags) = batch.batched_track_sequence(config, intrinsics, state, depths[1:], grays[1:])
    assert bool(diags.switched.all())  # every lane switches on every frame
    assert _equal(state.kf, kept)
    want = tracker.precompute_keyframe(config, intrinsics, torch.from_numpy(depths[2]),
                                       pyramid.mean_pyramid(LEVELS, torch.from_numpy(grays[2])))
    assert _equal(final.kf, want)


def test_launcher_refuses_cpu_tensors(scene):
    intrinsics, depths, grays = scene
    pyr = pyramid.mean_pyramid(LEVELS, torch.from_numpy(grays[0]))
    table = torch.zeros((LEVELS, 5))
    with pytest.raises(ValueError, match="need CUDA tensors"):
        precompute_ops.keyframe_levels(pyr, torch.from_numpy(depths[0]), table, [300] * LEVELS,
                                       scale=5000.0, variance=1e-4, threshold=7)
