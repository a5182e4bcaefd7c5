"""The port's relocalization (``models/relocalize.py``, the host
``Tracker``'s keyframe ring, the batched ``RelocRing``) against the JAX
package, on the kidnap scenes of ``tests/test_relocalize.py`` and
``tests/test_parallel.py`` (120x160, three levels, cap 1024).

Equal: ``attempt``'s ``best`` and ``ok``; the streaming tracker's
relocalization count; the batched driver's (F, B) ``relocalized``,
``switched`` and ``failed`` patterns and the ring's counts and heads.
Tolerances: ``attempt``'s pose and the streaming tracker's poses within
5e-4 (t in m, q) of the JAX package's.  The batched runs' poses within the
LM stopping basin, 5e-3 (``tests/test_torch_tracker.py``'s tolerance): the
two packages sum the normal equations in another order, which flips
accept/continue decisions near ``energy_tol`` (measured up to 7e-4 m on the
kidnap batch's healthy lane and 2.0e-3 m on the healthy batch, whose lanes
move 0.03 m a frame).  Ground truth within 5e-3 or 2e-2 where the JAX tests
hold it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.core.camera import Intrinsics as JIntrinsics
from visual_odometry_rs_tpu.math import pose as jpose
from visual_odometry_rs_tpu.models import relocalize as jreloc
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.ops import pyramid as jpyr
from visual_odometry_rs_tpu.parallel import batch as jbatch
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.models import relocalize as treloc
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.ops import pyramid as tpyr
from visual_odometry_rs_tpu_torch.parallel import batch as tbatch

torch.set_num_threads(1)

H, W, LEVELS = 120, 160, 3
KW = dict(height=H, width=W, nb_levels=LEVELS, candidate_cap=1024, relocalize_window=4,
          relocalize_energy_accept=150.0)
JCONFIG = jtracker.TrackerConfig(**KW, interp_method="gather")
TCONFIG = ttracker.TrackerConfig(**KW)
POSE_ATOL = 5e-4
BASIN_ATOL = 5e-3
STEP = [0.09, 0.01, 0.005, 0.0, 0.06, 0.0]
SMALL = [0.01, 0.002, 0.001, 0.0, 0.005, 0.0]
KIDNAP = np.asarray([STEP] * 4 + [list(-4.0 * np.asarray(STEP))] + [SMALL, SMALL], np.float32)


def _jintr(seq):
    return JIntrinsics(*(jnp.asarray(v.numpy()) for v in seq.intrinsics))


def _pose_close(out, ref, atol=POSE_ATOL):
    np.testing.assert_allclose(np.asarray(out.t), np.asarray(ref.t), atol=atol)
    np.testing.assert_allclose(np.asarray(out.q), np.asarray(ref.q), atol=atol)


# --- attempt ----------------------------------------------------------------


@pytest.fixture(scope="module")
def two_keyframes():
    """Keyframes at frames 0 and 1 (far apart) and the query frame 2, near
    frame 0 (``tests/test_relocalize.py::test_attempt_picks_the_right_keyframe``)."""
    far = [0.35, 0.05, 0.02, 0.0, 0.25, 0.0]
    back = [-0.35 + 0.02, -0.05, -0.02 + 0.01, 0.002, -0.25, 0.003]
    seq = tsyn.generate_sequence(nb_frames=3, height=H, width=W, seed=21,
                                 twist_per_frame=np.asarray([far, back], np.float32))
    precompute = jax.jit(lambda d, p: jtracker.precompute_keyframe(JCONFIG, _jintr(seq), d, p))
    jkfs = [precompute(jnp.asarray(seq.depths[i]), jpyr.mean_pyramid(LEVELS, jnp.asarray(seq.grays[i])))
            for i in range(2)]
    jposes = [interop.pose_to_numpy(p) for p in seq.poses[:2]]
    history = [(interop.keyframe_from_numpy(jax.tree_util.tree_map(np.asarray, kf)), p, 0.0, 0.0)
               for kf, p in zip(jkfs, seq.poses[:2])]
    return seq, jreloc.stack_history([(kf, jpose.Pose(jnp.asarray(p.q), jnp.asarray(p.t))) for kf, p in
                                      zip(jkfs, jposes)]), treloc.stack_history(history)


@pytest.fixture(scope="module")
def jax_attempt():
    return jax.jit(lambda kfs, q, t, *pyr: jreloc.attempt(JCONFIG, kfs, q, t, list(pyr), 150.0, 0.5))


def test_attempt_picks_the_right_keyframe(two_keyframes, jax_attempt):
    seq, (jkfs, jq, jt), (tkfs, tq, tt) = two_keyframes
    ref = jax_attempt(jkfs, jq, jt, *jpyr.mean_pyramid(LEVELS, jnp.asarray(seq.grays[2])))
    out = treloc.attempt(TCONFIG, tkfs, tq, tt, tpyr.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[2])), 150.0, 0.5)
    assert bool(out.ok) == bool(ref.ok) is True
    assert int(out.best) == int(ref.best) == 0
    _pose_close(out.pose, ref.pose)
    np.testing.assert_allclose(out.pose.t.numpy(), seq.poses[2].t.numpy(), atol=5e-3)
    np.testing.assert_allclose(float(out.energy), float(ref.energy), rtol=1e-3)


def test_attempt_rejects_unmatchable_frame(two_keyframes, jax_attempt):
    seq, (jkfs, jq, jt), (tkfs, tq, tt) = two_keyframes
    noise = np.random.default_rng(7).integers(0, 256, (H, W)).astype(np.uint8)
    ref = jax_attempt(jkfs, jq, jt, *jpyr.mean_pyramid(LEVELS, jnp.asarray(noise)))
    out = treloc.attempt(TCONFIG, tkfs, tq, tt, tpyr.mean_pyramid(LEVELS, torch.from_numpy(noise)), 150.0, 0.5)
    assert bool(out.ok) == bool(ref.ok) is False
    assert int(out.best) == int(ref.best)


def test_rank_scores_bad_lanes_as_inf():
    """A failed, non-finite, mostly-outside or empty lane never wins; ties
    go to the first lane; ``ok`` needs the best score within the bound."""
    energies = torch.tensor([[5.0, 3.0, float("nan"), 3.0, 1.0, 0.5]])
    failed = torch.tensor([[False, False, False, False, True, False]])
    inside = torch.tensor([[10.0, 10.0, 10.0, 10.0, 10.0, 4.0]])
    valid = torch.tensor([[10.0, 10.0, 10.0, 10.0, 10.0, 10.0]])
    best, ok = treloc.rank(failed, energies, inside, valid, 4.0, 0.5)
    assert int(best) == 1 and bool(ok)
    best, ok = treloc.rank(failed, energies, inside, valid, 2.0, 0.5, empty=torch.tensor([[0, 1, 0, 0, 0, 0]]).bool())
    assert int(best) == 3 and not bool(ok)


# --- the streaming tracker ----------------------------------------------------


def test_streaming_kidnap_matches_jax():
    """Drive away, jump back to the start, two small steps
    (``tests/test_relocalize.py::test_tracker_relocalizes_after_kidnap``):
    the same lost frames, the same relocalization, poses within 5e-4."""
    seq = tsyn.generate_sequence(nb_frames=len(KIDNAP) + 1, height=H, width=W, seed=23, twist_per_frame=KIDNAP)
    jtrk = jtracker.init_tracker(JCONFIG, _jintr(seq), 0.0, jnp.asarray(seq.depths[0]), 0.0,
                                 jnp.asarray(seq.grays[0]))
    ttrk = ttracker.init_tracker(TCONFIG, seq.intrinsics, 0.0, seq.depths[0], 0.0, seq.grays[0], device="cpu")
    for i in range(1, len(seq.grays)):
        jtrk.track(float(i), jnp.asarray(seq.depths[i]), float(i), jnp.asarray(seq.grays[i]))
        ttrk.track(float(i), seq.depths[i], float(i), seq.grays[i])
        assert (ttrk.relocalizations, ttrk.keyframe_switches) == (jtrk.relocalizations, jtrk.keyframe_switches), i
        assert (ttrk.last_energy > 150.0) == (jtrk.last_energy > 150.0), i
        _pose_close(ttrk.current_pose, jtrk.current_pose)
    assert ttrk.relocalizations >= 1
    np.testing.assert_allclose(ttrk.current_pose.t.numpy(), seq.poses[-1].t.numpy(), atol=2e-2)


# --- the batched ring -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ring_run():
    """One compilation for every batched run of this file: 2 lanes x 7 frames."""
    seq = tsyn.generate_sequence(nb_frames=2, height=H, width=W)
    intr = _jintr(seq)
    init = jax.jit(lambda d, g: jbatch.batched_init_state(JCONFIG, intr, d, g))
    run = jax.jit(lambda s, dd, gg, r: jbatch.batched_track_sequence(JCONFIG, intr, s, dd, gg, reloc_ring=r))

    def both(lanes):
        """(JAX results as numpy, port results) for the lanes' sequences."""
        d0 = np.stack([s.depths[0] for s in lanes])
        g0 = np.stack([s.grays[0] for s in lanes])
        cd = np.stack([np.stack([s.depths[f] for s in lanes]) for f in range(1, len(KIDNAP) + 1)])
        cg = np.stack([np.stack([s.grays[f] for s in lanes]) for f in range(1, len(KIDNAP) + 1)])
        state = init(jnp.asarray(d0), jnp.asarray(g0))
        ring = jbatch.batched_init_ring(JCONFIG, state)
        ref = jax.tree_util.tree_map(np.asarray, run(state, jnp.asarray(cd), jnp.asarray(cg), ring))
        tstate = interop.track_state_from_numpy(jax.tree_util.tree_map(np.asarray, state))
        tring = interop.reloc_ring_from_numpy(jax.tree_util.tree_map(np.asarray, ring))
        out = tbatch.batched_track_sequence(TCONFIG, seq.intrinsics, tstate, cd, cg, reloc_ring=tring)
        return ref, out, tring

    return both


def _assert_patterns_equal(ref, out):
    (_, (_, diags), ring), (_, (_, tdiags), tring) = ref, out
    for f in ("relocalized", "switched", "failed"):
        np.testing.assert_array_equal(getattr(tdiags, f).numpy(), getattr(diags, f), err_msg=f)
    np.testing.assert_array_equal(tring.count.numpy(), ring.count)
    np.testing.assert_array_equal(tring.head.numpy(), ring.head)


def test_batched_ring_kidnapped_lane_matches_jax(jax_ring_run):
    kid = tsyn.generate_sequence(nb_frames=len(KIDNAP) + 1, height=H, width=W, seed=23, twist_per_frame=KIDNAP)
    ok = tsyn.generate_sequence(nb_frames=len(KIDNAP) + 1, height=H, width=W, seed=24,
                                motion_scale=0.012, rot_scale=0.004)
    ref, out, ring_in = jax_ring_run([kid, ok])
    _assert_patterns_equal(ref, out)
    relocalized = out[1][1].relocalized.numpy()
    assert relocalized[:, 0].any() and not relocalized[:, 1].any()
    poses, ref_poses = out[1][0], ref[1][0]
    np.testing.assert_allclose(poses.t.numpy(), ref_poses.t, atol=BASIN_ATOL)
    for f in (len(KIDNAP) - 2, len(KIDNAP) - 1):  # back near the ground truth
        assert np.linalg.norm(poses.t[f, 0].numpy() - kid.poses[f + 1].t.numpy()) < 0.02
    # the ring passed in is left as it was
    assert int(ring_in.count.sum()) == 2


def test_batched_ring_healthy_batch_matches_jax(jax_ring_run):
    """No lane lost: nothing relocalizes, the switches are JAX's, the ring
    takes the new keyframes, and the run equals the ring-free run."""
    lanes = [tsyn.generate_sequence(nb_frames=len(KIDNAP) + 1, height=H, width=W, seed=s,
                                    twist_per_frame=[0.03, 0.006, 0.0, 0.0, 0.004, 0.0]) for s in (40, 41)]
    ref, out, _ = jax_ring_run(lanes)
    _assert_patterns_equal(ref, out)
    final, (poses, diags), ring = out
    assert not diags.relocalized.any() and diags.switched.any()
    np.testing.assert_allclose(poses.t.numpy(), ref[1][0].t, atol=BASIN_ATOL)
    ref_ring = ref[2]
    for lvl, (o, r) in enumerate(zip(interop.reloc_ring_to_numpy(ring).kf.levels, ref_ring.kf.levels)):
        for f in ("xs", "ys", "valid"):
            np.testing.assert_array_equal(getattr(o, f), getattr(r, f), err_msg=(lvl, f))
    start = tbatch.batched_init_state(TCONFIG, lanes[0].intrinsics, np.stack([s.depths[0] for s in lanes]),
                                      np.stack([s.grays[0] for s in lanes]), device="cpu")
    plain = ttracker.TrackerConfig(**{**KW, "relocalize_window": 0})
    cd = np.stack([np.stack([s.depths[f] for s in lanes]) for f in range(1, len(KIDNAP) + 1)])
    cg = np.stack([np.stack([s.grays[f] for s in lanes]) for f in range(1, len(KIDNAP) + 1)])
    _, (off_poses, off_diags) = tbatch.batched_track_sequence(plain, lanes[0].intrinsics, start, cd, cg)
    _, (on_poses, on_diags), _ = tbatch.batched_track_sequence(
        TCONFIG, lanes[0].intrinsics, start, cd, cg, reloc_ring=tbatch.batched_init_ring(TCONFIG, start)
    )
    assert torch.equal(on_poses.t, off_poses.t) and torch.equal(on_diags.switched, off_diags.switched)


def test_reloc_ring_interop_roundtrip():
    seq = tsyn.generate_sequence(nb_frames=2, height=30, width=40, seed=4)
    config = ttracker.TrackerConfig(height=30, width=40, nb_levels=2, candidate_cap=256, relocalize_window=3)
    state = tbatch.batched_init_state(config, seq.intrinsics, seq.depths, seq.grays, device="cpu")
    ring = tbatch.batched_init_ring(config, state)
    back = interop.reloc_ring_from_numpy(interop.reloc_ring_to_numpy(ring))
    assert back.kf.levels[0].xs.shape == (2, 3, 256)
    for a, b in zip(jax.tree_util.tree_leaves(ring), jax.tree_util.tree_leaves(back)):
        assert torch.equal(a, b)
