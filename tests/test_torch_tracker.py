"""The port's tracker against the JAX package: keyframe precompute,
``track_frame`` and the host ``Tracker``.

Tolerances:
- bit-equality for the candidate ``xs``, ``ys`` and ``valid`` of
  ``precompute_keyframe``, on a scene that selects more candidates than the
  cap at every level (so truncation order matters);
- ``rtol=1e-6`` for ``idepth``, ``tmpl_vals`` and ``jacobians`` (plus an
  ``atol`` of 1e-6 of the largest Jacobian entry, as the terms cancel);
- poses within the LM stopping basin: reassociated f32 sums can flip an
  accept/reject near ``energy_tol``, so ``t`` agrees to ``atol=5e-3`` and the
  flow to ``rtol=0.15, atol=2e-2`` (``tests/test_pallas_kernel.py:85-86``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.dataset import synthetic
from visual_odometry_rs_tpu.math import pose as jpose
from visual_odometry_rs_tpu.math import se3 as jse3
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.ops import pyramid as jpyr
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(1)

H, W, LEVELS, CAP = 120, 160, 3, 1024
KW = dict(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP)


@pytest.fixture(scope="module")
def seq():
    # steady sideways motion: the flow passes 1 px at the coarsest level
    # every other frame (tests/test_tracker.py:69-78)
    return synthetic.generate_sequence(
        nb_frames=7, height=H, width=W, seed=1, twist_per_frame=[0.04, 0.0, 0.0, 0.0, 0.0, 0.0]
    )


@pytest.fixture(scope="module")
def precompute_both(seq):
    """depth (u16 numpy) → (JAX keyframe as numpy, port keyframe), for the
    first frame's image; one JAX compilation serves every depth map."""
    config = jtracker.TrackerConfig(**KW)
    jfn = jax.jit(lambda d, p: jtracker.precompute_keyframe(config, seq.intrinsics, d, p))
    jpyr0 = jpyr.mean_pyramid(LEVELS, jnp.asarray(seq.grays[0]))
    tpyr0 = tpyr.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[0]))

    def run(depth):
        jkf = jfn(jnp.asarray(depth), jpyr0)
        tkf = ttracker.precompute_keyframe(
            ttracker.TrackerConfig(**KW), interop.intrinsics_from_numpy(seq.intrinsics),
            torch.from_numpy(depth.astype(np.int32)), tpyr0,
        )
        return jax.tree_util.tree_map(np.asarray, jkf), tkf

    return run


@pytest.fixture(scope="module")
def keyframes(seq, precompute_both):
    return precompute_both(seq.depths[0])


@pytest.mark.parametrize("lvl", range(LEVELS))
def test_precompute_keyframe_matches(keyframes, lvl):
    jkf, tkf = keyframes
    ref, out = jkf.levels[lvl], interop.level_to_numpy(tkf.levels[lvl])
    assert ref.valid.all()  # more candidates than the cap: truncation is exercised
    for f in ("xs", "ys", "valid", "template"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f)
    np.testing.assert_allclose(out.idepth, ref.idepth, rtol=1e-6)
    np.testing.assert_allclose(out.tmpl_vals, ref.tmpl_vals, rtol=1e-6)
    jac_atol = 1e-6 * np.abs(ref.jacobians).max()
    np.testing.assert_allclose(out.jacobians, ref.jacobians, rtol=1e-6, atol=jac_atol)


def test_precompute_keyframe_pads_with_zeros(seq, precompute_both):
    """A scene with few known depths: padding slots are zero and invalid."""
    depth = seq.depths[0].copy()
    depth[:, 20:] = 0
    jkf, tkf = precompute_both(depth)
    for ref, obs in zip(jkf.levels, tkf.levels):
        out = interop.level_to_numpy(obs)
        assert 0 < out.valid.sum() < CAP
        for f in ("xs", "ys", "valid", "idepth", "tmpl_vals", "jacobians"):
            np.testing.assert_array_equal(getattr(out, f)[~out.valid], 0, err_msg=f)
        for f in ("xs", "ys", "valid"):
            np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f)
        np.testing.assert_allclose(out.idepth, ref.idepth, rtol=1e-6)


def test_track_frame_on_jax_keyframe(seq, keyframes):
    """The JAX keyframe carried across with interop into the port."""
    jkf, _ = keyframes
    config = jtracker.TrackerConfig(**KW, interp_method="gather")
    jpyr1 = jpyr.mean_pyramid(LEVELS, jnp.asarray(seq.grays[1]))
    ref = jax.jit(lambda kf, p, m: jtracker.track_frame(config, kf, p, m))(
        jax.tree_util.tree_map(jnp.asarray, jkf), jpyr1, jpose.identity()
    )
    out = ttracker.track_frame(
        ttracker.TrackerConfig(**KW),
        interop.keyframe_from_numpy(jkf),
        tpyr.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[1])),
        tpose.identity(),
    )
    assert out.failed == bool(ref.failed) is False
    np.testing.assert_allclose(out.model.t.numpy(), np.asarray(ref.model.t), atol=5e-3)
    np.testing.assert_allclose(float(out.flow), float(ref.flow), rtol=0.15, atol=2e-2)
    assert all(n > 0 for n in out.nb_iters)


@pytest.mark.parametrize("mode", ["constant_position", "constant_velocity"])
def test_warm_start_init_matches(mode):
    poses = [jse3.exp(jnp.asarray(np.random.default_rng(s).normal(size=6) * 0.1, jnp.float32)) for s in range(3)]
    jcfg = jtracker.TrackerConfig(height=H, width=W, warm_start=mode)
    tcfg = ttracker.TrackerConfig(height=H, width=W, warm_start=mode)
    ref = jtracker.warm_start_init(jcfg, *poses)
    out = ttracker.warm_start_init(tcfg, *(interop.pose_from_numpy(jax.tree_util.tree_map(np.asarray, p)) for p in poses))
    np.testing.assert_allclose(out.q.numpy(), np.asarray(ref.q), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=1e-6, atol=1e-6)


def _run(trk, seq, to_frame):
    poses, switches = [], []
    for f in range(1, len(seq.grays)):
        before = trk.keyframe_switches
        trk.track(float(seq.timestamps[f]), to_frame(seq.depths[f]), float(seq.timestamps[f]), to_frame(seq.grays[f]))
        assert not trk.last_failed
        poses.append(np.asarray(trk.current_frame()[1].t))
        switches.append(trk.keyframe_switches > before)
    return np.stack(poses), switches


def test_tracker_matches_jax_tracker(seq):
    """Six tracked frames with bucketing on: the same keyframe switches."""
    args = (float(seq.timestamps[0]), seq.depths[0], float(seq.timestamps[0]), seq.grays[0])
    jtrk = jtracker.init_tracker(
        jtracker.TrackerConfig(**KW, bucket_candidates=True, interp_method="gather"),
        seq.intrinsics, args[0], jnp.asarray(args[1]), args[2], jnp.asarray(args[3]),
    )
    ttrk = ttracker.init_tracker(
        ttracker.TrackerConfig(**KW, bucket_candidates=True),
        interop.intrinsics_from_numpy(seq.intrinsics), *args, device="cpu",
    )
    ref_t, ref_sw = _run(jtrk, seq, jnp.asarray)
    out_t, out_sw = _run(ttrk, seq, lambda a: a)
    assert out_sw == ref_sw and sum(out_sw) >= 1
    np.testing.assert_allclose(out_t, ref_t, atol=5e-3)
    assert all(n > 0 for n in ttrk.last_nb_iters) and len(ttrk.last_nb_evals) == LEVELS


def test_tracker_defaults_to_the_gpu(seq):
    """Without ``device="cpu"`` the entry points run on the card, and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    args = (float(seq.timestamps[0]), seq.depths[0], float(seq.timestamps[0]), seq.grays[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        ttracker.init_tracker(ttracker.TrackerConfig(**KW), interop.intrinsics_from_numpy(seq.intrinsics), *args)
