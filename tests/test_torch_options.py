"""The tracker options of the port (Huber weights, affine brightness) against
the JAX package, and the port alone against the accuracy matrix's bounds.

Scenes (120x160, three levels, cap 1024): a steady sideways motion with a
bright occluder in every new frame (Huber's case,
``tests/test_tracker.py::test_huber_robust_tracking_under_occlusion``) and
the same motion under a per-frame exposure drift (the brightness model's
case, ``test_brightness_model_under_exposure_drift``).  Keyframes come from
the JAX package through ``interop``, so only the option's own arithmetic is
compared.

Tolerances:
- ``_eval_full`` with Huber weights and ``_eval_full_brightness``: energy
  ``rtol=1e-5``; g and H after scaling by their largest entry ``atol=1e-4``
  (both packages sum in another order);
- ``solve_level_brightness`` and ``track_frame`` with each option: poses
  within 5e-4 (t in m, q), ``failed`` equal; the solved (a, b)
  ``rtol=1e-3, atol=1e-2``;
- ATE: the bounds of ``tests/test_accuracy_matrix.py`` for the core rows,
  on that file's scene, run by the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.core.camera import Intrinsics as JIntrinsics
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.math import pose as jpose
from visual_odometry_rs_tpu.ops import pyramid as jpyr
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.eval import ate as tate
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(1)

H, W, LEVELS, CAP = 120, 160, 3, 1024
KW = dict(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP)
DELTA = 10.0
POSE_ATOL = 5e-4
OPTIONS = {
    "huber": dict(robust_delta=DELTA),
    "brightness": dict(brightness_model=True),
    "huber+brightness": dict(robust_delta=DELTA, brightness_model=True),
}


def _scene(kind):
    seq = tsyn.generate_sequence(
        nb_frames=3, height=H, width=W, seed=1, twist_per_frame=[0.02, 0.005, 0.0, 0.002, 0.0, 0.001]
    )
    grays = [g.copy() for g in seq.grays]
    if kind == "occluded":
        for g in grays[1:]:
            g[30:70, 40:90] = 255
    else:  # exposure drift
        gains, biases = (1.0, 1.15, 0.85), (0.0, 10.0, -12.0)
        grays = [np.clip(a * g.astype(np.float64) + b, 0, 255).astype(np.uint8)
                 for g, a, b in zip(grays, gains, biases)]
    return seq, grays


SCENE_OF = {"huber": "occluded", "brightness": "drift", "huber+brightness": "drift"}


@pytest.fixture(scope="module")
def scenes():
    """Per scene: (JAX keyframe, port keyframe, JAX and port pyramids of frame 1)."""
    config = jtracker.TrackerConfig(**KW)
    out = {}
    for kind in ("occluded", "drift"):
        seq, grays = _scene(kind)
        intr = JIntrinsics(*(jnp.asarray(v.numpy()) for v in seq.intrinsics))
        precompute = jax.jit(lambda d, p: jtracker.precompute_keyframe(config, intr, d, p))
        jkf = precompute(jnp.asarray(seq.depths[0]), jpyr.mean_pyramid(LEVELS, jnp.asarray(grays[0])))
        tkf = interop.keyframe_from_numpy(jax.tree_util.tree_map(np.asarray, jkf))
        out[kind] = (jkf, tkf, jpyr.mean_pyramid(LEVELS, jnp.asarray(grays[1])),
                     tpyr.mean_pyramid(LEVELS, torch.from_numpy(grays[1])))
    return out


def _assert_normal_equations(got, ref):
    (e, g, h), (e_ref, g_ref, h_ref) = got, [np.asarray(x) for x in ref]
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-5)
    for x, y in ((g.numpy(), g_ref), (h.numpy(), h_ref)):
        scale = np.abs(y).max()
        np.testing.assert_allclose(x / scale, y / scale, rtol=0, atol=1e-4)


def _model(seed):
    xi = np.random.default_rng(seed).normal(size=6).astype(np.float32) * np.float32(0.01)
    return tse3.exp(torch.from_numpy(xi))


@pytest.mark.parametrize("lvl", range(LEVELS))
def test_eval_full_huber_matches(scenes, lvl):
    jkf, tkf, jp, tp = scenes["occluded"]
    model = _model(lvl)
    ref = jtracker._eval_full(jkf.levels[lvl], jp[lvl], interop.pose_to_numpy(model), "gather", DELTA)
    got = ttracker._eval_full(tkf.levels[lvl], tp[lvl], model, robust_delta=DELTA)
    _assert_normal_equations(got, ref)
    # w = 1 everywhere: the unweighted sums, bit for bit
    huge = ttracker._eval_full(tkf.levels[lvl], tp[lvl], model, robust_delta=1e9)
    plain = ttracker._eval_full(tkf.levels[lvl], tp[lvl], model)
    for a, b in zip(huge, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("delta", [0.0, DELTA])
@pytest.mark.parametrize("lvl", range(LEVELS))
def test_eval_full_brightness_matches(scenes, lvl, delta):
    jkf, tkf, jp, tp = scenes["drift"]
    model, ab = _model(10 + lvl), torch.tensor([1.1, -6.0])
    ref = jtracker._eval_full_brightness(
        jkf.levels[lvl], jp[lvl],
        jtracker.BrightnessState(pose=interop.pose_to_numpy(model), ab=jnp.asarray(ab.numpy())), "gather", delta,
    )
    got = ttracker._eval_full_brightness(tkf.levels[lvl], tp[lvl], ttracker.BrightnessState(model, ab),
                                         robust_delta=delta)
    assert got[1].shape == (8,) and got[2].shape == (8, 8)
    _assert_normal_equations(got, ref)


@pytest.fixture(scope="module")
def jax_solve_brightness():
    return jax.jit(lambda obs, img, st: jtracker.solve_level_brightness(obs, img, st, interp_method="gather"))


@pytest.mark.parametrize("lvl", range(LEVELS))
def test_solve_level_brightness_matches(scenes, jax_solve_brightness, lvl):
    jkf, tkf, jp, tp = scenes["drift"]
    ref = jax_solve_brightness(
        jkf.levels[lvl], jp[lvl], jtracker.BrightnessState(pose=jpose.identity(), ab=jnp.asarray([1.0, 0.0]))
    )
    out = ttracker.solve_level_brightness(
        tkf.levels[lvl], tp[lvl], ttracker.BrightnessState(tpose.identity(), torch.tensor([1.0, 0.0]))
    )
    assert bool(out.failed) == bool(ref.failed)
    got, want = out.state.model, ref.state.model
    np.testing.assert_allclose(got.pose.t.numpy(), np.asarray(want.pose.t), atol=POSE_ATOL)
    np.testing.assert_allclose(got.pose.q.numpy(), np.asarray(want.pose.q), atol=POSE_ATOL)
    np.testing.assert_allclose(got.ab.numpy(), np.asarray(want.ab), rtol=1e-3, atol=1e-2)
    assert float((got.ab - torch.tensor([1.0, 0.0])).abs().max()) > 1e-3  # the drift moved (a, b)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_track_frame_with_option_matches(scenes, option):
    jkf, tkf, jp, tp = scenes[SCENE_OF[option]]
    jconfig = jtracker.TrackerConfig(**KW, interp_method="gather", **OPTIONS[option])
    ref = jax.jit(lambda kf, p, m: jtracker.track_frame(jconfig, kf, p, m))(jkf, jp, jpose.identity())
    out = ttracker.track_frame(ttracker.TrackerConfig(**KW, **OPTIONS[option]), tkf, tp, tpose.identity())
    assert bool(out.failed) == bool(ref.failed) is False
    np.testing.assert_allclose(out.model.t.numpy(), np.asarray(ref.model.t), atol=POSE_ATOL)
    np.testing.assert_allclose(out.model.q.numpy(), np.asarray(ref.model.q), atol=POSE_ATOL)
    # the option changed the solve: not the plain track
    plain = ttracker.track_frame(ttracker.TrackerConfig(**KW), tkf, tp, tpose.identity())
    assert float((plain.model.t - out.model.t).abs().max()) > 1e-5


def test_track_frame_detector_is_the_plain_energy(scenes):
    """The lost-frame detector: ``_eval_energy`` of the finest level under
    the solved model, with the inside and valid counts."""
    _, tkf, _, tp = scenes["drift"]
    config = ttracker.TrackerConfig(**KW, brightness_model=True)
    out = ttracker.track_frame(config, tkf, tp, tpose.identity(), detector=True)
    energy, _, inside = ttracker._eval_energy(tkf.levels[0], tp[0], out.model)
    assert torch.equal(out.detector, torch.stack([energy, inside.sum().float(), tkf.levels[0].valid.sum().float()]))


# the accuracy matrix's core tracking rows (tests/test_accuracy_matrix.py:26-35)
ATE_BOUNDS = {
    "c2f_huber": ({"robust_delta": 10.0}, 0.004),
    "c2f_br": ({"brightness_model": True}, 0.006),
    "c2f_huber_br": ({"robust_delta": 10.0, "brightness_model": True}, 0.006),
    "dso": ({"candidate_selector": "dso", "dso_threshold_coef_a": 0.2}, 0.008),
    "dsofix": ({"candidate_selector": "dso_fixed", "dso_threshold_coef_a": 0.2}, 0.008),
    "dsofix_huber_br": ({"candidate_selector": "dso_fixed", "dso_threshold_coef_a": 0.2,
                         "robust_delta": 10.0, "brightness_model": True}, 0.010),
}


@pytest.fixture(scope="module")
def matrix_scene():
    # tools/accuracy_matrix.py::_scene
    return tsyn.generate_sequence(
        nb_frames=6, height=H, width=W, seed=0, twist_per_frame=[0.012, 0.004, 0.0, 0.002, 0.0, 0.001]
    )


@pytest.mark.parametrize("row", sorted(ATE_BOUNDS))
def test_port_meets_accuracy_matrix_bound(matrix_scene, row):
    overrides, bound = ATE_BOUNDS[row]
    seq = matrix_scene
    trk = ttracker.init_tracker(ttracker.TrackerConfig(**KW, **overrides), seq.intrinsics, 0.0, seq.depths[0],
                                0.0, seq.grays[0], device="cpu")
    est = [tpose.identity()]
    for f in range(1, len(seq.grays)):
        trk.track(float(f), seq.depths[f], float(f), seq.grays[f])
        est.append(trk.current_frame()[1])
    assert tate.ate_rmse(est, seq.poses) < bound
