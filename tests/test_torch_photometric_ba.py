"""The port's photometric window (``models/photometric_ba.py``) against the
JAX package, on the CPU.

A 3-frame window of a synthetic 64x80 sequence (seed 12, 2 levels, cap
256), the keyframe's candidates from the JAX package's jitted precompute,
the poses perturbed by 3e-3 twists.  The JAX references are jitted (the
path its CLIs run) with gather sampling, built once.  Tolerances, with
the values measured on the CPU beside them:

- ``_build``: residuals ``atol=2e-3`` on values up to 20 (measured 3.9e-4;
  XLA fuses the projection otherwise, about 4e-5 px); twist Jacobians of
  frames 1.. within ``1e-3`` of their largest entry (measured 6.8e-6);
  depth Jacobians ``atol=5e-3`` (measured 1.8e-3 of 52).  Frame 0
  is the keyframe: its candidates warp onto integer pixels, where the
  interpolant's derivative jumps from one cell to the next, so which cell
  a rounding picks differs between the packages (its twist block is the
  gauge and never enters a step).
- ``_camera_system``: the free blocks (frames 1..) of S and rhs within
  ``1e-4`` of their largest entry (measured 6.2e-7 and 1.3e-6), D_inv,
  E and b_d within ``1e-4`` relative (measured 7.0e-6, 1.9e-5, 3.4e-5).
- Solves, with brightness and Huber (``OPTIONS``; the plain solve is held
  against JAX through the windows of ``tests/test_torch_sliding_window.py``
  and ``tests/test_torch_refine.py``): the same iteration count, poses
  ``atol=2e-5``, depths ``atol=2e-4`` on values about 0.5, energy
  ``rtol=1e-4``, brightness ``atol=5e-4`` (measured 3.6e-7, 2.9e-6, 9.1e-6
  relative and 7.1e-5).  The JAX lanes come from one
  ``solve_window_batched`` (one compile for three windows; JAX's vmap
  lowers its sums otherwise, about 1e-5 in pose after a few iterations).
- ``solve_window_batched`` against ``solve_window``, lane by lane:
  ``atol=1e-6, rtol=1e-5`` (measured 7.7e-9 in pose, 1.5e-6 relative in
  energy: a product over three lanes is not always blocked like a product
  over one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.core.camera import Intrinsics as JIntrinsics
from visual_odometry_rs_tpu.math import pose as jpose
from visual_odometry_rs_tpu.math import se3 as jse3
from visual_odometry_rs_tpu.math.pose import Pose as JPose
from visual_odometry_rs_tpu.models import photometric_ba as jpba
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.ops import pyramid as jpyramid
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.math.pose import Pose as TPose
from visual_odometry_rs_tpu_torch.models import photometric_ba as tpba
from visual_odometry_rs_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

H, W, F = 64, 80, 3
ITERS = 6
OPTIONS = dict(brightness=True, robust_delta=10.0)  # the solves' options: every term of the camera system
AB = np.array([[1.0, 0.0], [1.05, -3.0], [0.97, 2.0]], np.float32)
VARIANTS = {"plain": (0.0, False), "huber": (10.0, False), "brightness": (0.0, True)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    return _reference()


def _reference():
    seq = tsyn.generate_sequence(nb_frames=F, height=H, width=W, seed=12)
    k = JIntrinsics(*(jnp.asarray(v.numpy()) for v in seq.intrinsics))
    config = jtracker.TrackerConfig(height=H, width=W, nb_levels=2, candidate_cap=256, interp_method="gather")
    kf = jax.jit(lambda d, p: jtracker.precompute_keyframe(config, k, d, p))(
        jnp.asarray(seq.depths[0]), jpyramid.mean_pyramid(2, jnp.asarray(seq.grays[0])))
    images = jnp.asarray(np.stack(seq.grays).astype(np.float32))
    pose0 = JPose(jnp.asarray(seq.poses[0].q.numpy()), jnp.asarray(seq.poses[0].t.numpy()))
    rng = np.random.default_rng(1)
    xis = (rng.normal(size=(F, 6)) * 3e-3).astype(np.float32)
    xis[0] = 0.0
    rel = [jpose.compose(jpose.compose(jpose.inverse(JPose(jnp.asarray(p.q.numpy()), jnp.asarray(p.t.numpy()))),
                                       pose0), jse3.exp(jnp.asarray(x))) for p, x in zip(seq.poses, xis)]
    poses = JPose(jnp.stack([p.q for p in rel]), jnp.stack([p.t for p in rel]))
    win = jpba.window_from_tracking(config, k, kf.levels, images, poses)
    idepth = win.idepth * 1.01
    ab = jnp.asarray(AB)
    # a pose prior: stiff on frame 1, anchored 2e-3 away from its start
    anchors = JPose(poses.q, poses.t.at[1].add(2e-3))
    Hp = jnp.zeros((F, 6, F, 6)).at[1, :, 1, :].set(1e5 * jnp.eye(6)).at[2, :, 2, :].set(1e3 * jnp.eye(6))

    def systems(w):
        out = {}
        for name, (delta, brightness) in VARIANTS.items():
            out[name] = (
                jpba._build(w, w.poses, idepth, "gather", delta, ab=ab, brightness=brightness),
                jpba._camera_system(w, w.poses, idepth, jnp.float32(1e-3), jnp.float32(1e4), "gather", delta,
                                    ab=ab, brightness=brightness),
            )
        out["prior"] = (None, jpba._camera_system(w, w.poses, idepth, jnp.float32(1e-3), jnp.float32(1e4), "gather",
                                                  pose_prior=(Hp, anchors)))
        return out

    # three windows in one compile: no prior, the prior, frame 2 out of view
    away = JPose(poses.q, poses.t.at[2].add(jnp.asarray([3.0, 0.0, 0.0])))
    lanes = [win, win, win._replace(poses=away)]
    zero = jnp.zeros_like(Hp)
    priors = (jnp.stack([zero, Hp, zero]),
              JPose(jnp.stack([poses.q, anchors.q, poses.q]), jnp.stack([poses.t, anchors.t, poses.t])))
    batched = jpba.solve_window_batched(jpba.stack_windows(lanes), pose_prior=priors, max_iterations=ITERS,
                                        interp_method="gather", **OPTIONS)
    return dict(
        win=_np(win), idepth=np.asarray(idepth), Hp=np.asarray(Hp), anchors=_np(anchors), lanes=[_np(w) for w in lanes],
        systems=_np(jax.jit(systems)(win)), batched=_np(batched),
        prior_lanes=(np.asarray(priors[0]), _np(priors[1])),
    )


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_window(win):
    return interop.window_from_numpy(win)


def test_bilinear_grad_matches_jax_jacfwd():
    """``interp.bilinear_grad`` on a stack of images, each at its own points,
    against ``jax.jacfwd`` through ``bilinear_gather``: the interpolant's
    derivative, zero outside.  ``atol=1e-3`` on derivatives up to 255
    (measured 1.5e-5)."""
    from visual_odometry_rs_tpu.ops import interp as jinterp
    from visual_odometry_rs_tpu_torch.ops import interp as tinterp

    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, size=(2, 20, 30)).astype(np.float32)
    # points off the integer grid (the interpolant's kinks), some outside
    x = (rng.uniform(-3, 32, size=(2, 40)).round() + rng.uniform(0.05, 0.95, size=(2, 40))).astype(np.float32)
    y = (rng.uniform(-3, 22, size=(2, 40)).round() + rng.uniform(0.05, 0.95, size=(2, 40))).astype(np.float32)

    def one(img, px, py):
        val, inside = jinterp.bilinear_gather(img, px, py)
        dx, dy = jax.jacfwd(lambda a, b: jinterp.bilinear_gather(img, a, b)[0], argnums=(0, 1))(px, py)
        return val, inside, dx, dy

    ref = jax.jit(jax.vmap(jax.vmap(one, in_axes=(None, 0, 0))))(jnp.asarray(imgs), jnp.asarray(x), jnp.asarray(y))
    got = tinterp.bilinear_grad(torch.from_numpy(imgs), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert 0 < int(got[1].sum()) < x.size
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-3)
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-3)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_build_matches_jax(ref, variant):
    delta, brightness = VARIANTS[variant]
    win = _port_window(ref["win"])
    r, maskf, j_xi, j_d = tpba._build(win, win.poses, _t(ref["idepth"]), robust_delta=delta, ab=_t(AB),
                                      brightness=brightness)
    jr, jmask, jxi, jd = ref["systems"][variant][0]
    np.testing.assert_allclose(r.numpy(), jr, atol=2e-3)
    np.testing.assert_allclose(maskf.numpy(), jmask, atol=1e-4)
    assert j_xi.shape == jxi.shape == (F, 256, 8 if brightness else 6)
    np.testing.assert_allclose(j_xi.numpy()[1:], jxi[1:], atol=1e-3 * np.abs(jxi[1:]).max())
    np.testing.assert_allclose(j_d.numpy(), jd, atol=5e-3)


@pytest.mark.parametrize("variant", [*VARIANTS, "prior"])
def test_camera_system_matches_jax(ref, variant):
    delta, brightness = VARIANTS.get(variant, (0.0, False))
    win = _port_window(ref["win"])
    kwargs = dict(robust_delta=delta, ab=_t(AB), brightness=brightness)
    if variant == "prior":
        kwargs = dict(pose_prior=(_t(ref["Hp"]), interop.pose_from_numpy(ref["anchors"])))
    out = tpba._camera_system(win, win.poses, _t(ref["idepth"]), 1e-3, 1e4, **kwargs)
    S, rhs, D_inv, E, b_d = (x.numpy() for x in out)
    jS, jrhs, jD_inv, jE, jb_d = ref["systems"][variant][1]
    free = np.s_[1:, :, 1:, :]
    np.testing.assert_allclose(S[free], jS[free], atol=1e-4 * np.abs(jS[free]).max())
    np.testing.assert_allclose(rhs[1:], jrhs[1:], atol=1e-4 * np.abs(jrhs[1:]).max())
    np.testing.assert_allclose(D_inv, jD_inv, rtol=1e-4)
    np.testing.assert_allclose(E[1:], jE[1:], atol=1e-4 * np.abs(jE[1:]).max())
    np.testing.assert_allclose(b_d, jb_d, atol=1e-4 * np.abs(jb_d).max())


def _close_solve(res, jres, ab_atol=5e-4):
    assert int(res.nb_iter) == int(jres.nb_iter)
    np.testing.assert_allclose(res.poses.q.numpy(), jres.poses.q, atol=2e-5)
    np.testing.assert_allclose(res.poses.t.numpy(), jres.poses.t, atol=2e-5)
    np.testing.assert_allclose(res.idepth.numpy(), jres.idepth, atol=2e-4)
    np.testing.assert_allclose(float(res.energy), float(jres.energy), rtol=1e-4)
    np.testing.assert_allclose(res.ab.numpy(), jres.ab, atol=ab_atol)


@pytest.mark.parametrize("lane", ["no prior", "prior", "frame out of view"])
def test_solve_window_matches_jax(ref, lane):
    b = ["no prior", "prior", "frame out of view"].index(lane)
    win = _port_window(ref["lanes"][b])
    prior = None
    if lane == "prior":
        prior = (_t(ref["Hp"]), interop.pose_from_numpy(ref["anchors"]))
    res = tpba.solve_window(win, pose_prior=prior, max_iterations=ITERS, **OPTIONS)
    jres = jax.tree_util.tree_map(lambda x: x[b], ref["batched"])
    _close_solve(res, jres)
    if lane == "frame out of view":  # no information: the frame stays where it was
        np.testing.assert_array_equal(res.poses.t.numpy()[2], ref["lanes"][2].poses.t[2])
    else:
        assert int(res.nb_iter) >= 2


def test_solve_window_degenerate_frame_keeps_its_brightness(ref):
    """A frame wholly out of view has zero columns in the camera system;
    the additive damping floor keeps them solvable, so its gain and bias
    stay (1, 0) while the other frames' move, as in JAX's lane."""
    res = tpba.solve_window(_port_window(ref["lanes"][2]), max_iterations=ITERS, **OPTIONS)
    np.testing.assert_array_equal(res.ab.numpy()[2], [1.0, 0.0])
    np.testing.assert_array_equal(ref["batched"].ab[2][2], [1.0, 0.0])
    assert not np.allclose(res.ab.numpy()[1], [1.0, 0.0])
    assert np.isfinite(res.poses.q.numpy()).all() and float(res.energy) > 0


def test_solve_window_batched_matches_single(ref):
    """Lane by lane, ``solve_window_batched`` (per-lane priors and starting
    depths) is ``solve_window`` of each window."""
    wins = [_port_window(w) for w in ref["lanes"]]
    Hs, anchors = ref["prior_lanes"]
    init = torch.stack([w.idepth for w in wins]) * 1.001
    out = tpba.solve_window_batched(tpba.stack_windows(wins), pose_prior=(_t(Hs), interop.pose_from_numpy(anchors)),
                                    idepth_init=init, max_iterations=ITERS)
    for b, w in enumerate(wins):
        one = tpba.solve_window(w, pose_prior=(_t(Hs[b]), TPose(_t(anchors.q[b]), _t(anchors.t[b]))),
                                idepth_init=init[b], max_iterations=ITERS)
        for got, want in zip(jax.tree_util.tree_leaves(interop.window_result_to_numpy(out)),
                             jax.tree_util.tree_leaves(interop.window_result_to_numpy(one))):
            np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="leading batch axis"):
        tpba.solve_window_batched(tpba.stack_windows(wins), pose_prior=(_t(Hs[0]), interop.pose_from_numpy(anchors)))


def test_window_interop_round_trip(ref):
    win = _port_window(ref["win"])
    back = interop.window_to_numpy(win)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref["win"])):
        np.testing.assert_array_equal(got, want)
    lane = jax.tree_util.tree_map(lambda x: x[0], ref["batched"])
    res = interop.window_result_from_numpy(lane)
    for got, want in zip(jax.tree_util.tree_leaves(interop.window_result_to_numpy(res)),
                         jax.tree_util.tree_leaves(lane)):
        np.testing.assert_array_equal(got, want)


def test_sharded_paths_name_a12(ref):
    """The mesh paths on meshes of CPU devices: the candidate-sharded solve
    on a one-device axis is ``solve_window`` bit for bit, two lanes over two devices are the batched
    solve bit for bit, and an axis of several local devices cannot carry
    the sharded sums (``tests/test_torch_sharded.py`` runs them on 4 ranks)."""
    win = _port_window(ref["win"])
    one = tmesh.make_mesh((1,), ("points",), devices=["cpu"])
    two = tmesh.make_mesh((2,), ("data",), devices=["cpu"] * 2)
    single = tpba.solve_window(win, max_iterations=ITERS, **OPTIONS)
    got = tpba.solve_window_sharded(win, one, max_iterations=ITERS, **OPTIONS)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(tuple(got)),
                                                 jax.tree_util.tree_leaves(tuple(single))))
    wins = tpba.stack_windows([win, win])
    batched, meshed = (tpba.solve_window_batched(wins, m, max_iterations=ITERS) for m in (None, two))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(tuple(meshed)),
                                                 jax.tree_util.tree_leaves(tuple(batched))))
    with pytest.raises(ValueError, match="process group"):
        tpba.solve_window_sharded(win, tmesh.make_mesh((2,), ("points",), devices=["cpu"] * 2))
