"""Parity of the port's window BA (``parallel/ba.py``) with the JAX
package's, on ``tests/test_ba.py``'s synthetic windows, and the port's
mirror of that file's single-device tests.

Tolerances (the same problem, built by ``test_ba.make_problem`` and read
into numpy, in both packages):
- Residuals: ``atol=1e-4`` px (measured 1.5e-5; XLA fuses the projection's
  multiply-adds).  ``jax.jacfwd`` runs jitted: eager, it takes 10 s.
- Jacobians against JAX's ``jax.jacfwd``: ``atol=1e-5`` of the largest
  entry (closed forms for unit quaternions against forward-mode through
  the first-order renormalized ones; measured at most 3.0e-6).
- ``solve`` without noise, K=4 P=64 and K=16 P=256: poses ``atol=1e-5`` m
  (measured 1.8e-6), points ``atol=1e-4`` (measured 2.5e-5), both final
  energies below 1e-6 of the start (measured 1.5e-8 and 2.7e-7 px² against
  starts of 3.0e3 and 1.5e4).  With 0.5 px noise, K=4 P=64, 15 iterations: the
  energy ``rtol=1e-5`` (measured 1.0e-7), poses ``atol=2e-3`` m (measured
  7.8e-4); the points are not compared there, since the gauge leaves the
  scale free and 15 damped steps walk along it (measured 7.3e-2).
- LM iterations: equal in at least two of the three solves (measured:
  all three, 4, 15 and 4), as ROADMAP C2 asks of decisions near ties.
"""

import jax
import numpy as np
import pytest
import torch
from test_ba import make_problem

from visual_odometry_rs_tpu.parallel import ba as jba
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.eval import ate
from visual_odometry_rs_tpu_torch.math.pose import Pose
from visual_odometry_rs_tpu_torch.parallel import ba as tba

torch.set_num_threads(1)

CASES = {
    "k4_p64": dict(),
    "k4_p64_noise": dict(seed=1, noise_px=0.5),
    "k16_p256": dict(K=16, P=256, seed=5, perturb=0.01),
}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pose_list(p):
    return [Pose(p.q[i], p.t[i]) for i in range(p.q.shape[0])]


@pytest.fixture(scope="module")
def solved():
    out = {}
    for name, kw in CASES.items():
        problem, gt_poses, gt_points = make_problem(**kw)
        ref = jba.solve(problem)
        port_problem = interop.ba_problem_from_numpy(_numpy(problem))
        out[name] = dict(
            problem=problem, port_problem=port_problem, gt_poses=interop.pose_from_numpy(_numpy(gt_poses)),
            ref=interop.ba_result_from_numpy(_numpy(ref)), res=tba.solve(port_problem),
            energy0=float(tba._energy(port_problem, port_problem.poses, port_problem.points)),
        )
    return out


@pytest.mark.parametrize("name", ["k4_p64", "k16_p256"])
def test_solve_matches_jax(solved, name):
    case = solved[name]
    res, ref = case["res"], case["ref"]
    np.testing.assert_allclose(res.poses.t.numpy(), ref.poses.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(res.poses.q.numpy(), ref.poses.q.numpy(), atol=1e-5)
    np.testing.assert_allclose(res.points.numpy(), ref.points.numpy(), atol=1e-4)
    assert float(res.energy) < 1e-6 * case["energy0"] and float(ref.energy) < 1e-6 * case["energy0"]


def test_solve_with_noise_matches_jax(solved):
    res, ref = solved["k4_p64_noise"]["res"], solved["k4_p64_noise"]["ref"]
    np.testing.assert_allclose(float(res.energy), float(ref.energy), rtol=1e-5)
    np.testing.assert_allclose(res.poses.t.numpy(), ref.poses.t.numpy(), atol=2e-3)


def test_iterations_match_as_a_share(solved):
    same = sum(int(c["res"].nb_iter) == int(c["ref"].nb_iter) for c in solved.values())
    assert same >= 2, {k: (int(c["res"].nb_iter), int(c["ref"].nb_iter)) for k, c in solved.items()}


@pytest.mark.parametrize("name", ["k4_p64", "k16_p256"])
def test_residuals_and_jacobians_match_jacfwd(solved, name):
    case = solved[name]
    problem, pp = case["problem"], case["port_problem"]
    r_j = np.asarray(jba.residuals(problem, problem.poses, problem.points))
    np.testing.assert_allclose(tba.residuals(pp, pp.poses, pp.points).numpy(), r_j, atol=1e-4)
    for out, ref in zip(tba._obs_jacobians(pp, pp.poses, pp.points),
                        jax.jit(jba._obs_jacobians)(problem, problem.poses, problem.points)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_masked_observations_contribute_nothing(solved):
    pp = solved["k4_p64"]["port_problem"]
    mask = pp.obs_mask.clone()
    mask[::3] = False
    masked = pp._replace(obs_mask=mask)
    j_cam, j_pt, r = tba._obs_jacobians(masked, pp.poses, pp.points)
    assert not j_cam[~mask].any() and not j_pt[~mask].any() and not r[~mask].any()
    assert not tba.residuals(masked, pp.poses, pp.points)[~mask].any()


def test_ba_converges_to_ground_truth(solved):
    case = solved["k4_p64"]
    assert float(case["res"].energy) < 1e-4 * case["energy0"]
    err = ate.ate_rmse(_pose_list(case["res"].poses), _pose_list(case["gt_poses"]), with_scale=True)
    assert err < 1e-3, err


def test_ba_with_noise_reduces_energy(solved):
    case = solved["k4_p64_noise"]
    assert float(case["res"].energy) < 0.5 * case["energy0"]
    err = ate.ate_rmse(_pose_list(case["res"].poses), _pose_list(case["gt_poses"]), with_scale=True)
    assert err < 0.02, err


def test_non_positive_definite_camera_system_gives_nan():
    """A camera system that is not positive definite gives a NaN step, as
    JAX's Cholesky does, without raising."""
    S = -torch.eye(12)
    delta = tba._solve_cameras(S, torch.ones(12), 2)
    assert torch.isnan(delta).all()


def test_problem_and_result_round_trip(solved):
    case = solved["k4_p64"]
    back = interop.ba_problem_to_numpy(case["port_problem"])
    assert back.obs_kf.dtype == np.int32
    again = interop.ba_problem_from_numpy(back)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(again)), jax.tree_util.tree_leaves(tuple(case["port_problem"]))):
        assert torch.equal(a, b)
    res = interop.ba_result_from_numpy(interop.ba_result_to_numpy(case["res"]))
    assert torch.equal(res.points, case["res"].points) and int(res.nb_iter) == int(case["res"].nb_iter)


def test_point_sharded_names_the_multi_gpu_work(solved):
    with pytest.raises(NotImplementedError, match="A12"):
        tba.solve_point_sharded(solved["k4_p64"]["port_problem"], None)


@pytest.mark.parametrize("name", ["k4_p64_noise", "k16_p256"])
def test_synthetic_problem_is_make_problem(solved, name):
    """The port's ``synthetic_problem`` draws ``make_problem``'s window: the
    indices and mask equal, the poses, points and pixels within f32 ulps of
    the algebra (measured at most 3.1e-5 px on pixels of O(100))."""
    ours, gt_poses, _ = tba.synthetic_problem(**CASES[name])
    ref = solved[name]["port_problem"]
    assert torch.equal(ours.obs_kf, ref.obs_kf) and torch.equal(ours.obs_pt, ref.obs_pt)
    assert torch.equal(ours.obs_mask, ref.obs_mask)
    np.testing.assert_allclose(ours.obs_uv.numpy(), ref.obs_uv.numpy(), atol=1e-4)
    np.testing.assert_allclose(ours.points.numpy(), ref.points.numpy(), atol=1e-6)
    np.testing.assert_allclose(ours.poses.t.numpy(), ref.poses.t.numpy(), atol=1e-6)
    np.testing.assert_allclose(gt_poses.q.numpy(), solved[name]["gt_poses"].q.numpy(), atol=1e-6)
