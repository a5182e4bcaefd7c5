"""The port's per-level LM solve against the JAX package's ``solve_level``.

On the CPU ``solve_level`` runs ``solve_level_reference``, the Python LM loop
that the CUDA kernel ``ops.lm_solve.lm_solve_level`` is held against on the
card (``tests/test_torch_kernel_cuda.py``).  Here the loop is held against
the JAX ``solve_level`` / ``track_frame`` (``interp_method="gather"``) on the
cases the kernel must reproduce.  The keyframe is computed once by the port
and handed to JAX as numpy arrays, so both sides see the same bits, and one
jitted JAX solve (the iteration cap is a traced argument) serves every
single-level case.

Tolerances:
- ``t`` to ``atol=5e-3`` and ``q`` to ``atol=1e-4``: both solves stop inside
  the same LM basin, but reassociated f32 sums and jit-fused arithmetic move
  the iterates by ulps, and the stop rule (``energy_tol`` = 1 on energies of
  tens to hundreds) amplifies that to this size at most
  (``tests/test_torch_tracker.py``);
- ``nb_iter`` and ``failed`` equal: the inputs are fixed by a seed, and no
  accept/continue decision of these solves lies within an ulp of its
  threshold;
- the final energy to ``rtol=1e-3``: it follows the pose.  The solve capped
  at one iteration stops far from the minimum, where the energy is steep in
  the pose (the two differ by 1.2e-3 there), so its energy is held to
  ``rtol=1e-2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.core import camera as jcamera
from visual_odometry_rs_tpu.math import pose as jpose
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.dataset import synthetic
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.ops import lm_solve, pyramid, residual

torch.set_num_threads(1)

H, W, LEVELS, CAP = 120, 160, 3, 1024
KW = dict(height=H, width=W, nb_levels=LEVELS, candidate_cap=CAP)
LVL = 1  # the level of the single-level cases: 60x80, 1024 candidates
START = np.array([0.004, -0.002, 0.001, 0.001, 0.002, -0.001], np.float32)


def _jax_level(obs):
    """The port's ``LevelObs`` as the JAX package's, through numpy."""
    obs = interop.level_to_numpy(obs)
    fields = {f: jnp.asarray(getattr(obs, f)) for f in obs._fields if f != "intrinsics"}
    intrinsics = jcamera.Intrinsics(*(jnp.asarray(v) for v in obs.intrinsics))
    return jtracker.LevelObs(intrinsics=intrinsics, **fields)


def _jax_pose(p):
    return jpose.Pose(jnp.asarray(p.q.numpy()), jnp.asarray(p.t.numpy()))


@pytest.fixture(scope="module")
def setup():
    seq = synthetic.generate_sequence(
        nb_frames=2, height=H, width=W, seed=1, twist_per_frame=[0.02, 0.0, 0.0, 0.0, 0.0, 0.0]
    )
    kf = ttracker.precompute_keyframe(
        ttracker.TrackerConfig(**KW), seq.intrinsics,
        torch.from_numpy(seq.depths[0].astype(np.int32)),
        pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[0])),
    )
    pyr1 = pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[1]))
    return kf, pyr1, tse3.exp(torch.from_numpy(START))


@pytest.fixture(scope="module")
def jax_solve():
    """One compiled JAX ``solve_level`` for every single-level case."""
    return jax.jit(
        lambda obs, image, model, max_iterations: jtracker.solve_level(
            obs, image, model, max_iterations=max_iterations, interp_method="gather"
        )
    )


def _solve_both(setup, jax_solve, obs, start, max_iterations=20):
    _, pyr1, _ = setup
    image = pyr1[LVL]
    before = lm_solve.lm_solve_level.launches, residual.residual_reduce.launches
    out = ttracker.solve_level(obs, image, start, max_iterations=max_iterations)
    # CPU tensors: the plain versions, no kernel
    assert (lm_solve.lm_solve_level.launches, residual.residual_reduce.launches) == before
    ref = jax_solve(_jax_level(obs), jnp.asarray(image.numpy()), _jax_pose(start), jnp.int32(max_iterations))
    return out, ref


def _assert_same_solve(out, ref, energy_rtol=1e-3):
    assert out.failed == bool(ref.failed)
    assert out.nb_iter == int(ref.nb_iter)
    np.testing.assert_allclose(out.state.model.t.numpy(), np.asarray(ref.state.model.t), atol=5e-3)
    np.testing.assert_allclose(out.state.model.q.numpy(), np.asarray(ref.state.model.q), atol=1e-4)
    np.testing.assert_allclose(float(out.state.energy), float(ref.state.energy), rtol=energy_rtol, equal_nan=True)


@pytest.mark.parametrize("start", ["identity", "near"])
def test_normal_level_matches_jax(setup, jax_solve, start):
    kf, _, near = setup
    out, ref = _solve_both(setup, jax_solve, kf.levels[LVL], tpose.identity() if start == "identity" else near)
    _assert_same_solve(out, ref)
    assert not out.failed and 1 < out.nb_iter <= 21
    np.testing.assert_allclose(float(out.state.lm_coef), float(ref.state.lm_coef), rtol=1e-5)


def test_all_invalid_level_fails_and_keeps_the_model(setup, jax_solve):
    """No candidate: the energy is NaN, the normal equations are zero, the
    Cholesky fails at the first iteration and the model stays untouched."""
    kf, _, near = setup
    obs = kf.levels[LVL]._replace(valid=torch.zeros_like(kf.levels[LVL].valid))
    out, ref = _solve_both(setup, jax_solve, obs, near)
    _assert_same_solve(out, ref)
    assert out.failed and out.nb_iter == 1 and np.isnan(float(out.state.energy))
    assert torch.equal(out.state.model.q, near.q) and torch.equal(out.state.model.t, near.t)


def test_iteration_cap_of_one_stops_at_the_second_iteration(setup, jax_solve):
    """``nb_iter > max_iterations`` stops the solve: with a cap of 1 the
    second iteration is the last, whatever its outcome."""
    kf, _, _ = setup
    out, ref = _solve_both(setup, jax_solve, kf.levels[LVL], tpose.identity(), max_iterations=1)
    _assert_same_solve(out, ref, energy_rtol=1e-2)
    assert out.nb_iter == 2 and not out.failed
    full, _ = _solve_both(setup, jax_solve, kf.levels[LVL], tpose.identity())
    assert full.nb_iter > 2  # the cap, not convergence, ended the capped solve


def test_failed_coarsest_level_freezes_the_frame(setup):
    """The coarsest level fails: the frame fails, the model stays the init
    model through the finer levels, and those still report their iterations."""
    kf, pyr1, near = setup
    levels = list(kf.levels)
    levels[-1] = levels[-1]._replace(valid=torch.zeros_like(levels[-1].valid))
    broken = ttracker.KeyframeData(levels=tuple(levels))
    config = ttracker.TrackerConfig(**KW, level_max_iterations=(3, 4, 20))
    out = ttracker.track_frame(config, broken, pyr1, near)
    jconfig = jtracker.TrackerConfig(**KW, level_max_iterations=(3, 4, 20), interp_method="gather")
    ref = jax.jit(lambda kf, p, m: jtracker.track_frame(jconfig, kf, p, m))(
        jtracker.KeyframeData(levels=tuple(_jax_level(obs) for obs in broken.levels)),
        [jnp.asarray(p.numpy()) for p in pyr1], _jax_pose(near),
    )
    assert bool(out.failed) and bool(ref.failed)
    assert torch.equal(out.model.q, near.q) and torch.equal(out.model.t, near.t)
    np.testing.assert_array_equal(np.asarray(ref.model.t), near.t.numpy())
    assert out.nb_iters.tolist() == np.asarray(ref.nb_iters).tolist()
    assert out.nb_iters[-1] == 1 and (out.nb_iters[:-1] > 1).all()
    assert out.nb_evals.tolist() == (out.nb_iters + 1).tolist()
    # the same frame through the reference entry point
    again = ttracker.track_frame_reference(config, broken, pyr1, near)
    assert again.nb_iters.tolist() == out.nb_iters.tolist() and bool(again.failed)


def test_cluster_size_keeps_candidates_in_registers():
    """The launch geometry is plain Python: the smallest cluster of 256-thread
    blocks whose threads hold 4 candidates each, at most 8 blocks."""
    sizes = {n: residual.cluster_size(n) for n in (1, 300, 1024, 1025, 2048, 4096, 4800, 8192, 20000)}
    assert sizes == {1: 1, 300: 1, 1024: 1, 1025: 2, 2048: 2, 4096: 4, 4800: 8, 8192: 8, 20000: 8}


def test_kernel_launcher_refuses_cpu_tensors(setup):
    kf, pyr1, near = setup
    obs = kf.levels[LVL]
    with pytest.raises(ValueError, match="CUDA"):
        lm_solve.lm_solve_level(
            pyr1[LVL], obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians,
            obs.intrinsics.vector(), ttracker._start_state(near), torch.empty(lm_solve.RECORD_SIZE),
            lm_coef_init=0.1, max_iterations=20, energy_tol=1.0,
        )
