"""Parity of the port's pose algebra, so3/se3 and LM optimizer with the JAX
package, on the same numpy inputs.

Tolerances: ``rtol=1e-6`` for pose/so3/se3 values, plus ``atol=1e-6`` on
components that are sums of O(1) terms and can cancel to near zero (a few
f32 ulps of the terms: the two backends fuse multiply-adds differently), an
absolute ``1e-7`` on the outputs of Taylor-branch inputs, and ``rtol=1e-5``
for the 6x6 Cholesky solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.math import optimizer as jopt
from visual_odometry_rs_tpu.math import pose as jpose
from visual_odometry_rs_tpu.math import se3 as jse3
from visual_odometry_rs_tpu.math import so3 as jso3
from visual_odometry_rs_tpu_torch.math import optimizer as topt
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.math import so3 as tso3

torch.set_num_threads(1)


def _twists(seed, n=32, rot=0.5):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(size=(n, 3)), rot * rng.normal(size=(n, 3))], axis=1)
    xi[: n // 4, 3:] *= 1e-3  # Taylor branch: theta^2 < 1e-4
    return xi.astype(np.float32)


def _close(out, ref, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_pose_ops_match():
    xi_a, xi_b = _twists(0), _twists(1)
    pts = np.random.default_rng(2).normal(size=(32, 3)).astype(np.float32)

    @jax.jit
    def ref_fn(xi_a, xi_b, pts):
        ja, jb = jse3.exp(xi_a), jse3.exp(xi_b)
        return [jpose.compose(ja, jb), jpose.inverse(ja), jpose.renormalize_first_order(jb)], jpose.apply(ja, pts)

    refs, ref_pts = ref_fn(xi_a, xi_b, pts)
    ta, tb = tse3.exp(torch.from_numpy(xi_a)), tse3.exp(torch.from_numpy(xi_b))
    outs = [tpose.compose(ta, tb), tpose.inverse(ta), tpose.renormalize_first_order(tb)]
    for r, o in zip(refs, outs):
        _close(o.q, r.q)
        _close(o.t, r.t)
    _close(tpose.apply(ta, torch.from_numpy(pts)), ref_pts)


def test_so3_exp_log_match():
    w = _twists(3)[:, 3:]
    # near theta = pi: |w_real| < 1e-2 takes the Taylor-in-alpha branch
    q_pi = np.array([[2e-3, 1.0, 0.0, 0.0], [-5e-3, 0.0, 0.6, 0.8]], np.float32)
    q_pi /= np.linalg.norm(q_pi, axis=1, keepdims=True)
    q_ref, log_ref, log_pi_ref = jax.jit(lambda w, q_pi: (jso3.exp(w), jso3.log(jso3.exp(w)), jso3.log(q_pi)))(w, q_pi)
    q_out = tso3.exp(torch.from_numpy(w))
    _close(q_out, q_ref)
    _close(tso3.log(q_out), log_ref)
    _close(tso3.log(torch.from_numpy(q_pi)), log_pi_ref)


def test_se3_exp_log_match():
    xi = _twists(4)
    small = xi[:8] * np.float32(1e-3)  # Taylor rows alone, at an absolute tolerance
    p_ref, log_ref, small_ref = jax.jit(
        lambda xi, small: (jse3.exp(xi), jse3.log(jse3.exp(xi)), jse3.exp(small))
    )(xi, small)
    p_out = tse3.exp(torch.from_numpy(xi))
    _close(p_out.q, p_ref.q)
    _close(p_out.t, p_ref.t)
    _close(tse3.log(p_out), log_ref)
    _close(tse3.exp(torch.from_numpy(small)).t, small_ref.t, rtol=0, atol=1e-7)


def _spd(seed):
    a = np.random.default_rng(seed).normal(size=(6, 6)).astype(np.float32)
    return (a @ a.T + 6.0 * np.eye(6, dtype=np.float32)).astype(np.float32)


def test_damped_solve_matches():
    h = _spd(5)
    g = np.random.default_rng(6).normal(size=6).astype(np.float32)
    ref = jopt.damped_solve(jnp.asarray(h), jnp.asarray(g), jnp.float32(0.1))
    out = topt.damped_solve(torch.from_numpy(h), torch.from_numpy(g), torch.tensor(0.1))
    _close(out, ref, rtol=1e-5, atol=1e-6)


def test_non_pd_hessian_fails_without_raising():
    h = -_spd(7)  # negative definite: Cholesky fails
    g = np.ones(6, np.float32)
    ref = jopt.damped_solve(jnp.asarray(h), jnp.asarray(g), jnp.float32(0.1))
    out = topt.damped_solve(torch.from_numpy(h), torch.from_numpy(g), torch.tensor(0.1))
    assert not np.isfinite(np.asarray(ref)).all()
    assert not torch.isfinite(out).any()

    # through the driver: the failed step stops the loop with failed=True and
    # leaves the initial state in place
    def init(_, model):
        return topt.LMState(model, torch.tensor(5.0), torch.from_numpy(g), torch.from_numpy(h), torch.tensor(0.1))

    def step(state):
        return state.model - topt.damped_solve(state.hessian, state.gradient, state.lm_coef)

    def eval_fn(_, state, new_model):
        return new_model, torch.tensor(1.0), state.gradient, state.hessian

    def stop(state, nb_iter, out):
        return topt.lm_update(state, nb_iter, *out, max_iterations=20, energy_tol=1.0)

    res = topt.iterative_solve(
        None, torch.zeros(6), init=init, step=step, eval_fn=eval_fn, stop_criterion=stop
    )
    assert res.failed and res.nb_iter == 1
    assert torch.equal(res.state.model, torch.zeros(6))


@pytest.mark.parametrize("new_energy", [float("nan"), 3.0, 7.0])
def test_lm_update_matches(new_energy):
    """Accept (lower or NaN energy, like Rust's ``>``) and reject (higher)."""
    h, g = _spd(8), np.arange(6, dtype=np.float32)
    jstate = jopt.LMState(jnp.zeros(6), jnp.float32(5.0), jnp.asarray(g), jnp.asarray(h), jnp.float32(0.1))
    tstate = topt.LMState(torch.zeros(6), torch.tensor(5.0), torch.from_numpy(g), torch.from_numpy(h), torch.tensor(0.1))
    new = np.full(6, 2.0, np.float32)
    jout, jcont = jopt.lm_update(
        jstate, jnp.int32(1), jnp.asarray(new), jnp.float32(new_energy), jnp.asarray(g), jnp.asarray(h),
        max_iterations=20, energy_tol=1.0,
    )
    tout, tcont = topt.lm_update(
        tstate, 1, torch.from_numpy(new), torch.tensor(new_energy), torch.from_numpy(g), torch.from_numpy(h),
        max_iterations=20, energy_tol=1.0,
    )
    assert bool(tcont) == bool(jcont)
    np.testing.assert_array_equal(tout.model.numpy(), np.asarray(jout.model))
    np.testing.assert_allclose(float(tout.lm_coef), float(jout.lm_coef), rtol=1e-7)
    np.testing.assert_array_equal(np.isnan(float(tout.energy)), np.isnan(float(jout.energy)))
    if np.isnan(new_energy):
        assert tout.model.tolist() == new.tolist() and not bool(tcont)
