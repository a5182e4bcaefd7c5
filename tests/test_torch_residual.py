"""The fused LM evaluation (kernel K1): the port's plain twin against the JAX
package.  The CUDA kernel is held against the twin in
``tests/test_torch_kernel_cuda.py``.

The twin is held against both JAX paths on the same keyframe state (carried
across with ``interop``): ``_eval_full(..., "gather")`` and the Pallas kernel
``fused_residual_reduce(..., interpret=True)``, called as
``tests/test_pallas_kernel.py`` calls it.  Tolerances, as there: energy
``rtol=1e-5``; g and H ``rtol=1e-4, atol=1e-5`` after scaling by their max
(the sums are reassociated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.dataset import synthetic
from visual_odometry_rs_tpu.math import se3 as jse3
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.ops import pyramid as jpyr
from visual_odometry_rs_tpu.ops.pallas import residual_kernel as rk
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.ops import residual

torch.set_num_threads(1)

XI = np.array([0.005, -0.003, 0.002, 0.001, 0.002, -0.001], np.float32)


@pytest.fixture(scope="module")
def setup():
    seq = synthetic.generate_sequence(nb_frames=2, height=120, width=160, seed=0)
    config = jtracker.TrackerConfig(height=120, width=160, nb_levels=3, candidate_cap=1024)
    kf = jax.jit(lambda d, p: jtracker.precompute_keyframe(config, seq.intrinsics, d, p))(
        jnp.asarray(seq.depths[0]), jpyr.mean_pyramid(3, jnp.asarray(seq.grays[0]))
    )
    pyr1 = jpyr.mean_pyramid(3, jnp.asarray(seq.grays[1]))
    kf_np = jax.tree_util.tree_map(np.asarray, kf)
    return kf, pyr1, interop.keyframe_from_numpy(kf_np), [torch.from_numpy(np.array(p)) for p in pyr1]


def _cases(setup, lvl, case):
    """(JAX obs, JAX image, port obs, port image, xi) for one case."""
    kf, pyr1, tkf, tpyr = setup
    jobs, tobs = kf.levels[lvl], tkf.levels[lvl]
    xi = XI
    if case == "ragged":  # a count that is not a multiple of the 256 tile
        n = 1000
        jobs = jobs._replace(**{f: getattr(jobs, f)[:n] for f in ("xs", "ys", "idepth", "valid", "tmpl_vals", "jacobians")})
        tobs = tobs._replace(**{f: getattr(tobs, f)[:n] for f in ("xs", "ys", "idepth", "valid", "tmpl_vals", "jacobians")})
    elif case == "invalid":  # no valid candidate: energy is NaN in both
        jobs = jobs._replace(valid=jnp.zeros_like(jobs.valid))
        tobs = tobs._replace(valid=torch.zeros_like(tobs.valid))
    elif case == "outside":  # a large shift sends most points out of the domain
        xi = np.array([0.8, 0.4, 0.0, 0.0, 0.05, 0.0], np.float32)
    return jobs, pyr1[lvl], tobs, tpyr[lvl], xi


def _twin(tobs, img, xi):
    model = tse3.exp(torch.from_numpy(xi))
    params = torch.cat([model.q, model.t, tobs.intrinsics.vector()])
    return residual.residual_reduce_reference(
        img, tobs.xs, tobs.ys, tobs.idepth, tobs.tmpl_vals, tobs.valid, tobs.jacobians, params
    )


def _assert_matches(m, rsq, cnt, e_ref, g_ref, h_ref):
    e = float(rsq) / float(cnt) if float(cnt) else float("nan")
    if np.isnan(float(e_ref)):
        assert np.isnan(e) and float(cnt) == 0.0
        return
    np.testing.assert_allclose(e, float(e_ref), rtol=1e-5)
    g_ref, h_ref = np.asarray(g_ref), np.asarray(h_ref)
    sg = float(np.max(np.abs(g_ref))) + 1.0
    sh = float(np.max(np.abs(h_ref))) + 1.0
    np.testing.assert_allclose(m[:, 6].numpy() / sg, g_ref / sg, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(m[:, :6].numpy() / sh, h_ref / sh, rtol=1e-4, atol=1e-5)


CASES = [(0, "plain"), (1, "plain"), (2, "plain"), (0, "ragged"), (1, "invalid"), (0, "outside")]


@pytest.mark.parametrize("lvl,case", CASES)
def test_twin_matches_jax_eval_full(setup, lvl, case):
    jobs, jimg, tobs, timg, xi = _cases(setup, lvl, case)
    e_ref, g_ref, h_ref = jax.jit(lambda o, i, xi: jtracker._eval_full(o, i, jse3.exp(xi), "gather"))(
        jobs, jimg, jnp.asarray(xi)
    )
    m, rsq, cnt = _twin(tobs, timg, xi)
    if case == "outside":
        assert 0 < float(cnt) < 0.5 * float(tobs.valid.sum())
    _assert_matches(m, rsq, cnt, e_ref, g_ref, h_ref)


@pytest.mark.parametrize("lvl,case", CASES)
def test_eval_energy_matches_jax(setup, lvl, case):
    """The energy-only pass: inside mask equal, energy ``rtol=1e-5``, and the
    residuals within 1e-3 of the 0-255 intensity scale (the warped
    coordinates differ by ulps)."""
    jobs, jimg, tobs, timg, xi = _cases(setup, lvl, case)
    e_ref, r_ref, in_ref = jax.jit(lambda o, i, xi: jtracker._eval_energy(o, i, jse3.exp(xi), "gather"))(
        jobs, jimg, jnp.asarray(xi)
    )
    energy, r, inside = ttracker._eval_energy(tobs, timg, tse3.exp(torch.from_numpy(xi)))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(in_ref))
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=0, atol=1e-3)
    if case == "invalid":
        assert np.isnan(float(e_ref)) and np.isnan(float(energy))
    else:
        np.testing.assert_allclose(float(energy), float(e_ref), rtol=1e-5)


@pytest.mark.parametrize("lvl,case", [(1, "plain"), (0, "ragged"), (1, "invalid")])
def test_twin_matches_pallas_interpret(setup, lvl, case):
    jobs, jimg, tobs, timg, xi = _cases(setup, lvl, case)
    model = jse3.exp(jnp.asarray(xi))
    k = jobs.intrinsics
    m_ref, rsq_ref, cnt_ref = rk.fused_residual_reduce(
        jimg.astype(jnp.float32), jobs.xs, jobs.ys, jobs.idepth, jobs.tmpl_vals,
        jobs.valid, jobs.jacobians, model.q, model.t,
        jnp.stack([k.cx, k.cy, k.fx, k.fy, k.skew]), interpret=True,
    )
    m, rsq, cnt = _twin(tobs, timg, xi)
    assert float(cnt) == float(cnt_ref)
    _assert_matches(m, rsq, cnt, rsq_ref / cnt_ref, m_ref[:, 6], m_ref[:, :6])


def test_cpu_tensors_take_the_twin(setup):
    _, _, tobs, timg, xi = _cases(setup, 2, "plain")
    before = residual.residual_reduce.launches
    energy, grad, hess = ttracker._eval_full(tobs, timg, tse3.exp(torch.from_numpy(xi)))
    m, rsq, cnt = _twin(tobs, timg, xi)
    assert residual.residual_reduce.launches == before  # no kernel on the CPU
    assert torch.equal(grad, m[:, 6]) and torch.equal(hess, m[:, :6])
    assert torch.equal(energy, rsq / cnt)

