"""Parity of the port's pyramidal affine alignment (``models/affine2d.py``)
with the JAX package's, and the port's mirror of ``tests/test_affine2d.py``.

Tolerances (the same numpy inputs from a seed in both packages):
- ``dataset.synthetic.smooth_image`` (the test image), ``random_template``,
  ``precompute_level``, ``warp_matrix``, ``warp_params``,
  ``affine_jacobians`` and ``default_nb_levels``: bit-equal (the same
  numpy draws; integer gradients times integer coordinates are exact in
  f32).
- One evaluation: the energy to ``rtol=1e-5`` and ``[H | g]`` to
  ``rtol=1e-5`` of their largest entry (the same terms summed in another
  order, full f32 matmuls on both sides; measured 1.8e-7 for the energy,
  3.3e-7 for g and 3.6e-6 for H).
- ``align`` at 128x160 (4 levels): the parameters within ``atol=1e-4`` of
  JAX's (measured 1.9e-6), neither failed; and within
  ``tests/test_affine2d.py``'s bounds of the ground truth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_affine2d import smooth_image

from visual_odometry_rs_tpu.models import affine2d as jaff
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.dataset import synthetic
from visual_odometry_rs_tpu_torch.models import affine2d as taff

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def aligned():
    """The 128x160 scene of ``test_align_recovers_ground_truth``, aligned by
    both packages (one JAX compile)."""
    img = smooth_image(128, 160, seed=1)
    template, affine_gt = jaff.random_template(img, seed=2)
    nb_levels = jaff.default_nb_levels(*img.shape)
    params_j, failed_j = jaff.align(jnp.asarray(template), jnp.asarray(img), nb_levels)
    params_t, failed_t = taff.align(torch.from_numpy(template), torch.from_numpy(img), nb_levels)
    return dict(img=img, template=template, affine_gt=affine_gt, nb_levels=nb_levels,
                params_j=np.asarray(params_j), failed_j=bool(failed_j), params_t=params_t, failed_t=failed_t)


def test_align_matches_jax(aligned):
    assert aligned["nb_levels"] == taff.default_nb_levels(128, 160) == 4
    assert not aligned["failed_t"] and not aligned["failed_j"]
    np.testing.assert_allclose(aligned["params_t"].numpy(), aligned["params_j"], rtol=0, atol=1e-4)


def test_align_recovers_ground_truth(aligned):
    w = taff.warp_matrix(aligned["params_t"]).numpy()[:2, :]
    np.testing.assert_allclose(w[:, :2], aligned["affine_gt"][:, :2], atol=5e-3)
    np.testing.assert_allclose(w[:, 2], aligned["affine_gt"][:, 2], atol=0.5)


def test_random_template_bit_equal(aligned):
    np.testing.assert_array_equal(synthetic.smooth_image(128, 160, seed=1), aligned["img"])
    template, affine = taff.random_template(aligned["img"], seed=2)
    np.testing.assert_array_equal(template, aligned["template"])
    np.testing.assert_array_equal(affine, aligned["affine_gt"])
    assert affine.dtype == np.float32 and template.dtype == np.uint8


def test_level_and_evaluation_match(aligned):
    """``precompute_level`` bit-equal, one evaluation within its tolerance."""
    t, i = aligned["template"][::2, ::2].copy(), aligned["img"][::2, ::2].copy()
    lvl_j = jaff.precompute_level(jnp.asarray(t), jnp.asarray(i))
    lvl_t = taff.precompute_level(torch.from_numpy(t), torch.from_numpy(i))
    for a, b in zip(lvl_t, interop.affine_level_from_numpy(jaff.LevelData(*(np.asarray(x) for x in lvl_j)))):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    back = interop.affine_level_to_numpy(lvl_t)
    np.testing.assert_array_equal(back.jacobians, np.asarray(lvl_j.jacobians))
    params = np.array([0.05, -0.02, 0.03, 0.01, 2.5, -1.5], np.float32)
    e_j, g_j, h_j = jaff._eval_full(lvl_j, jnp.asarray(params))
    e_t, g_t, h_t = taff._eval_full(lvl_t, torch.from_numpy(params))
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-5)
    for out, ref in ((g_t, g_j), (h_t, h_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_solve_level_singular_step_fails_without_raising():
    """A step whose warp matrix is singular gives NaN, as JAX's ``inv``
    does; the level stops with ``failed`` and keeps its start."""
    img = smooth_image(32, 40, seed=4)
    lvl = taff.precompute_level(torch.from_numpy(img), torch.from_numpy(img))
    inv = taff._inverse(torch.zeros(3, 3))
    assert torch.isnan(inv).all()
    res = taff.solve_level(lvl._replace(jacobians=torch.zeros_like(lvl.jacobians)), torch.zeros(6))
    assert res.failed and res.nb_iter == 1
    assert torch.equal(res.state.model, torch.zeros(6))


def test_align_identity():
    img = smooth_image(64, 64, seed=3)
    params, failed = taff.align(torch.from_numpy(img), torch.from_numpy(img), 3)
    assert not failed
    np.testing.assert_allclose(params.numpy(), np.zeros(6), atol=1e-2)


def test_warp_matrix_roundtrip():
    p = torch.tensor([0.1, -0.2, 0.05, 0.02, 3.0, -1.5])
    np.testing.assert_allclose(taff.warp_params(taff.warp_matrix(p)).numpy(), p.numpy(), atol=1e-6)
    np.testing.assert_array_equal(taff.warp_matrix(p).numpy(), np.asarray(jaff.warp_matrix(jnp.asarray(p.numpy()))))


def test_default_nb_levels():
    assert taff.default_nb_levels(480, 640) == round(1 + np.log(480 * 640 / 200) / np.log(4))
    assert taff.default_nb_levels(10, 10) >= 1
    for h, w in ((480, 640), (240, 320), (128, 160), (10, 10), (20, 40), (1, 1)):
        assert taff.default_nb_levels(h, w) == jaff.default_nb_levels(h, w)


def test_jacobians_shape_and_values():
    gx = torch.full((4, 5), 2, dtype=torch.int16)
    gy = torch.full((4, 5), 3, dtype=torch.int16)
    jac = taff.affine_jacobians(gx, gy)
    assert jac.shape == (20, 6)
    np.testing.assert_array_equal(jac[7].numpy(), [2 * 2, 2 * 3, 1 * 2, 1 * 3, 2, 3])
    np.testing.assert_array_equal(jac.numpy(), np.asarray(jaff.affine_jacobians(jnp.asarray(gx.numpy()),
                                                                               jnp.asarray(gy.numpy()))))
