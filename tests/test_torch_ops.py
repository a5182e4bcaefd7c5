"""Parity of the port's image ops, camera, candidates and inverse depth with
the JAX package, on the same numpy inputs.

Tolerances: bit-equality for the pyramid, the f32 gradients, the
coarse-to-fine masks and the inverse-depth states; ``rtol=1e-6`` for float
values computed by more than one rounding (inverse depth, bilinear values,
camera maps), with ``atol=1e-4`` px on warped coordinates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.core import camera as jcam
from visual_odometry_rs_tpu.core import inverse_depth as jid
from visual_odometry_rs_tpu.core.candidates import coarse_to_fine as jc2f
from visual_odometry_rs_tpu.math import se3 as jse3
from visual_odometry_rs_tpu.ops import gradient as jgrad
from visual_odometry_rs_tpu.ops import interp as jinterp
from visual_odometry_rs_tpu.ops import pyramid as jpyr
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.core import camera as tcam
from visual_odometry_rs_tpu_torch.core import inverse_depth as tid
from visual_odometry_rs_tpu_torch.core.candidates import coarse_to_fine as tc2f
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.ops import gradient as tgrad
from visual_odometry_rs_tpu_torch.ops import interp as tinterp
from visual_odometry_rs_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(1)

# (120, 160) is the tracker-test size; (61, 83) has odd rows and columns at
# every level, which exercises the dropped row/col and the zero padding
SHAPES = [(120, 160), (61, 83)]


def _image(shape, seed, levels=256):
    rng = np.random.default_rng(seed)
    # a coarse quantization makes ties in the 2x2 gradient blocks common
    return (rng.integers(0, levels, size=shape) * (256 // levels)).astype(np.uint8)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# the JAX references run under jit: one compilation per shape instead of one
# per eager op
@jax.jit
def _jax_grads(img):
    jp = jpyr.mean_pyramid(3, img)
    return [jgrad.centered_f32(jp[0])] + jgrad.gradients_xy_f32(jp)


@jax.jit
def _jax_select(img):
    return jc2f.select(7, [jgrad.squared_norm_f32(*g) for g in _jax_grads(img)])


@pytest.mark.parametrize("shape", SHAPES)
def test_mean_pyramid_bit_equal(shape):
    img = _image(shape, 0)
    ref = jax.jit(lambda x: jpyr.mean_pyramid(4, x))(jnp.asarray(img))
    out = tpyr.mean_pyramid(4, torch.from_numpy(img))
    assert len(out) == len(ref)
    for r, o in zip(ref, out):
        assert o.dtype == torch.uint8
        np.testing.assert_array_equal(_np(o), np.asarray(r))


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_f32_bit_equal(shape):
    img = _image(shape, 1)
    ref = _jax_grads(jnp.asarray(img))
    tp = tpyr.mean_pyramid(3, torch.from_numpy(img))
    out = [tgrad.centered_f32(tp[0])] + tgrad.gradients_xy_f32(tp)
    assert len(out) == len(ref)
    for (rx, ry), (ox, oy) in zip(ref, out):
        np.testing.assert_array_equal(_np(ox), np.asarray(rx))
        np.testing.assert_array_equal(_np(oy), np.asarray(ry))
        np.testing.assert_array_equal(_np(tgrad.squared_norm_f32(ox, oy)), np.asarray(rx * rx + ry * ry))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("levels", [256, 8])
def test_coarse_to_fine_masks_bit_equal(shape, levels):
    img = _image(shape, 2, levels)
    tp = tpyr.mean_pyramid(3, torch.from_numpy(img))
    tg = [tgrad.centered_f32(tp[0])] + tgrad.gradients_xy_f32(tp)
    ref = _jax_select(jnp.asarray(img))
    out = tc2f.select(7, [tgrad.squared_norm_f32(*g) for g in tg])
    assert len(out) == len(ref)
    assert bool(out[0].all())  # the coarsest level is all-true
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(_np(o), np.asarray(r))


@pytest.mark.parametrize("shape", SHAPES)
def test_inverse_depth_pyramid(shape):
    rng = np.random.default_rng(3)
    depth = rng.integers(2000, 30000, size=shape).astype(np.uint16)
    depth[rng.random(shape) < 0.3] = 0  # unknown pixels
    mask = rng.random(shape) < 0.5
    ref = jax.jit(lambda d, m: jid.pyramid(jid.masked(jid.from_depth(5000.0, d, 1e-4), m), 4))(
        jnp.asarray(depth), jnp.asarray(mask)
    )
    out = tid.pyramid(
        tid.masked(
            tid.from_depth(5000.0, torch.from_numpy(depth.astype(np.int32)), 1e-4),
            torch.from_numpy(mask),
        ),
        4,
    )
    assert len(out) == len(ref)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(_np(o.state), np.asarray(r.state))
        np.testing.assert_allclose(_np(o.idepth), np.asarray(r.idepth), rtol=1e-6)
        np.testing.assert_allclose(_np(o.variance), np.asarray(r.variance), rtol=1e-6)


def test_bilinear_matches_gather():
    rng = np.random.default_rng(4)
    img = _image((30, 40), 5)
    # inside points, points just past the W-2 / H-2 edge, negative and
    # non-finite coordinates
    x = np.concatenate([rng.uniform(0, 37.99, 64), [37.0, 38.0, 38.5, -0.5, np.nan, np.inf]])
    y = np.concatenate([rng.uniform(0, 27.99, 64), [27.5, 27.5, 1.0, 3.0, 2.0, 2.0]])
    x, y = x.astype(np.float32), y.astype(np.float32)
    vr, mr = jax.jit(jinterp.bilinear_gather)(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    vo, mo = tinterp.bilinear(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(_np(mo), np.asarray(mr))
    assert not _np(mo)[-5:].any() and _np(mo)[-6]
    np.testing.assert_allclose(_np(vo), np.asarray(vr), rtol=1e-6)


def test_camera_multi_res_and_warp():
    k = jcam.Intrinsics.make(318.6, 255.3, 517.3, 516.5, 0.7)
    kt = interop.intrinsics_from_numpy(k)
    ref = jax.jit(lambda k: [jnp.stack(r) for r in jcam.multi_res(k, 4)])(k)
    for r, o in zip(ref, tcam.multi_res(kt, 4)):
        np.testing.assert_allclose(_np(o.vector()), np.asarray(r), rtol=1e-6)
    rng = np.random.default_rng(6)
    xs = rng.uniform(0, 640, 50).astype(np.float32)
    ys = rng.uniform(0, 480, 50).astype(np.float32)
    z = rng.uniform(0.1, 2.0, 50).astype(np.float32)
    xi = np.array([0.02, -0.01, 0.03, 0.01, -0.02, 0.005], np.float32)
    ur, vr = jax.jit(lambda xi, xs, ys, z, k: jcam.warp(jse3.exp(xi), xs, ys, z, k))(xi, xs, ys, z, k)
    uo, vo = tcam.warp(tse3.exp(torch.from_numpy(xi)), *map(torch.from_numpy, (xs, ys, z)), kt)
    # atol: a few f32 ulps of the ~500 px intermediates (jit fuses the
    # division and products of the projection differently)
    np.testing.assert_allclose(_np(uo), np.asarray(ur), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(_np(vo), np.asarray(vr), rtol=1e-6, atol=1e-4)
