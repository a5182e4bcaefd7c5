"""Parity of the port's image, camera and math API and its utilities with
the JAX package, on the same numpy inputs from a seed.

- ``se3.hat``/``vee``/``linear_velocity``/``angular_velocity``,
  ``so3.vee``, ``pose.matrix``: bit-equal (products and copies of the same
  f32 values, no sum).  ``pose.from_euler_angles``: ``rtol=1e-6,
  atol=1e-7`` (torch's and XLA's sin/cos differ by an ulp; measured
  6.0e-8).
- ``camera.matrix`` bit-equal; ``world_to_camera``, ``camera_to_world``,
  ``camera_project``, ``camera_back_project`` and ``camera_multi_res``:
  ``rtol=1e-6, atol=1e-5`` (f32 sums of a few terms that XLA fuses into
  multiply-adds; measured at most 7.2e-7 relative, 1.2e-4 absolute on
  homogeneous pixels of a few thousand).
- The pyramid combinators, the integer gradients (``centered``,
  ``squared_norm``, ``bloc_*``, ``gradients_xy``,
  ``gradients_squared_norm``), ``to_depth``, the TUM presets, ``helper``,
  ``colormap``, ``view`` and ``image_interop``: bit-equal, dtypes included.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.core import camera as jcam
from visual_odometry_rs_tpu.core import inverse_depth as jidp
from visual_odometry_rs_tpu.dataset import tum_rgbd as jtum
from visual_odometry_rs_tpu.math import pose as jpose
from visual_odometry_rs_tpu.math import se3 as jse3
from visual_odometry_rs_tpu.math import so3 as jso3
from visual_odometry_rs_tpu.ops import gradient as jgrad
from visual_odometry_rs_tpu.ops import pyramid as jpyr
from visual_odometry_rs_tpu.utils import colormap as jcmap
from visual_odometry_rs_tpu.utils import helper as jhelper
from visual_odometry_rs_tpu.utils import interop as jinterop
from visual_odometry_rs_tpu.utils import view as jview
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.core import camera as tcam
from visual_odometry_rs_tpu_torch.core import inverse_depth as tidp
from visual_odometry_rs_tpu_torch.dataset import tum_rgbd as ttum
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.math import so3 as tso3
from visual_odometry_rs_tpu_torch.ops import gradient as tgrad
from visual_odometry_rs_tpu_torch.ops import pyramid as tpyr
from visual_odometry_rs_tpu_torch.utils import colormap as tcmap
from visual_odometry_rs_tpu_torch.utils import helper as thelper
from visual_odometry_rs_tpu_torch.utils import image_interop as tinterop
from visual_odometry_rs_tpu_torch.utils import view as tview

torch.set_num_threads(1)


def _equal(out, ref):
    """Bit-equal values and the same dtype."""
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.dtype == ref.dtype, (out.dtype, ref.dtype)
    np.testing.assert_array_equal(out, ref)


def _image(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _poses(seed, n=16):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(size=(n, 3)), 0.5 * rng.normal(size=(n, 3))], axis=1).astype(np.float32)
    p = jse3.exp(jnp.asarray(xi))
    return jpose.Pose(np.asarray(p.q), np.asarray(p.t))


# --- math ---------------------------------------------------------------------


def test_se3_hat_vee_and_velocities_bit_equal():
    xi = np.random.default_rng(0).normal(size=(5, 7, 6)).astype(np.float32)
    _equal(tse3.hat(torch.from_numpy(xi)), jse3.hat(jnp.asarray(xi)))
    _equal(tse3.vee(tse3.hat(torch.from_numpy(xi))), xi)
    _equal(tse3.linear_velocity(torch.from_numpy(xi)), jse3.linear_velocity(jnp.asarray(xi)))
    _equal(tse3.angular_velocity(torch.from_numpy(xi)), jse3.angular_velocity(jnp.asarray(xi)))
    m = np.random.default_rng(1).normal(size=(4, 4, 4)).astype(np.float32)
    _equal(tse3.vee(torch.from_numpy(m)), jse3.vee(jnp.asarray(m)))
    _equal(tso3.vee(torch.from_numpy(m[:, :3, :3])), jso3.vee(jnp.asarray(m[:, :3, :3])))


def test_pose_matrix_bit_equal_and_euler_angles():
    p = _poses(2)
    _equal(tpose.matrix(interop.pose_from_numpy(p)), jpose.matrix(jpose.Pose(jnp.asarray(p.q), jnp.asarray(p.t))))
    angles = np.random.default_rng(3).uniform(-np.pi, np.pi, size=(3, 10)).astype(np.float32)
    out = tpose.from_euler_angles(*(torch.from_numpy(a) for a in angles))
    ref = jpose.from_euler_angles(*angles)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    out0 = tpose.from_euler_angles(0.1, -0.2, 0.3)
    assert out0.shape == (4,)
    np.testing.assert_allclose(out0.numpy(), np.asarray(jpose.from_euler_angles(0.1, -0.2, 0.3)), rtol=1e-6, atol=1e-7)


# --- camera -------------------------------------------------------------------


def test_camera_matrix_and_extrinsics_match():
    k = jcam.Intrinsics.make(320.5, 240.25, 520.0, 515.0, 0.5)
    kt = interop.intrinsics_from_numpy(k)
    _equal(tcam.matrix(kt), jcam.matrix(k))
    p = _poses(4)
    pt = interop.pose_from_numpy(p)
    pj = jpose.Pose(jnp.asarray(p.q), jnp.asarray(p.t))
    rng = np.random.default_rng(5)
    x = np.stack([rng.uniform(-1, 1, 16), rng.uniform(-1, 1, 16), rng.uniform(1.5, 4, 16)], 1).astype(np.float32)
    pix = rng.uniform(0, 600, (16, 2)).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, 16).astype(np.float32)
    camj, camt = jcam.Camera(k, pj), tcam.Camera(kt, pt)
    close = dict(rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tcam.world_to_camera(pt, torch.from_numpy(x)).numpy(),
                               np.asarray(jcam.world_to_camera(pj, x)), **close)
    np.testing.assert_allclose(tcam.camera_to_world(pt, torch.from_numpy(x)).numpy(),
                               np.asarray(jcam.camera_to_world(pj, x)), **close)
    np.testing.assert_allclose(tcam.camera_project(camt, torch.from_numpy(x)).numpy(),
                               np.asarray(jcam.camera_project(camj, x)), **close)
    np.testing.assert_allclose(tcam.camera_back_project(camt, torch.from_numpy(pix), torch.from_numpy(depth)).numpy(),
                               np.asarray(jcam.camera_back_project(camj, pix, depth)), **close)
    # a round trip: project, dehomogenize, back-project at the point's depth
    uvz = tcam.camera_project(camt, torch.from_numpy(x))
    z = tcam.world_to_camera(pt, torch.from_numpy(x))[:, 2]
    back = tcam.camera_back_project(camt, uvz[:, :2] / uvz[:, 2:3], z)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)
    levels_t, levels_j = tcam.camera_multi_res(camt, 4), jcam.camera_multi_res(camj, 4)
    assert len(levels_t) == len(levels_j) == 4
    for ct, cj in zip(levels_t, levels_j):
        for a, b in zip(ct.intrinsics, cj.intrinsics):
            _equal(a, b)
        assert ct.extrinsics is pt


# --- pyramid and gradients ----------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 64), (37, 53), (1, 5)])
def test_pyramid_combinators_bit_equal(shape):
    img = _image(shape, seed=shape[0])
    _equal(tpyr.mean_2x2_u8(*tpyr.block_2x2(torch.from_numpy(img))), jpyr.mean_2x2_u8(*jpyr.block_2x2(jnp.asarray(img))))
    halved_t = tpyr.halve(torch.from_numpy(img), tpyr.mean_2x2_u8)
    halved_j = jpyr.halve(jnp.asarray(img), jpyr.mean_2x2_u8)
    assert (halved_t is None) == (halved_j is None)
    seq_t = tpyr.sequence(torch.from_numpy(img), lambda m: tpyr.halve(m, tpyr.mean_2x2_u8))
    seq_j = jpyr.sequence(jnp.asarray(img), lambda m: jpyr.halve(m, jpyr.mean_2x2_u8))
    assert len(seq_t) == len(seq_j) == jpyr.num_levels(*shape, 99) == tpyr.num_levels(*shape, 99)
    for a, b in zip(seq_t, seq_j):
        _equal(a, b)
    lim_t = tpyr.limited_sequence(3, torch.from_numpy(img), lambda m: tpyr.halve(m, tpyr.mean_2x2_u8))
    lim_j = jpyr.limited_sequence(3, jnp.asarray(img), lambda m: jpyr.halve(m, jpyr.mean_2x2_u8))
    assert len(lim_t) == len(lim_j) == tpyr.num_levels(*shape, 3)
    for a, b in zip(lim_t, lim_j):
        _equal(a, b)


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_integer_gradients_bit_equal(shape):
    img = _image(shape, seed=7)
    gx_t, gy_t = tgrad.centered(torch.from_numpy(img))
    gx_j, gy_j = jgrad.centered(jnp.asarray(img))
    _equal(gx_t, gx_j)
    _equal(gy_t, gy_j)
    _equal(tgrad.squared_norm(gx_t, gy_t), jgrad.squared_norm(gx_j, gy_j))
    corners_t = tpyr.block_2x2(torch.from_numpy(img))
    corners_j = jpyr.block_2x2(jnp.asarray(img))
    _equal(tgrad.bloc_x(*corners_t), jgrad.bloc_x(*corners_j))
    _equal(tgrad.bloc_y(*corners_t), jgrad.bloc_y(*corners_j))
    _equal(tgrad.bloc_squared_norm(*corners_t), jgrad.bloc_squared_norm(*corners_j))
    pyr_t = tpyr.mean_pyramid(4, torch.from_numpy(img))
    pyr_j = jpyr.mean_pyramid(4, jnp.asarray(img))
    for (a, b), (c, d) in zip(tgrad.gradients_xy(pyr_t), jgrad.gradients_xy(pyr_j)):
        _equal(a, c)
        _equal(b, d)
    for a, b in zip(tgrad.gradients_squared_norm(pyr_t), jgrad.gradients_squared_norm(pyr_j)):
        _equal(a, b)
    # Rust's truncating division, negative values included
    x = np.arange(-9, 10, dtype=np.int16)
    _equal(tgrad._trunc_div(torch.from_numpy(x), 2), jgrad._trunc_div(jnp.asarray(x), 2))


def test_squared_norm_wraps_like_the_reference():
    """``as u16`` of an i32 square sum wraps modulo 2^16 in both packages."""
    gx = np.array([[200, -255, 181]], np.int16)
    gy = np.array([[200, 255, 181]], np.int16)
    _equal(tgrad.squared_norm(torch.from_numpy(gx), torch.from_numpy(gy)),
           jgrad.squared_norm(jnp.asarray(gx), jnp.asarray(gy)))


# --- inverse depth and dataset presets ----------------------------------------


def test_to_depth_bit_equal():
    rng = np.random.default_rng(8)
    depth = rng.integers(0, 20000, (24, 32)).astype(np.uint16)
    depth[0, :4] = [1, 2, 3, 65535]
    mj = jidp.from_depth(5000.0, jnp.asarray(depth), 1e-4)
    mj = mj._replace(state=mj.state.at[1, :3].set(jidp.DISCARDED))
    mt = tidp.InverseDepthMap(*(torch.from_numpy(np.array(x)) for x in mj))
    _equal(tidp.to_depth(5000.0, mt), jidp.to_depth(5000.0, mj))


def test_tum_presets_bit_equal():
    for name in ("intrinsics_fr1", "intrinsics_fr2", "intrinsics_fr3", "intrinsics_icl_nuim"):
        for a, b in zip(getattr(ttum, name)(), getattr(jtum, name)()):
            _equal(a, b)


# --- utilities ------------------------------------------------------------------


def test_helper_bit_equal():
    mat = np.arange(12, dtype=np.float32).reshape(3, 4)
    mask = mat % 3 == 0
    _equal(thelper.zip_mask_map(torch.from_numpy(mat), torch.from_numpy(mask), -1.0, lambda m: m * 2.0),
           jhelper.zip_mask_map(jnp.asarray(mat), jnp.asarray(mask), -1.0, lambda m: m * 2.0))
    for a, b in ((17, 5), (-17, 5), (6, 3)):
        assert thelper.div_rem(a, b) == jhelper.div_rem(a, b)


def test_viridis_table_and_maps_bit_equal():
    _equal(tcmap.viridis_table(), jcmap.viridis_table())
    t = tcmap.viridis_table()
    assert t.shape == (256, 3) and t.dtype == np.uint8
    assert t[0, 2] > t[0, 0] and t[255, 0] > 200 and t[255, 1] > 200
    v = _image((9, 11), seed=9)
    _equal(tcmap.viridis_u8(v), jcmap.viridis_u8(v))
    f = np.random.default_rng(10).normal(size=(9, 11))
    _equal(tcmap.viridis_float(f, -1.0, 1.5), jcmap.viridis_float(f, -1.0, 1.5))


def test_view_bit_equal(tmp_path):
    img = np.full((4, 4), 100, np.uint8)
    mask = np.zeros((4, 4), bool)
    mask[1, 2] = True
    rgb = tview.candidates_on_image(torch.from_numpy(img), torch.from_numpy(mask))
    _equal(rgb, jview.candidates_on_image(img, mask))
    np.testing.assert_array_equal(rgb[1, 2], [255, 0, 0])
    np.testing.assert_array_equal(rgb[0, 0], [100, 100, 100])
    _equal(tview.gray_to_rgb(img), jview.gray_to_rgb(img))
    state = np.array([[2, 2], [0, 1]], np.uint8)
    idepth = np.array([[1.0, 2.0], [0.0, 0.0]], np.float32)
    var = np.array([[1e-4, 1e-4], [0.0, 0.0]], np.float32)
    mt = tidp.InverseDepthMap(torch.from_numpy(idepth), torch.from_numpy(var), torch.from_numpy(state))
    out = tview.idepth_image(mt)
    _equal(out, jview.idepth_image(jidp.InverseDepthMap(jnp.asarray(idepth), jnp.asarray(var), jnp.asarray(state))))
    np.testing.assert_array_equal(out[1, 0], [0, 0, 0])
    np.testing.assert_array_equal(out[1, 1], [255, 0, 0])
    assert (out[0, 0] != out[0, 1]).any()
    big = np.random.default_rng(11).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    tview.save_png(str(tmp_path / "port.png"), big)
    jview.save_png(str(tmp_path / "jax.png"), big)
    from PIL import Image

    port_img = Image.open(tmp_path / "port.png")
    assert port_img.mode == "RGB" and port_img.size == (5, 6)
    _equal(np.asarray(port_img), np.asarray(Image.open(tmp_path / "jax.png")))


def test_image_interop_bit_equal():
    from PIL import Image

    rgb = np.random.default_rng(12).integers(0, 256, (7, 9, 3), dtype=np.uint8)
    rgba = np.concatenate([rgb, np.full((7, 9, 1), 255, np.uint8)], axis=-1)
    for arr in (rgb, rgba, rgb[..., 0]):
        _equal(tinterop.matrix_from_image(arr), jinterop.matrix_from_image(arr))
    _equal(tinterop.matrix_from_image(Image.fromarray(rgb)), jinterop.matrix_from_image(Image.fromarray(rgb)))
    _equal(tinterop.image_from_matrix(rgb[..., 1]), np.asarray(jinterop.image_from_matrix(rgb[..., 1])))
    _equal(tinterop.rgb_image_from_matrix(rgb), np.asarray(jinterop.rgb_image_from_matrix(rgb)))
    with pytest.raises(ValueError):
        tinterop.image_from_matrix(rgb)
    with pytest.raises(ValueError):
        tinterop.rgb_image_from_matrix(rgb[..., 0])


def test_write_png_rgb_reads_back(tmp_path):
    """``write_png`` writes (H, W, 3) u8 as colour type 2; PIL and the port's
    reader (the luma of it) read it back."""
    from PIL import Image

    rgb = np.random.default_rng(13).integers(0, 256, (5, 8, 3), dtype=np.uint8)
    path = str(tmp_path / "rgb.png")
    ttum.write_png(path, rgb)
    with open(path, "rb") as f:
        header = f.read(26)
    assert header[25] == 2  # colour type: RGB
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(open(path, "rb").read()))), rgb)
    with pytest.raises(ValueError):
        ttum.write_png(path, rgb.astype(np.uint16))
