"""The port's map export (``utils/pointcloud.py``) against the JAX package.

``tests/test_pointcloud.py``'s cloud, PLY and voxel tests by the port, and
the same numpy keyframes through both packages' ``keyframe_clouds``: the
same point count and intensities (equal), points within ``atol=2e-5`` m
(measured 2.4e-7 on points up to 2.6 m away: the f32 order of the
back-projection);
``voxel_downsample`` equal; each package reads the other's PLY file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.core.camera import Intrinsics as JIntrinsics
from visual_odometry_rs_tpu.math.pose import Pose as JPose
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.utils import pointcloud as jpc
from visual_odometry_rs_tpu_torch.core import camera as tcamera
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.dataset import tum_rgbd as ttum
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.utils import pointcloud as tpc

torch.set_num_threads(1)

KW = dict(height=120, width=160, nb_levels=3, candidate_cap=1024, depth_scale=ttum.DEPTH_SCALE)


@pytest.fixture(scope="module")
def scene():
    return tsyn.generate_sequence(nb_frames=2, height=120, width=160, seed=9), ttracker.TrackerConfig(**KW)


def _cloud(scene, frames, poses):
    seq, config = scene
    return tpc.keyframe_clouds(config, seq.intrinsics, [seq.depths[f] for f in frames],
                               [seq.grays[f] for f in frames], poses, device="cpu")


def test_clouds_match_jax(scene):
    seq, _ = scene
    c2w = tse3.exp(torch.tensor([0.3, -0.1, 0.2, 0.1, -0.2, 0.15]))
    poses = [tpose.identity(), c2w]
    pts, inten = _cloud(scene, [0, 1], poses)
    ref_pts, ref_int = jpc.keyframe_clouds(
        jtracker.TrackerConfig(**KW, interp_method="gather"),
        JIntrinsics(*(jnp.asarray(v.numpy()) for v in seq.intrinsics)), [seq.depths[0], seq.depths[1]],
        [seq.grays[0], seq.grays[1]], [JPose(jnp.asarray(p.q.numpy()), jnp.asarray(p.t.numpy())) for p in poses],
    )
    assert pts.dtype == np.float32 and inten.dtype == np.uint8
    assert len(pts) == len(ref_pts) > 100
    np.testing.assert_array_equal(inten, ref_int)
    np.testing.assert_allclose(pts, ref_pts, atol=2e-5)


def test_cloud_points_lie_on_depth_surface(scene):
    seq, _ = scene
    pts, inten = _cloud(scene, [0], [tpose.identity()])
    assert len(pts) > 50 and np.isfinite(pts).all()
    proj = tcamera.project(seq.intrinsics, torch.from_numpy(pts)).numpy()
    u, v = proj[:, 0] / proj[:, 2], proj[:, 1] / proj[:, 2]
    ui, vi = np.rint(u).astype(int), np.rint(v).astype(int)
    np.testing.assert_allclose(u, ui, atol=1e-3)
    np.testing.assert_allclose(v, vi, atol=1e-3)
    depth_m = seq.depths[0][vi, ui].astype(np.float64) / ttum.DEPTH_SCALE
    np.testing.assert_allclose(pts[:, 2], depth_m, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(inten, seq.grays[0][vi, ui])


def test_cloud_pose_is_rigid_transform(scene):
    c2w = tse3.exp(torch.tensor([0.3, -0.1, 0.2, 0.1, -0.2, 0.15]))
    pts_id, _ = _cloud(scene, [0], [tpose.identity()])
    pts_tf, _ = _cloud(scene, [0], [c2w])
    np.testing.assert_allclose(pts_tf, tpose.apply(c2w, torch.from_numpy(pts_id)).numpy(), atol=1e-4)


def test_multi_keyframe_concatenation(scene, monkeypatch):
    seq, _ = scene
    pts1, int1 = _cloud(scene, [0], [tpose.identity()])
    monkeypatch.setattr(tpc, "CHUNK", 1)  # one keyframe a batch: the same cloud
    pts2, int2 = _cloud(scene, [0, 1, 0], [tpose.identity(), seq.poses[1], tpose.identity()])
    np.testing.assert_allclose(pts2[: len(pts1)], pts1, atol=1e-5)
    np.testing.assert_array_equal(int2[: len(int1)], int1)
    np.testing.assert_array_equal(pts2[-len(pts1):], pts1)
    assert len(pts2) > 2 * len(pts1)


def test_ply_roundtrip_across_packages(tmp_path):
    pts = np.array([[0.1, -0.2, 1.5], [2.0, 0.0, 3.25]], np.float32)
    inten = np.array([0, 255], np.uint8)
    for writer, reader in ((tpc, tpc), (tpc, jpc), (jpc, tpc)):
        path = str(tmp_path / "map.ply")
        writer.write_ply(path, pts, inten)
        rpts, rint = reader.read_ply(path)
        np.testing.assert_allclose(rpts, pts, atol=1e-5)
        np.testing.assert_array_equal(rint, inten)
    with open(path) as f:
        text = f.read()
    jpc.write_ply(path, pts, inten)
    with open(path) as f:
        assert f.read() == text  # byte-equal files


def test_voxel_downsample_matches():
    pts = np.array([[0.01, 0.01, 0.01], [0.04, 0.02, 0.03], [0.11, 0.0, 0.0], [-0.01, 0.0, 0.0]], np.float32)
    inten = np.array([10, 20, 40, 80], np.uint8)
    out_p, out_i = tpc.voxel_downsample(pts, inten, 0.1)
    assert out_p.shape == (3, 3)
    merged = np.isclose(out_p, [[0.025, 0.015, 0.02]], atol=1e-6).all(axis=1)
    assert merged.sum() == 1 and out_i[merged][0] == 15
    same_p, same_i = tpc.voxel_downsample(pts, inten, 0.0)
    np.testing.assert_array_equal(same_p, pts)
    empty_p, empty_i = tpc.voxel_downsample(np.zeros((0, 3), np.float32), np.zeros((0,), np.uint8), 0.1)
    assert len(empty_p) == 0 and len(empty_i) == 0
    rng = np.random.default_rng(0)
    cloud = rng.normal(size=(500, 3)).astype(np.float32)
    values = rng.integers(0, 256, 500).astype(np.uint8)
    for voxel in (0.1, 0.5):
        for a, b in zip(tpc.voxel_downsample(cloud, values, voxel), jpc.voxel_downsample(cloud, values, voxel)):
            np.testing.assert_array_equal(a, b)
