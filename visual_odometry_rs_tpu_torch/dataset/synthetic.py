"""Synthetic RGB-D sequences with exact ground truth (numpy and torch only).

The port of ``visual_odometry_rs_tpu/dataset/synthetic.py``: a slanted
textured plane ``z = z0 + a x + b y`` rendered analytically for a known
camera trajectory, depth encoded u16 at the TUM scale (5000 = 1 m).  The
trajectory is composed in f32 with the port's se3/pose functions, so the
same arguments give the same sequence as the JAX module.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math import se3
from ..math.pose import Pose
from ..utils.types import Float


class SyntheticSequence(NamedTuple):
    grays: np.ndarray  # (F, H, W) u8
    depths: np.ndarray  # (F, H, W) u16
    poses: List[Pose]  # camera-to-world, frame 0 = identity (CPU tensors)
    timestamps: np.ndarray  # (F,) f64
    intrinsics: Intrinsics


def _texture(x: np.ndarray, y: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.zeros_like(x)
    for _ in range(10):
        fx, fy = rng.uniform(0.3, 6.0, 2)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.3, 1.0)
        img += amp * np.sin(2 * np.pi * (fx * x + fy * y) + phase)
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def render_frame(
    intrinsics: Intrinsics,
    pose_c2w: Tuple[np.ndarray, np.ndarray],
    height: int,
    width: int,
    plane: Tuple[float, float, float] = (0.08, -0.05, 2.0),
    texture_seed: int = 0,
    depth_scale: float = 5000.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render (gray u8, depth u16) of the plane for a camera-to-world pose."""
    q, t = pose_c2w
    R = _quat_to_matrix(np.asarray(q, np.float64))
    t = np.asarray(t, np.float64)
    a, b, z0 = plane
    n = np.array([-a, -b, 1.0])

    cx, cy = float(intrinsics.cx), float(intrinsics.cy)
    fx, fy = float(intrinsics.fx), float(intrinsics.fy)
    jj, ii = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    dir_cam = np.stack([(jj - cx) / fx, (ii - cy) / fy, np.ones_like(jj)], axis=-1)
    dir_world = dir_cam @ R.T
    denom = dir_world @ n
    lam = (z0 - n @ t) / denom  # ray parameter == camera-frame depth
    pts = t[None, None, :] + lam[..., None] * dir_world

    visible = (lam > 0.1) & (lam < 10.0)
    gray = _texture(pts[..., 0], pts[..., 1], texture_seed)
    gray = np.where(visible, gray, 0).astype(np.uint8)
    depth = np.where(visible, np.round(lam * depth_scale), 0)
    depth = np.clip(depth, 0, 65535).astype(np.uint16)
    return gray, depth


def generate_sequence(
    nb_frames: int = 8,
    height: int = 240,
    width: int = 320,
    intrinsics: Intrinsics | None = None,
    motion_scale: float = 0.01,
    rot_scale: float = 0.004,
    seed: int = 0,
    plane: Tuple[float, float, float] = (0.08, -0.05, 2.0),
    twist_per_frame=None,
) -> SyntheticSequence:
    """A camera trajectory over the textured plane: a random walk of
    ``motion_scale`` meters / ``rot_scale`` radians per frame, or the given
    ``twist_per_frame`` (one (6,) twist, or an (F-1, 6) schedule)."""
    if intrinsics is None:
        from . import tum_rgbd

        intrinsics = tum_rgbd.scaled_intrinsics("fr1", height, width)

    rng = np.random.default_rng(seed)
    poses = [pose_mod.identity()]
    grays, depths = [], []
    for f in range(nb_frames):
        if f > 0:
            if twist_per_frame is not None:
                xi = np.asarray(twist_per_frame, np.float32)
                if xi.ndim == 2:
                    xi = xi[f - 1]
            else:
                xi = np.concatenate(
                    [motion_scale * rng.normal(size=3), rot_scale * rng.normal(size=3)]
                ).astype(np.float32)
            step = se3.exp(torch.as_tensor(xi, dtype=Float))
            poses.append(pose_mod.compose(poses[-1], step))
        q = poses[-1].q.numpy().astype(np.float64)
        t = poses[-1].t.numpy().astype(np.float64)
        gray, depth = render_frame(intrinsics, (q, t), height, width, plane=plane, texture_seed=seed)
        grays.append(gray)
        depths.append(depth)

    return SyntheticSequence(
        grays=np.stack(grays),
        depths=np.stack(depths),
        poses=poses,
        timestamps=np.arange(nb_frames, dtype=np.float64) / 30.0,
        intrinsics=intrinsics,
    )


def smooth_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A smooth u8 test image, a mixture of 8 low-frequency sinusoids: the
    JAX package's ``tests/test_affine2d.py::smooth_image``, the same draws."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w))
    for _ in range(8):
        fx, fy = rng.uniform(0.5, 3.0, 2)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.3, 1.0)
        img += amp * np.sin(2 * np.pi * (fx * xx / w + fy * yy / h) + phase)
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)
