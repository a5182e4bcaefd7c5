"""Pinhole camera: intrinsics, projection, multi-resolution scaling.

The port of ``visual_odometry_rs_tpu/core/camera.py``: ``Intrinsics``
(principal point, focal, skew) and their ``matrix``, ``project`` /
``back_project`` (camera.rs:126-140), the ±0.5 principal-point shift of
each halving (camera.rs:115-123), the ``Camera`` = intrinsics + extrinsics
pairing with its world↔camera projections (camera.rs:18-77) and the
tracker's ``warp``.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..math import pose as _pose
from ..math.pose import Pose
from ..utils.types import Float


class Intrinsics(NamedTuple):
    """Pinhole intrinsics; each field is a 0-d f32 tensor."""

    cx: torch.Tensor
    cy: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    skew: torch.Tensor

    @staticmethod
    def make(cx, cy, fx, fy, skew=0.0, device="cpu") -> "Intrinsics":
        return Intrinsics(
            *(torch.as_tensor(v, dtype=Float, device=device) for v in (cx, cy, fx, fy, skew))
        )

    def to(self, device) -> "Intrinsics":
        return Intrinsics(*(v.to(device) for v in self))

    def vector(self) -> torch.Tensor:
        """``[cx, cy, fx, fy, skew]`` as one (5,) tensor."""
        return torch.stack(tuple(self))


def matrix(k: Intrinsics) -> torch.Tensor:
    """3x3 calibration matrix (camera.rs:96-102)."""
    z = torch.zeros_like(k.fx)
    o = torch.ones_like(k.fx)
    m = torch.stack([k.fx, k.skew, k.cx, z, k.fy, k.cy, z, z, o], dim=-1)
    return m.reshape(*k.fx.shape, 3, 3)


def half_res(k: Intrinsics) -> Intrinsics:
    """Intrinsics of the half-resolution camera (camera.rs:115-123): (0,0)
    is the center of the first pixel, hence the ±0.5 shift."""
    return Intrinsics(
        cx=(k.cx + 0.5) / 2.0 - 0.5,
        cy=(k.cy + 0.5) / 2.0 - 0.5,
        fx=0.5 * k.fx,
        fy=0.5 * k.fy,
        skew=k.skew,
    )


def multi_res(k: Intrinsics, n: int) -> List[Intrinsics]:
    """n levels of halved intrinsics (camera.rs:106-108)."""
    out = [k]
    for _ in range(1, n):
        out.append(half_res(out[-1]))
    return out


def project(k: Intrinsics, point: torch.Tensor) -> torch.Tensor:
    """Camera-frame point(s) (…,3) → homogeneous pixel (…,3) (camera.rs:126-132)."""
    x, y, z = point[..., 0], point[..., 1], point[..., 2]
    return torch.stack([k.fx * x + k.skew * y + k.cx * z, k.fy * y + k.cy * z, z], dim=-1)


def back_project(k: Intrinsics, point: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixel (…,2) + depth → camera-frame point (…,3) (camera.rs:135-140)."""
    z = torch.broadcast_to(depth.to(Float), point[..., 1].shape)
    y = (point[..., 1] - k.cy) * z / k.fy
    x = ((point[..., 0] - k.cx) * z - k.skew * y) / k.fx
    return torch.stack([x, y, z], dim=-1)


class Camera(NamedTuple):
    """Intrinsics + extrinsics; the extrinsics are the camera's pose,
    camera-to-world (camera.rs:12-23)."""

    intrinsics: Intrinsics
    extrinsics: Pose


def world_to_camera(extrinsics: Pose, point: torch.Tensor) -> torch.Tensor:
    """World → camera coordinates: ``R^-1 (p - t)`` (camera.rs:70-72)."""
    return _pose.quat_rotate(_pose.quat_conj(extrinsics.q), point - extrinsics.t)


def camera_to_world(extrinsics: Pose, point: torch.Tensor) -> torch.Tensor:
    """Camera → world coordinates: ``pose * p`` (camera.rs:75-77)."""
    return _pose.apply(extrinsics, point)


def camera_project(cam: Camera, point: torch.Tensor) -> torch.Tensor:
    """World point → homogeneous pixel (camera.rs:36-39)."""
    return project(cam.intrinsics, world_to_camera(cam.extrinsics, point))


def camera_back_project(cam: Camera, point: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixel + depth → world point (camera.rs:43-45)."""
    return camera_to_world(cam.extrinsics, back_project(cam.intrinsics, point, depth))


def camera_multi_res(cam: Camera, n: int) -> List[Camera]:
    """The camera at n resolutions: intrinsics halved, extrinsics kept (camera.rs:49-57)."""
    return [Camera(k, cam.extrinsics) for k in multi_res(cam.intrinsics, n)]


def warp(model: Pose, x: torch.Tensor, y: torch.Tensor, idepth: torch.Tensor, k: Intrinsics):
    """Warp pixel(s) (x, y) at inverse depth ``idepth`` by ``model``:
    back-project, move, project, dehomogenize (lm_optimizer.rs:213-219).
    Returns the (u, v) pixel coordinates in the target image."""
    p2 = torch.stack([x, y], dim=-1)
    x1 = back_project(k, p2, 1.0 / idepth)
    x2 = _pose.apply(model, x1)
    uvz = project(k, x2)
    return uvz[..., 0] / uvz[..., 2], uvz[..., 1] / uvz[..., 2]
