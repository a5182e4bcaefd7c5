"""Rigid-body motions as a NamedTuple of tensors.

The port of ``visual_odometry_rs_tpu/math/pose.py``: a quaternion stored
``[w, x, y, z]`` and a translation ``[x, y, z]``, with nalgebra's semantics
for compose, inverse and apply.  ``quat_rotate`` uses the cross-product form
(``v + w*(2 u×v) + u×(2 u×v)``), which matters because the tracker works
with approximately unit quaternions between first-order renormalizations.
All functions broadcast over leading axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.types import Float


class Pose(NamedTuple):
    """A rigid-body motion: quaternion ``q=[w,x,y,z]`` (…,4), translation ``t`` (…,3)."""

    q: torch.Tensor
    t: torch.Tensor

    def to(self, device) -> "Pose":
        return Pose(self.q.to(device), self.t.to(device))


def identity(device="cpu") -> Pose:
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=Float, device=device)
    return Pose(q, torch.zeros(3, dtype=Float, device=device))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions stored [w, x, y, z]."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q: ``t = 2 u×v;  v' = v + w t + u×t``."""
    u = q[..., 1:]
    w = q[..., :1]
    tv = 2.0 * _cross(u, v)
    return v + w * tv + _cross(u, tv)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b (apply b first, then a), like nalgebra's ``Iso3 * Iso3``."""
    return Pose(quat_mul(a.q, b.q), a.t + quat_rotate(a.q, b.t))


def inverse(p: Pose) -> Pose:
    qi = quat_conj(p.q)
    return Pose(qi, -quat_rotate(qi, p.t))


def apply(p: Pose, x: torch.Tensor) -> torch.Tensor:
    """Apply the rigid motion to 3D point(s): ``R x + t``."""
    return quat_rotate(p.q, x) + p.t


def rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w,x,y,z] → 3x3 rotation matrix (…,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def renormalize_first_order(p: Pose) -> Pose:
    """``q' = 0.5 (3 - |q|^2) q``, the reference's cheap renormalization
    after every inverse-compositional update (lm_optimizer.rs:205-209)."""
    sq_norm = torch.sum(p.q * p.q, dim=-1, keepdim=True)
    return Pose(0.5 * (3.0 - sq_norm) * p.q, p.t)
