"""so3 / SO3: ``hat``, ``hat_2``, ``vee``, ``exp`` and ``log`` on tensors.

The port of ``visual_odometry_rs_tpu/math/so3.py``, with the reference's
Taylor branches below ``theta^2 < (1e-2)^2`` (so3.rs:19-20).  Both branches
are evaluated and picked with ``torch.where``; the exact branch divides by a
guarded value so that no NaN is produced where the Taylor branch is taken.
"""

from __future__ import annotations

import math

import torch

from ..utils.types import Float
from . import pose as _pose

EPSILON_TAYLOR_SERIES = 1e-2
EPSILON_TAYLOR_SERIES_2 = EPSILON_TAYLOR_SERIES * EPSILON_TAYLOR_SERIES


def hat(w: torch.Tensor) -> torch.Tensor:
    """so3 parameterization (…,3) → skew-symmetric matrix (…,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(*w.shape[:-1], 3, 3)


def hat_2(w: torch.Tensor) -> torch.Tensor:
    """``hat(w) @ hat(w)``, computed from products like the reference (so3.rs:38-50)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    w11, w22, w33 = wx * wx, wy * wy, wz * wz
    w12, w13, w23 = wx * wy, wx * wz, wy * wz
    m = torch.stack(
        [-w22 - w33, w12, w13, w12, -w11 - w33, w23, w13, w23, -w11 - w22], dim=-1
    )
    return m.reshape(*w.shape[:-1], 3, 3)


def vee(mat: torch.Tensor) -> torch.Tensor:
    """Inverse of ``hat``, with no skew-symmetry check (so3.rs:54-56)."""
    return torch.stack([mat[..., 2, 1], mat[..., 0, 2], mat[..., 1, 0]], dim=-1)


def exp(w: torch.Tensor) -> torch.Tensor:
    """so3 → unit quaternion [w,x,y,z] (so3.rs:61-77, normalized at the end)."""
    w = w.to(Float)
    theta_2 = torch.sum(w * w, dim=-1)
    use_taylor = theta_2 < EPSILON_TAYLOR_SERIES_2
    real_taylor = 1.0 - 0.125 * theta_2
    imag_taylor = 0.5 - (1.0 / 48.0) * theta_2
    theta = torch.sqrt(torch.where(use_taylor, torch.ones_like(theta_2), theta_2))
    half_theta = 0.5 * theta
    real_exact = torch.cos(half_theta)
    imag_exact = torch.sin(half_theta) / theta
    real = torch.where(use_taylor, real_taylor, real_exact)
    imag = torch.where(use_taylor, imag_taylor, imag_exact)
    q = torch.cat([real[..., None], imag[..., None] * w], dim=-1)
    return _pose.quat_normalize(q)


def log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w,x,y,z] → so3, with the three branches of so3.rs:81-99."""
    q = q.to(Float)
    imag = q[..., 1:]
    real = q[..., 0]
    imag_norm_2 = torch.sum(imag * imag, dim=-1)
    small_imag = imag_norm_2 < EPSILON_TAYLOR_SERIES_2
    imag_norm = torch.sqrt(torch.where(small_imag, torch.ones_like(imag_norm_2), imag_norm_2))
    scale_small = torch.full_like(real, 2.0) / real
    alpha = torch.abs(real) / imag_norm
    theta_near_pi = torch.sign(real) * (math.pi - 2.0 * alpha)
    theta_exact = 2.0 * torch.atan(imag_norm / real)
    near_pi = torch.abs(real) < EPSILON_TAYLOR_SERIES
    theta = torch.where(near_pi, theta_near_pi, theta_exact)
    scale = torch.where(small_imag, scale_small, theta / imag_norm)
    return scale[..., None] * imag
