"""se3 / SE3: ``exp`` (twist → Pose) and ``log`` (Pose → twist) on tensors.

The port of ``visual_odometry_rs_tpu/math/se3.py``.  Twists are
``xi = [v, w]``: linear velocity first, angular velocity second
(se3.rs:30-40).  The Taylor branches below ``theta^2 < (1e-2)^2`` are kept
(se3.rs:19-27); both branches are evaluated and picked with ``torch.where``,
the exact one on guarded denominators.
"""

from __future__ import annotations

import math

import torch

from ..utils.types import Float
from . import so3
from .pose import Pose, quat_normalize, rotation_matrix

EPSILON_TAYLOR_SERIES = 1e-2
EPSILON_TAYLOR_SERIES_2 = EPSILON_TAYLOR_SERIES * EPSILON_TAYLOR_SERIES


def _eye3(batch_shape, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(*batch_shape, 3, 3)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(m * v[..., None, :], dim=-1)


def adjoint(p: Pose) -> torch.Tensor:
    """Adjoint of a rigid motion, (…, 6, 6): ``exp(adjoint(p) @ xi) = p ∘
    exp(xi) ∘ p⁻¹``; for the ``[v, w]`` layout ``[[R, hat(t) R], [0, R]]``."""
    R = rotation_matrix(p.q)
    top = torch.cat([R, torch.matmul(so3.hat(p.t), R)], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def exp(xi: torch.Tensor) -> Pose:
    """se3 → SE3 (se3.rs:65-95): the rotation quaternion, normalized, and
    the translation ``V xi_v`` with ``V = I + c1 hat(w) + c2 hat(w)^2``."""
    xi = xi.to(Float)
    xi_v = xi[..., 0:3]
    xi_w = xi[..., 3:6]
    theta_2 = torch.sum(xi_w * xi_w, dim=-1)
    use_taylor = theta_2 < EPSILON_TAYLOR_SERIES_2
    one = torch.ones_like(theta_2)

    omega = so3.hat(xi_w)
    omega_2 = so3.hat_2(xi_w)

    real_t = 1.0 - 0.125 * theta_2
    imag_t = 0.5 - (1.0 / 48.0) * theta_2
    c_omega_t = 0.5 - (1.0 / 24.0) * theta_2
    c_omega2_t = (1.0 / 6.0) - (1.0 / 120.0) * theta_2

    theta = torch.sqrt(torch.where(use_taylor, one, theta_2))
    half_theta = 0.5 * theta
    real_e = torch.cos(half_theta)
    imag_e = torch.sin(half_theta) / theta
    c_omega_e = (1.0 - torch.cos(theta)) / torch.where(use_taylor, one, theta_2)
    c_omega2_e = (theta - torch.sin(theta)) / torch.where(use_taylor, one, theta * theta_2)

    real = torch.where(use_taylor, real_t, real_e)
    imag = torch.where(use_taylor, imag_t, imag_e)
    c_omega = torch.where(use_taylor, c_omega_t, c_omega_e)
    c_omega2 = torch.where(use_taylor, c_omega2_t, c_omega2_e)

    v_mat = (
        _eye3(theta_2.shape, xi)
        + c_omega[..., None, None] * omega
        + c_omega2[..., None, None] * omega_2
    )
    q = quat_normalize(torch.cat([real[..., None], imag[..., None] * xi_w], dim=-1))
    return Pose(q, _matvec(v_mat, xi_v))


def log(p: Pose) -> torch.Tensor:
    """SE3 → se3 (se3.rs:99-129)."""
    q = p.q.to(Float)
    t = p.t.to(Float)
    imag = q[..., 1:]
    real = q[..., 0]
    imag_norm_2 = torch.sum(imag * imag, dim=-1)
    small_imag = imag_norm_2 < EPSILON_TAYLOR_SERIES_2
    one = torch.ones_like(imag_norm_2)
    imag_norm = torch.sqrt(torch.where(small_imag, one, imag_norm_2))

    scale_small = torch.full_like(real, 2.0) / real
    alpha = torch.abs(real) / imag_norm
    theta_near_pi = torch.sign(real) * (math.pi - 2.0 * alpha)
    theta_exact = 2.0 * torch.atan(imag_norm / real)
    near_pi = torch.abs(real) < EPSILON_TAYLOR_SERIES
    theta = torch.where(near_pi, theta_near_pi, theta_exact)
    w_scale = torch.where(small_imag, scale_small, theta / imag_norm)
    w = w_scale[..., None] * imag

    omega = so3.hat(w)
    omega_2 = so3.hat_2(w)

    x_2 = imag_norm_2 / (real * real)
    c2_taylor = (1.0 / 12.0) * (1.0 + (1.0 / 15.0) * x_2)
    theta_2 = theta * theta
    c2_exact = (1.0 - 0.5 * theta * real / imag_norm) / torch.where(small_imag, one, theta_2)
    c_omega2 = torch.where(small_imag, c2_taylor, c2_exact)

    v_inv = _eye3(real.shape, q) - 0.5 * omega + c_omega2[..., None, None] * omega_2
    return torch.cat([_matvec(v_inv, t), w], dim=-1)
