"""Trajectory evaluation: absolute trajectory error (ATE) and relative pose
error (RPE).

The port of ``visual_odometry_rs_tpu/eval/ate.py``.  ATE: rigid (or
similarity) alignment of the estimated positions onto ground truth by
Umeyama's method, then the RMSE of the translational residuals (the TUM
protocol), in numpy f64.  RPE: the error of the ``delta``-frame relative
motions, with the pose algebra of ``math.pose`` in f32 like the JAX module.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..math import pose as pose_mod
from ..math.pose import Pose
from ..utils.types import Float, to_numpy


def _positions(poses: Sequence[Pose]) -> np.ndarray:
    return np.stack([to_numpy(p.t).astype(np.float64) for p in poses])


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """(R, t, s) with ``dst ≈ s R src + t`` in the least-squares sense."""
    mu_src = src.mean(axis=0)
    mu_dst = dst.mean(axis=0)
    src_c = src - mu_src
    dst_c = dst - mu_dst
    cov = dst_c.T @ src_c / len(src)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_src = (src_c ** 2).sum() / len(src)
        s = float(np.trace(np.diag(d) @ S) / var_src) if var_src > 0 else 1.0
    else:
        s = 1.0
    t = mu_dst - s * R @ mu_src
    return R, t, s


def ate_rmse(
    estimated: Sequence[Pose], ground_truth: Sequence[Pose], with_scale: bool = False
) -> float:
    """RMSE of the translational error after alignment (meters)."""
    est = _positions(estimated)
    gt = _positions(ground_truth)
    if est.shape != gt.shape:
        raise ValueError(f"trajectory shapes differ: {est.shape} vs {gt.shape}")
    if len(est) < 2:
        return 0.0
    R, t, s = umeyama_alignment(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe_rmse(
    estimated: Sequence[Pose], ground_truth: Sequence[Pose], delta: int = 1
) -> Tuple[float, float]:
    """Relative pose error over ``delta``-frame intervals: (translational
    RMSE in meters, rotational RMSE in radians), in one batched pass over
    the N - delta pairs; (0, 0) when there is no pair."""
    if len(estimated) != len(ground_truth):
        raise ValueError(
            f"trajectory length mismatch: {len(estimated)} estimated vs "
            f"{len(ground_truth)} ground-truth poses"
        )
    if len(estimated) - delta <= 0:
        return 0.0, 0.0

    def stack(poses: Sequence[Pose]) -> Pose:
        return Pose(*(torch.stack([torch.as_tensor(to_numpy(getattr(p, f)), dtype=Float) for p in poses])
                      for f in Pose._fields))

    def rel(p: Pose) -> Pose:
        head = Pose(p.q[:-delta], p.t[:-delta])
        tail = Pose(p.q[delta:], p.t[delta:])
        return pose_mod.compose(pose_mod.inverse(head), tail)

    err = pose_mod.compose(pose_mod.inverse(rel(stack(ground_truth))), rel(stack(estimated)))
    t_err = torch.linalg.vector_norm(err.t, dim=-1).numpy().astype(np.float64)
    w = torch.clamp(err.q[:, 0].abs(), 0.0, 1.0).numpy().astype(np.float64)
    r_err = 2.0 * np.arccos(w)
    return float(np.sqrt(np.mean(np.square(t_err)))), float(np.sqrt(np.mean(np.square(r_err))))
