"""Absolute trajectory error (ATE) in numpy.

The port of ``umeyama_alignment`` and ``ate_rmse`` of
``visual_odometry_rs_tpu/eval/ate.py``: rigid (or similarity) alignment of
the estimated positions onto ground truth by Umeyama's method, then the RMSE
of the translational residuals (the TUM protocol).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..math.pose import Pose
from ..utils.types import to_numpy


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
