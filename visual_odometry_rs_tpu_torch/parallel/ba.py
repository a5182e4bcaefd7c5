"""Window bundle adjustment with Schur-complement reduction, in PyTorch.

The port of ``visual_odometry_rs_tpu/parallel/ba.py``: K keyframe poses
(camera-to-world) and P world points, M masked observations ``(kf_idx,
pt_idx, uv)``, Levenberg-Marquardt over the (6K + 3P)-dim normal equations
reduced by the Schur complement: the 3x3 point blocks ``C_p`` are inverted
in one batch, the reduced camera system ``S = B - F C^-1 F^T`` is solved by
Cholesky with camera 0 gauge-fixed, and the points are back-substituted.
Pose updates are right-multiplied twists ``T_k <- T_k exp(delta_k)``, with
residuals in pixels.  The accept/reject rule, damping schedule and stop
rule are the JAX package's.

- **Jacobians.** Closed forms where JAX runs ``jax.jacfwd`` over
  ``compose(pose, exp(xi))`` and the projection: the camera-frame point
  ``pc = R^T (x - t)`` moves by ``[-R^T R, hat(pc)]`` in ``xi = [v, w]``
  and by ``R^T`` in the point (both applied as ``quat_rotate`` of basis
  vectors, so exactly the rotation the residual uses), through the
  projection's derivative ``[[fx, s, cx - u], [0, fy, cy - v]] / z``.
- **Fixed order.** The five ``segment_sum`` of the normal equations are
  sums along one axis of gather tables built on the host once per solve
  (an observation's row of its keyframe, its point and its (point,
  keyframe) cell); the Schur fill is one matmul.  No scatter-add, no float
  atomic: two runs on a GPU are bit-equal.
- **Host reads.** ``jax.lax.while_loop`` becomes a host loop that reads
  one flag an iteration (``done``); building the tables reads the
  observation indices once.
- **Singular blocks.** Batched ``inv_ex`` and ``cholesky_ex``: a singular
  point block or a camera system that is not positive definite gives NaN,
  as JAX's ``inv`` and ``cholesky`` do, and the step is rejected.

``solve_point_sharded`` (the landmark axis over a device mesh) belongs to
the multi-GPU work (ROADMAP A12).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import camera as camera_mod
from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math import se3, so3
from ..math.pose import Pose
from ..utils.types import Float


class BAProblem(NamedTuple):
    """Fixed-shape BA problem.

    poses: Pose with leading (K,), camera-to-world.
    points: (P, 3) world landmarks.
    obs_kf: (M,) int64, the keyframe of each observation.
    obs_pt: (M,) int64, the point of each observation.
    obs_uv: (M, 2) f32, measured pixels.
    obs_mask: (M,) bool, false for padding.
    intrinsics: shared pinhole intrinsics.
    """

    poses: Pose
    points: torch.Tensor
    obs_kf: torch.Tensor
    obs_pt: torch.Tensor
    obs_uv: torch.Tensor
    obs_mask: torch.Tensor
    intrinsics: Intrinsics


class BAResult(NamedTuple):
    poses: Pose
    points: torch.Tensor
    energy: torch.Tensor  # 0-d f32
    nb_iter: torch.Tensor  # 0-d int32


def _project(pose: Pose, point: torch.Tensor, k: Intrinsics) -> torch.Tensor:
    """World point → pixel through a camera-to-world pose."""
    uvz = camera_mod.project(k, camera_mod.world_to_camera(pose, point))
    return uvz[..., :2] / uvz[..., 2:3]


def _take(p: Pose, idx: torch.Tensor) -> Pose:
    return Pose(p.q[idx], p.t[idx])


def residuals(problem: BAProblem, poses: Pose, points: torch.Tensor) -> torch.Tensor:
    """(M, 2) masked reprojection residuals."""
    uv = _project(_take(poses, problem.obs_kf), points[problem.obs_pt], problem.intrinsics)
    r = uv - problem.obs_uv
    return torch.where(problem.obs_mask[:, None], r, torch.zeros_like(r))


def _obs_jacobians(problem: BAProblem, poses: Pose, points: torch.Tensor):
    """Per-observation Jacobians of the residual in the camera twist (M, 2, 6)
    and in the point (M, 2, 3), and the residual (M, 2), all masked."""
    cam = _take(poses, problem.obs_kf)
    x = points[problem.obs_pt]
    conj = pose_mod.quat_conj(cam.q)
    pc = pose_mod.quat_rotate(conj, x - cam.t)
    k = problem.intrinsics
    uvz = camera_mod.project(k, pc)
    uv = uvz[..., :2] / uvz[..., 2:3]
    # d pc / d point: quat_rotate(conj, ·) of the basis vectors (M, 3, 3),
    # columns e_0, e_1, e_2
    basis = torch.eye(3, dtype=Float, device=x.device)
    d_pt = pose_mod.quat_rotate(conj[:, None, :], basis).transpose(1, 2)
    # d pc / d v: -R^T R e_j (the twist's translation moves the camera
    # by R v); d pc / d w: hat(pc)
    d_v = -pose_mod.quat_rotate(conj[:, None, :], pose_mod.quat_rotate(cam.q[:, None, :], basis)).transpose(1, 2)
    d_cam = torch.cat([d_v, so3.hat(pc)], dim=-1)  # (M, 3, 6)
    z = pc[:, 2]
    zero = torch.zeros_like(z)
    proj = torch.stack(
        [
            torch.stack([k.fx.expand_as(z), k.skew.expand_as(z), k.cx - uv[:, 0]], dim=-1),
            torch.stack([zero, k.fy.expand_as(z), k.cy - uv[:, 1]], dim=-1),
        ],
        dim=1,
    ) / z[:, None, None]  # (M, 2, 3)
    maskf = problem.obs_mask.to(Float)
    j_cam = (proj @ d_cam) * maskf[:, None, None]
    j_pt = (proj @ d_pt) * maskf[:, None, None]
    r = (uv - problem.obs_uv) * maskf[:, None]
    return j_cam, j_pt, r


# ---------------------------------------------------------------------------
# Sums over the observations of each keyframe, point and cell, in a fixed order
# ---------------------------------------------------------------------------


def _table(segment: np.ndarray, nb_segments: int) -> np.ndarray:
    """Observation indices grouped by segment, in observation order: a
    (nb_segments, max count) table padded with M (a zero row)."""
    M = len(segment)
    order = np.argsort(segment, kind="stable")
    counts = np.bincount(segment, minlength=nb_segments)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    table = np.full((nb_segments, max(1, int(counts.max(initial=0)))), M, np.int64)
    seg = segment[order]
    table[seg, np.arange(M) - starts[seg]] = order
    return table


class _Incidence(NamedTuple):
    kf: torch.Tensor  # (K, ·) observations of each keyframe
    pt: torch.Tensor  # (P, ·) observations of each point
    cell: torch.Tensor  # (P * K, ·) observations of each (point, keyframe) pair


def _incidence(problem: BAProblem, K: int, P: int) -> _Incidence:
    device = problem.points.device
    kf = problem.obs_kf.cpu().numpy().astype(np.int64)  # the solve's one read of the indices
    pt = problem.obs_pt.cpu().numpy().astype(np.int64)
    tables = (_table(kf, K), _table(pt, P), _table(pt * K + kf, P * K))
    return _Incidence(*(torch.from_numpy(t).to(device) for t in tables))


def _segment_sum(terms: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    pad = terms.new_zeros((1, *terms.shape[1:]))
    return torch.cat([terms, pad])[table].sum(dim=1)


class _Normal(NamedTuple):
    B: torch.Tensor  # (K, 6, 6) camera diagonal blocks
    v: torch.Tensor  # (K, 6) camera rhs
    C: torch.Tensor  # (P, 3, 3) point diagonal blocks
    w: torch.Tensor  # (P, 3) point rhs
    F: torch.Tensor  # (P, K, 6, 3) camera-point coupling blocks


def _build_normal(problem: BAProblem, inc: _Incidence, poses: Pose, points: torch.Tensor, K: int, P: int) -> _Normal:
    j_cam, j_pt, r = _obs_jacobians(problem, poses, points)
    jct = j_cam.transpose(1, 2)  # (M, 6, 2)
    jpt = j_pt.transpose(1, 2)  # (M, 3, 2)
    B = _segment_sum(jct @ j_cam, inc.kf)
    v = _segment_sum(-(jct @ r[:, :, None])[..., 0], inc.kf)
    C = _segment_sum(jpt @ j_pt, inc.pt)
    w = _segment_sum(-(jpt @ r[:, :, None])[..., 0], inc.pt)
    F = _segment_sum(jct @ j_pt, inc.cell).reshape(P, K, 6, 3)
    return _Normal(B=B, v=v, C=C, w=w, F=F)


def _point_inverse(n: _Normal, lm: torch.Tensor) -> torch.Tensor:
    """Damped inverses of the 3x3 point blocks; NaN for a singular block."""
    eye3 = torch.eye(3, dtype=Float, device=n.C.device)
    inv, info = torch.linalg.inv_ex(n.C * (1.0 + lm * eye3) + 1e-8 * eye3)
    return torch.where((info == 0)[:, None, None], inv, torch.full_like(inv, float("nan")))


def _schur_reduce(n: _Normal, lm: torch.Tensor, K: int):
    """Eliminate the points: ``S = damped B - F C^-1 F^T``, ``rhs = v - F C^-1 w``,
    as (6K, 6K) and (6K,)."""
    P = n.F.shape[0]
    C_inv = _point_inverse(n, lm)
    FC = n.F @ C_inv[:, None]  # (P, K, 6, 3)
    fc_rows = FC.permute(1, 2, 0, 3).reshape(6 * K, 3 * P)
    f_rows = n.F.permute(1, 2, 0, 3).reshape(6 * K, 3 * P)
    S_fill = fc_rows @ f_rows.T
    rhs_fill = fc_rows @ n.w.reshape(3 * P)
    eye6 = torch.eye(6, dtype=Float, device=n.B.device)
    B_damped = n.B * (1.0 + lm * eye6)
    on = torch.eye(K, dtype=torch.bool, device=n.B.device)[:, None, :, None]
    blocks = B_damped[:, :, None, :].expand(K, 6, K, 6)
    S = torch.where(on, blocks, torch.zeros_like(blocks)).reshape(6 * K, 6 * K) - S_fill
    return S, n.v.reshape(6 * K) - rhs_fill, C_inv


def _solve_cameras(S: torch.Tensor, rhs: torch.Tensor, K: int) -> torch.Tensor:
    """Gauge-fixed camera solve: camera 0 is pinned (delta = 0); a system
    that is not positive definite gives NaN."""
    free = torch.arange(6 * K, device=S.device) >= 6
    eye = torch.eye(6 * K, dtype=Float, device=S.device)
    S_fixed = torch.where(free[:, None] & free[None, :], S, eye)
    rhs_fixed = torch.where(free, rhs, torch.zeros_like(rhs))
    chol, info = torch.linalg.cholesky_ex(S_fixed)
    chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    return torch.cholesky_solve(rhs_fixed[:, None], chol)[:, 0].reshape(K, 6)


def _apply_deltas(poses: Pose, points: torch.Tensor, d_cam: torch.Tensor, d_pt: torch.Tensor):
    new_poses = pose_mod.renormalize_first_order(pose_mod.compose(poses, se3.exp(d_cam)))
    return new_poses, points + d_pt


def _energy(problem: BAProblem, poses: Pose, points: torch.Tensor) -> torch.Tensor:
    r = residuals(problem, poses, points)
    return torch.sum(r * r)


def solve(problem: BAProblem, *, max_iterations: int = 15) -> BAResult:
    """LM bundle adjustment of the window on the device of its tensors."""
    K = problem.poses.q.shape[0]
    P = problem.points.shape[0]
    device = problem.points.device
    inc = _incidence(problem, K, P)
    poses, points = problem.poses, problem.points
    energy = _energy(problem, poses, points)
    lm = torch.tensor(1e-4, dtype=Float, device=device)
    it = 0
    while True:
        n = _build_normal(problem, inc, poses, points, K, P)
        S, rhs, C_inv = _schur_reduce(n, lm, K)
        d_cam = _solve_cameras(S, rhs, K)
        # back-substitute the points: delta_p = C^-1 (w - F^T delta_c)
        ft_dc = (n.F.permute(0, 3, 1, 2).reshape(P, 3, 6 * K) @ d_cam.reshape(6 * K, 1))[..., 0]
        d_pt = (C_inv @ (n.w - ft_dc)[..., None])[..., 0]
        new_poses, new_points = _apply_deltas(poses, points, d_cam, d_pt)
        new_energy = _energy(problem, new_poses, new_points)
        ok = (
            torch.isfinite(new_energy)
            & (new_energy <= energy)
            & torch.isfinite(new_poses.q).all()
            & torch.isfinite(new_poses.t).all()
        )
        poses = Pose(torch.where(ok, new_poses.q, poses.q), torch.where(ok, new_poses.t, poses.t))
        points = torch.where(ok, new_points, points)
        lm = torch.where(ok, lm * 0.3, lm * 10.0)
        converged = ok & (energy - new_energy < 1e-6 * (energy + 1.0))
        energy = torch.where(ok, new_energy, energy)
        it += 1
        if it >= max_iterations or bool(converged):  # the iteration's one host read
            break
    return BAResult(poses=poses, points=points, energy=energy, nb_iter=torch.tensor(it, dtype=torch.int32))


def synthetic_problem(K: int = 4, P: int = 64, seed: int = 0, perturb: float = 0.02, noise_px: float = 0.0,
                      device="cpu"):
    """A synthetic window with its ground truth, drawn as the JAX package's
    ``tests/test_ba.py::make_problem`` draws it (the same numpy draws in the
    same order): a small random walk of K camera-to-world poses from the
    identity, P points in front of them, every point seen in every frame
    (M = K P, keyframe-major), pixels with ``noise_px`` Gaussian noise,
    poses after the first and all points perturbed by ``perturb``.
    Returns ``(problem, gt_poses (K,), gt_points (P, 3))``."""
    rng = np.random.default_rng(seed)
    intr = Intrinsics.make(80.0, 60.0, 120.0, 120.0)

    def twist(x):
        return se3.exp(torch.from_numpy(np.asarray(x, np.float32)))

    gt = [pose_mod.identity()]
    for _ in range(1, K):
        gt.append(pose_mod.compose(gt[-1], twist(np.concatenate([0.05 * rng.normal(size=3), 0.02 * rng.normal(size=3)]))))
    gt_poses = Pose(torch.stack([p.q for p in gt]), torch.stack([p.t for p in gt]))
    gt_points = torch.from_numpy(np.stack(
        [rng.uniform(-1, 1, P), rng.uniform(-0.8, 0.8, P), rng.uniform(1.5, 3.0, P)], axis=1,
    ).astype(np.float32))
    obs_kf = torch.arange(K).repeat_interleave(P)
    obs_pt = torch.arange(P).repeat(K)
    uv = _project(_take(gt_poses, obs_kf), gt_points[obs_pt], intr)
    uv = uv + torch.from_numpy((noise_px * rng.normal(size=tuple(uv.shape))).astype(np.float32))
    init = [gt[0]] + [pose_mod.compose(gt[k], twist(perturb * rng.normal(size=6))) for k in range(1, K)]
    init_points = gt_points + torch.from_numpy((perturb * rng.normal(size=(P, 3))).astype(np.float32))
    problem = BAProblem(
        poses=Pose(torch.stack([p.q for p in init]), torch.stack([p.t for p in init])).to(device),
        points=init_points.to(device), obs_kf=obs_kf.to(device), obs_pt=obs_pt.to(device), obs_uv=uv.to(device),
        obs_mask=torch.ones(K * P, dtype=torch.bool, device=device), intrinsics=intr.to(device),
    )
    return problem, gt_poses.to(device), gt_points.to(device)


def solve_point_sharded(problem: BAProblem, mesh=None, axis: str = "points", **kwargs) -> BAResult:
    """The JAX package's ``solve_point_sharded`` spreads the landmark axis
    over a device mesh; the port's multi-GPU layer is ROADMAP A12."""
    raise NotImplementedError(
        "solve_point_sharded needs the multi-GPU layer (ROADMAP A12); use solve on one device"
    )
