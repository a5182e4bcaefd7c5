"""Windowed photometric bundle adjustment (a DSO-style keyframe window), in
PyTorch.

The port of ``visual_odometry_rs_tpu/models/photometric_ba.py``: the joint
refinement of a window of F frame poses and of the keyframe candidates'
inverse depths, minimizing the photometric residuals

    r_{f,i} = I_f( warp(p_i, d_i, T_f) ) - (a_f I_0(p_i) + b_f)

over every (frame, candidate) pair by Levenberg-Marquardt on the normal
equations, the depths eliminated by the Schur complement (each depth is a
scalar block).  Same staged solve, trust region, visibility guard, gauge,
accept/reject rule and damping schedule as the JAX package.

- **One pass for all pairs.** Residuals and Jacobians of all F x N pairs
  (and of all lanes) come from one set of tensor operations: no loop over
  frames, candidates or lanes.
- **Closed-form Jacobians.** Per pair, the 6 twist columns (right-multiplied
  at the frame's pose) and the inverse-depth column, by the chain rule
  through the rigid motion, the projection and the bilinear *interpolant*
  (``ops.interp.bilinear_grad``: zero through ``floor`` and the mask): what
  the JAX package's ``jax.jacfwd`` of the warp and sample computes, to
  rounding.  Brightness adds the analytic columns ``(-T, -1)``; Huber
  multiplies the mask by ``sqrt(w)``.
- **Fixed order.** The normal equations are sums over candidates written as
  matrix products (``matmul`` over a fixed axis), the block diagonal is
  a select, and no value is scattered: two runs on a GPU are bit-equal.
- **The LM loop** runs masked iterations on every lane: a lane whose stage
  is done keeps its state, as under the JAX package's ``vmap`` of
  ``lax.while_loop``.  The host reads one flag per iteration (whether every
  lane is done) and nothing else.  The Cholesky factor of a matrix that is
  not positive definite is NaN, as JAX's, so the step is rejected.

Every function takes one window; ``solve_window_batched`` adds a leading
lane axis to every leaf (``stack_windows``), with the intrinsics shared or
one set per lane.

- **Several devices.** ``solve_window_sharded`` spreads a window's
  candidates over the ranks of a mesh axis (``parallel.mesh``): every
  candidate sum of the solve (the camera system's parts, the energy, the
  pair count, the vote on finite depths) goes through the ``allreduce``
  hook of ``_solve_window_impl`` once, a fixed-order cross-rank sum, and
  everything replicated (the additive floor, the pose prior, the camera
  solve) comes after it, so the sharded and single solves share one body.
  ``solve_window_batched(mesh=)`` spreads the lanes over a mesh axis's
  devices, with no communication.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import camera as camera_mod
from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math import se3
from ..math.pose import Pose
from ..ops import interp
from ..utils.types import Float


class Window(NamedTuple):
    """Fixed-shape photometric window problem.

    tmpl_xs/tmpl_ys/tmpl_vals/valid: (N,) keyframe candidates (image-0 frame).
    idepth: (N,) the sensor's inverse depths (the depth prior's anchor).
    poses: Pose with leading (F,): keyframe->frame motions (frame 0, the
      keyframe, is gauge-fixed).
    images: (F, H, W) the window's frames (u8 or f32).
    intrinsics: shared pinhole intrinsics.
    """

    tmpl_xs: torch.Tensor
    tmpl_ys: torch.Tensor
    tmpl_vals: torch.Tensor
    valid: torch.Tensor
    idepth: torch.Tensor
    poses: Pose
    images: torch.Tensor
    intrinsics: Intrinsics


class WindowResult(NamedTuple):
    poses: Pose
    idepth: torch.Tensor
    energy: torch.Tensor
    nb_iter: torch.Tensor
    # per-frame affine brightness (F, 2) = (gain, bias); rows (1, 0) when
    # the solve ran without ``brightness=True``
    ab: torch.Tensor


def _identity(x):
    return x


# ---------------------------------------------------------------------------
# Lane axis: every internal function takes windows whose leaves carry a
# leading (B,) axis; the intrinsics are 0-d (shared) or (B,).
# ---------------------------------------------------------------------------


def _lane(p: Pose) -> Pose:
    return Pose(p.q[None], p.t[None])


def _lanes(win: Window) -> Window:
    """One window as a batch of one lane."""
    return Window(
        tmpl_xs=win.tmpl_xs[None], tmpl_ys=win.tmpl_ys[None], tmpl_vals=win.tmpl_vals[None],
        valid=win.valid[None], idepth=win.idepth[None], poses=_lane(win.poses), images=win.images[None],
        intrinsics=win.intrinsics,
    )


def _lane_k(k: Intrinsics) -> Intrinsics:
    """Intrinsics broadcastable against (B, F, N)."""
    return Intrinsics(*(torch.as_tensor(v).reshape(-1, 1, 1) for v in k))


def _identity_ab(lead, device) -> torch.Tensor:
    ab = torch.tensor([1.0, 0.0], dtype=Float, device=device)
    return ab.expand(*lead, 2).clone()


def _warp(win: Window, poses: Pose, idepth: torch.Tensor):
    """Back-project every candidate at ``idepth`` (B, N), move it by every
    frame's pose (B, F), project: ``(x1 (B,1,N,3), x2 (B,F,N,3), u, v)``."""
    k = _lane_k(win.intrinsics)
    pix = torch.stack([win.tmpl_xs, win.tmpl_ys], dim=-1)[:, None]  # (B, 1, N, 2)
    d = idepth[:, None]
    x1 = camera_mod.back_project(k, pix, torch.ones_like(d) / d)
    x2 = pose_mod.apply(Pose(poses.q[:, :, None], poses.t[:, :, None]), x1)
    uvz = camera_mod.project(k, x2)
    return x1, x2, uvz[..., 0] / uvz[..., 2], uvz[..., 1] / uvz[..., 2]


def _tangents(x1: torch.Tensor) -> torch.Tensor:
    """The derivatives of ``exp(xi) ∘ x1`` at xi = 0 for the 6 twist
    directions ``[v, w]`` (``e_k`` and ``e_k × x1``), and of ``x1`` in the
    inverse depth (``-x1 z``, z = 1/d): (…, 7, 3), before the frame's
    rotation."""
    X, Y, Z = x1[..., 0], x1[..., 1], x1[..., 2]
    zero, one = torch.zeros_like(X), torch.ones_like(X)
    cols = [
        (one, zero, zero), (zero, one, zero), (zero, zero, one),
        (zero, -Z, Y), (Z, zero, -X), (-Y, X, zero),
        (-X * Z, -Y * Z, -Z * Z),
    ]
    return torch.stack([torch.stack(c, dim=-1) for c in cols], dim=-2)


def _residuals(win: Window, poses: Pose, idepth, ab, jacobians: bool):
    """Photometric residuals (B, F, N), the inside mask and, with
    ``jacobians``, the (B, F, N, 6) twist and (B, F, N) depth Jacobians of
    the interpolated value (zero outside)."""
    x1, x2, u, v = _warp(win, poses, idepth)
    tmpl = win.tmpl_vals[:, None]
    if not jacobians:
        val, inside = interp.bilinear(win.images, u, v)
        return val - (ab[..., 0:1] * tmpl + ab[..., 1:2]), inside, None, None
    val, inside, gx, gy = interp.bilinear_grad(win.images, u, v)
    r = val - (ab[..., 0:1] * tmpl + ab[..., 1:2])
    # the tangents moved into the frame (quat_rotate is linear in its
    # vector; the translation does not move a tangent): (B, F, N, 7, 3)
    dx2 = pose_mod.quat_rotate(poses.q[:, :, None, None], _tangents(x1))
    k = Intrinsics(*(torch.as_tensor(c).reshape(-1, 1, 1, 1) for c in win.intrinsics))
    dX, dY, dZ = dx2[..., 0], dx2[..., 1], dx2[..., 2]
    z2 = x2[..., 2:3]
    du = (k.fx * dX + k.skew * dY + k.cx * dZ - u[..., None] * dZ) / z2
    dv = (k.fy * dY + k.cy * dZ - v[..., None] * dZ) / z2
    jac = gx[..., None] * du + gy[..., None] * dv
    jac = torch.where(inside[..., None], jac, torch.zeros_like(jac))
    return r, inside, jac[..., :6], jac[..., 6]


def _huber_mask(r: torch.Tensor, maskf: torch.Tensor, robust_delta: float) -> torch.Tensor:
    """The mask times ``sqrt(w)`` of Huber's IRLS weight: one power of w in
    every normal-equation product (JᵀWJ, JᵀWr, Σw r²)."""
    absr = torch.abs(r)
    delta = torch.full_like(absr, robust_delta)
    w = torch.where(absr <= robust_delta, torch.ones_like(absr), delta / torch.clamp_min(absr, 1e-12))
    return maskf * torch.sqrt(w)


def _build_b(win: Window, poses: Pose, idepth, robust_delta: float, ab, brightness: bool, jacobians: bool = True):
    """(B, F, N) residuals, weighted masks and (with ``jacobians``) the camera
    Jacobians (B, F, N, P), P = 6 or 8 with brightness, and the depth
    Jacobians (B, F, N); every one times the mask."""
    r, inside, j_xi, j_d = _residuals(win, poses, idepth, ab, jacobians)
    maskf = (inside & win.valid[:, None]).to(Float)
    if robust_delta > 0.0:
        maskf = _huber_mask(r, maskf, robust_delta)
    r = r * maskf
    if not jacobians:
        return r, maskf, None, None
    if brightness:
        tmpl = win.tmpl_vals[:, None].expand_as(r)
        j_xi = torch.cat([j_xi, torch.stack([-tmpl, -torch.ones_like(tmpl)], dim=-1)], dim=-1)
    return r, maskf, j_xi * maskf[..., None], j_d * maskf


def _build(win: Window, poses: Pose, idepth, robust_delta: float = 0.0, ab=None, brightness: bool = False):
    """(F, N) residuals, masks and Jacobians of one window (the JAX
    package's ``_build`` without its sampler argument)."""
    ab = _identity_ab((1, poses.q.shape[0]), poses.q.device) if ab is None else ab[None]
    out = _build_b(_lanes(win), _lane(poses), idepth[None], robust_delta, ab, brightness)
    return tuple(x[0] for x in out)


def _prior_residual(poses: Pose, anchors: Pose) -> torch.Tensor:
    """Per-frame prior residual ρ_f = log(anchor_f⁻¹ ∘ pose_f), (…, F, 6).

    The solver's update is right-multiplicative, so a step δ maps ρ → ρ + δ
    to first order: a Gaussian pose prior of energy ``(ρ+δ)ᵀ H (ρ+δ)``
    (un-halved, as the sum-r² photometric energy) adds H to the camera
    system and -Hρ to the right-hand side."""
    return se3.log(pose_mod.compose(pose_mod.inverse(anchors), poses))


def _pad_prior(Hp: torch.Tensor, rho: torch.Tensor, P: int):
    """Zero-pad a 6-dof pose prior (…, F, 6, F, 6) to P-parameter blocks."""
    if P == 6:
        return Hp, rho
    lead, F = Hp.shape[:-4], Hp.shape[-4]
    Hp_p = Hp.new_zeros((*lead, F, P, F, P))
    Hp_p[..., :6, :, :6] = Hp
    rho_p = rho.new_zeros((*lead, F, P))
    rho_p[..., :6] = rho
    return Hp_p, rho_p


def _bmv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` per lane, A (B, m, n), x (B, n) → (B, m), as products summed
    along the last axis: a lane's result does not depend on the number of
    lanes (a batched matrix-vector product of one lane takes another BLAS
    path than one of several, and rounds otherwise), so lanes spread over
    devices give the bits of one batch."""
    return torch.sum(A * x[:, None, :], dim=-1)


def _quadratic(rho: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """``ρᵀHρ`` per lane: ρ (B, F, P), H (B, F, P, F, P) → (B,)."""
    B, n = rho.shape[0], rho.shape[1] * rho.shape[2]
    v = rho.reshape(B, n)
    return torch.sum(v * _bmv(H.reshape(B, n, n), v), dim=-1)


def _matvec(H: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("fagb,gb->fa")`` per lane."""
    B, F, P = x.shape
    return _bmv(H.reshape(B, F * P, F * P), x.reshape(B, F * P)).reshape(B, F, P)


def _schur_terms(win: Window, r, j_xi, j_d, idepth, lm, w_prior: float):
    """The camera blocks and the depth-eliminated terms of the damped
    normal equations, per lane: ``(A_damped (B,F,P,P), b_cam (B,F,P),
    S_fill (B,F,P,F,P), rhs_fill (B,F,P), D_inv (B,N), E (B,F,N,P),
    b_d (B,N))``, before the additive floor, the prior and the gauge."""
    B, F, N, P = j_xi.shape
    jt = j_xi.transpose(-1, -2)  # (B, F, P, N)
    A = jt @ j_xi
    b_cam = -(jt @ r[..., None])[..., 0]
    # depth diagonal D_i = sum_f j_d^2 + prior: the prior anchors each
    # inverse depth to the sensor (win.idepth) with weight sigma_I^2 / sigma_d^2
    validf = win.valid.to(Float)
    D = torch.sum(j_d * j_d, dim=1) + w_prior * validf
    b_d = -torch.sum(j_d * r, dim=1) + w_prior * validf * (win.idepth - idepth)
    E = j_xi * j_d[..., None]  # coupling (B, F, N, P)
    eye = torch.eye(P, dtype=Float, device=A.device)
    lm4 = lm.reshape(B, 1, 1, 1)
    A_damped = A * (1.0 + lm4 * eye)
    D_damped = D * (1.0 + lm.reshape(B, 1)) + 1e-10
    D_inv = torch.ones_like(D_damped) / D_damped
    E_rows = E.permute(0, 1, 3, 2).reshape(B, F * P, N)  # (B, FP, N)
    S_fill = ((E_rows * D_inv[:, None]) @ E_rows.transpose(1, 2)).reshape(B, F, P, F, P)
    rhs_fill = _bmv(E_rows, D_inv * b_d).reshape(B, F, P)
    return A_damped, b_cam, S_fill, rhs_fill, D_inv, E, b_d


def _block_diag(A: torch.Tensor) -> torch.Tensor:
    """(B, F, P, P) blocks → (B, F, P, F, P) with them on the diagonal and
    zeros elsewhere (a select: no product touches the blocks)."""
    B, F, P, _ = A.shape
    on = torch.eye(F, dtype=torch.bool, device=A.device)[:, None, :, None]
    full = A[:, :, :, None, :].expand(B, F, P, F, P)
    return torch.where(on, full, torch.zeros_like(full))


def _assemble(A_damped, b_cam, S_fill, rhs_fill, lm, poses: Pose, Hp, anchors: Pose):
    """The Schur-reduced system with the additive floor and the pose prior:
    ``(S (B,F,P,F,P), rhs (B,F,P))`` before gauge fixing."""
    B, F, P, _ = A_damped.shape
    eye = torch.eye(P, dtype=Float, device=A_damped.device)
    # the additive floor: a frame whose candidates all leave the view has
    # exactly-zero diagonal entries (notably the brightness columns), which
    # multiplicative damping cannot regularize
    A_damped = A_damped + (lm.reshape(B, 1, 1, 1) * 1e-6 + 1e-8) * eye
    S = _block_diag(A_damped) - S_fill
    rhs = b_cam - rhs_fill
    Hp_p, rho_p = _pad_prior(Hp, _prior_residual(poses, anchors), P)
    return S + Hp_p, rhs - _matvec(Hp_p, rho_p)


def _camera_system(win: Window, poses: Pose, idepth, lm, prior_weight, robust_delta: float = 0.0, ab=None,
                   brightness: bool = False, pose_prior=None):
    """Schur-reduced (depths eliminated) damped camera system of one window:
    ``(S (F,P,F,P), rhs (F,P), D_inv (N,), E (F,N,P), b_d (N,))`` before
    gauge fixing.  P = 6, or 8 with ``brightness``.  ``pose_prior=(H,
    anchors)`` adds a Gaussian pose prior."""
    out = _camera_system_b(
        _lanes(win), _lane(poses), idepth[None], torch.as_tensor(lm, dtype=Float, device=poses.q.device).reshape(1),
        float(prior_weight), robust_delta, None if ab is None else ab[None], brightness,
        None if pose_prior is None else (pose_prior[0][None], _lane(pose_prior[1])),
    )
    return tuple(x[0] for x in out)


def _camera_system_b(win: Window, poses: Pose, idepth, lm, prior_weight: float, robust_delta: float, ab,
                     brightness: bool, pose_prior):
    B, F = poses.q.shape[:2]
    if ab is None:
        ab = _identity_ab((B, F), poses.q.device)
    r, _, j_xi, j_d = _build_b(win, poses, idepth, robust_delta, ab, brightness)
    A_damped, b_cam, S_fill, rhs_fill, D_inv, E, b_d = _schur_terms(win, r, j_xi, j_d, idepth, lm, prior_weight)
    Hp, anchors = pose_prior if pose_prior is not None else _zero_prior((B, F), poses.q.device)
    S, rhs = _assemble(A_damped, b_cam, S_fill, rhs_fill, lm, poses, Hp, anchors)
    return S, rhs, D_inv, E, b_d


def _zero_prior(lead, device) -> tuple:
    """A no-op pose prior (H = 0, identity anchors): adding it contributes
    literal zeros, so one code path serves windows with and without one."""
    B, F = lead
    return (
        torch.zeros((B, F, 6, F, 6), dtype=Float, device=device),
        Pose(pose_mod.identity(device).q.expand(B, F, 4), pose_mod.identity(device).t.expand(B, F, 3)),
    )


def _energy_b(win: Window, poses: Pose, idepth, ab, prior_weight: float, robust_delta: float, Hp, anchors,
              red=_identity):
    """(B,) total energy (photometric + depth prior + pose prior) and (B,)
    number of contributing pairs (mask > 0, not the Huber-scaled weight:
    ``energy_tol`` is calibrated per pair).  ``red`` sums the candidate sums
    over the shards; the replicated pose prior is added once, after it."""
    r, maskf, _, _ = _build_b(win, poses, idepth, robust_delta, ab, False, jacobians=False)
    validf = win.valid.to(Float)
    d = idepth - win.idepth
    e = torch.sum(r * r, dim=(1, 2)) + prior_weight * torch.sum(validf * d * d, dim=1)
    e, n = red((e, torch.sum((maskf > 0.0).to(Float), dim=(1, 2))))
    # un-halved, as the photometric energy: a 0.5 would make accept/reject
    # watch another objective than the one the normal equations minimize
    return e + _quadratic(_prior_residual(poses, anchors), Hp), n


def _cholesky_solve(S2: torch.Tensor, rhs2: torch.Tensor) -> torch.Tensor:
    """Solve by Cholesky; a matrix that is not positive definite gives NaN,
    as JAX's factor does (so the step is rejected), and no host read."""
    L, info = torch.linalg.cholesky_ex(S2)
    L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
    return torch.cholesky_solve(rhs2[..., None], L)[..., 0]


def _where(flag: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(flag.reshape(flag.shape + (1,) * (new.dim() - flag.dim())), new, old)


def _solve_window_impl(
    win: Window,
    *,
    max_iterations: int,
    lm_init: float,
    idepth_prior_weight: float,
    energy_tol: float,
    robust_delta: float,
    brightness: bool,
    pose_prior,
    min_pair_ratio: float,
    max_step: float,
    max_depth_step: float,
    pose_only_iterations: int,
    refine_depth: bool,
    idepth_init=None,
    allreduce=_identity,
) -> WindowResult:
    """The staged LM solve of a batch of windows (every leaf (B, …)), each
    lane with its own prior ``(H (B,F,6,F,6), anchors Pose (B,F))`` and
    starting depths.

    ``allreduce`` sums over the candidate shards (the identity on one
    device): every
    candidate sum passes through it exactly once, and the replicated terms
    are added after it, so the sharded and single solves compute the same
    numbers up to the order of the cross-shard sum.

    ``idepth_init`` separates the starting point from the sensor anchor
    ``win.idepth`` that the depth prior pulls toward: re-feeding refined
    depths as the anchor would make the prior a random walk."""
    B, F = win.poses.q.shape[:2]
    device = win.poses.q.device
    w_prior = float(idepth_prior_weight)
    Hp, anchors = pose_prior if pose_prior is not None else _zero_prior((B, F), device)
    idepth_start = win.idepth if idepth_init is None else idepth_init
    P = 8 if brightness else 6
    n = P * F
    free = torch.arange(n, device=device) >= P
    eye_n = torch.eye(n, dtype=Float, device=device)

    def energy_of(poses, ab, idepth):
        return _energy_b(win, poses, idepth, ab, w_prior, robust_delta, Hp, anchors, allreduce)

    def gn(poses, ab, idepth, lm):
        r, _, j_xi, j_d = _build_b(win, poses, idepth, robust_delta, ab, brightness)
        A_damped, b_cam, S_fill, rhs_fill, D_inv, E, b_d = _schur_terms(win, r, j_xi, j_d, idepth, lm, w_prior)
        # the shards' parts of the camera system, in one collective
        A_damped, b_cam, S_fill, rhs_fill = allreduce((A_damped, b_cam, S_fill, rhs_fill))
        S, rhs = _assemble(A_damped, b_cam, S_fill, rhs_fill, lm, poses, Hp, anchors)
        # gauge: frame 0 (the keyframe) does not move, pose and brightness
        S2 = torch.where(free[:, None] & free[None, :], S.reshape(B, n, n), eye_n)
        rhs2 = torch.where(free, rhs.reshape(B, n), torch.zeros_like(rhs.reshape(B, n)))
        d_cam = _cholesky_solve(S2, rhs2)
        Et_dc = _bmv(E.permute(0, 2, 1, 3).reshape(B, -1, n), d_cam)
        return d_cam.reshape(B, F, P), D_inv * (b_d - Et_dc)

    def apply(poses, ab, idepth, d_cam, d_depth, freeze_depth):
        # trust region: the per-frame twist norm is capped at max_step,
        # direction kept; the brightness columns are linear and need no cap
        twist = d_cam[..., :6]
        norms = torch.sqrt(torch.sum(twist * twist, dim=-1, keepdim=True))
        scale = torch.clamp_max(torch.full_like(norms, max_step) / torch.clamp_min(norms, 1e-12), 1.0)
        lim = max_depth_step * idepth
        d_depth = torch.minimum(torch.maximum(d_depth, -lim), lim)
        if freeze_depth:
            d_depth = torch.zeros_like(d_depth)
        new_poses = pose_mod.renormalize_first_order(pose_mod.compose(poses, se3.exp(twist * scale)))
        new_ab = ab + d_cam[..., 6:8] if brightness else ab
        return new_poses, new_ab, torch.clamp_min(idepth + d_depth, 1e-6)  # idepth stays positive

    def body(carry, freeze_depth, stage_max):
        poses, ab, idepth, energy, lm, it, done = carry
        active = ~done
        d_cam, d_depth = gn(poses, ab, idepth, lm)
        new_poses, new_ab, new_idepth = apply(poses, ab, idepth, d_cam, d_depth, freeze_depth)
        new_energy, n_pairs = energy_of(new_poses, new_ab, new_idepth)
        # the vote on finite depths is global: shards must accept together
        bad_depth = allreduce(torch.sum(~torch.isfinite(new_idepth), dim=1).to(Float))
        ok = (
            torch.isfinite(new_energy)
            & (new_energy <= energy)
            & (n_pairs >= min_pair_ratio * n_pairs0)  # the visibility guard
            & torch.isfinite(new_poses.q).all(dim=(1, 2))
            & torch.isfinite(new_poses.t).all(dim=(1, 2))
            & torch.isfinite(new_ab).all(dim=(1, 2))
            & (bad_depth == 0)
        )
        keep = ok & active
        stop = (it + 1 >= stage_max) | (ok & (energy - new_energy <= energy_tol * torch.clamp_min(n_pairs, 1.0)))
        return (
            Pose(_where(keep, new_poses.q, poses.q), _where(keep, new_poses.t, poses.t)),
            _where(keep, new_ab, ab),
            _where(keep, new_idepth, idepth),
            torch.where(keep, new_energy, energy),
            torch.where(active, torch.where(ok, lm * 0.3, lm * 10.0), lm),
            torch.where(active, it + 1, it),
            torch.where(active, stop, done),
        )

    def run_stage(carry, freeze_depth, stage_max):
        # one host read an iteration: whether every lane is done
        while not bool(carry[-1].all()):
            carry = body(carry, freeze_depth, stage_max)
        return carry

    ab0 = _identity_ab((B, F), device)
    energy0, n_pairs0 = energy_of(win.poses, ab0, idepth_start)
    carry = (
        win.poses, ab0, idepth_start, energy0,
        torch.full((B,), lm_init, dtype=Float, device=device),
        torch.zeros((B,), dtype=torch.int32, device=device),
        torch.zeros((B,), dtype=torch.bool, device=device),
    )
    # stage 1 (depths frozen) never takes the whole budget, so that depth
    # refinement cannot vanish for small max_iterations
    stage1 = min(pose_only_iterations, max_iterations - 1) if refine_depth else max_iterations
    if stage1 > 0:
        carry = run_stage(carry, True, stage1)
    if stage1 < max_iterations:
        # the joint stage: the done flags start again, lambda and energy carry
        carry = run_stage((*carry[:6], torch.zeros_like(carry[6])), False, max_iterations)
    poses, ab, idepth, energy, _, it, _ = carry
    return WindowResult(poses=poses, idepth=idepth, energy=energy, nb_iter=it, ab=ab)


_DEFAULTS = dict(
    max_iterations=15, lm_init=1e-4, idepth_prior_weight=1e4, energy_tol=0.01, robust_delta=0.0,
    brightness=False, min_pair_ratio=0.7, max_step=0.02, max_depth_step=0.2, pose_only_iterations=5,
    refine_depth=True,
)


def _options(opts: dict) -> dict:
    unknown = set(opts) - set(_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown window-solve options {sorted(unknown)}")
    return {**_DEFAULTS, **opts}


def solve_window(win: Window, *, pose_prior=None, idepth_init=None, **opts) -> WindowResult:
    """LM-damped windowed photometric BA of one window, on its tensors'
    device.  The JAX package's options and defaults (``max_iterations=15``,
    ``lm_init=1e-4``, ``idepth_prior_weight=1e4``, ``energy_tol=0.01`` per
    contributing pair, ``robust_delta=0``, ``brightness=False``,
    ``min_pair_ratio=0.7``, ``max_step=0.02``, ``max_depth_step=0.2``,
    ``pose_only_iterations=5``, ``refine_depth=True``), without its sampler
    choice: the port indexes directly.

    ``brightness=True`` adds a per-frame (gain, bias) to each camera block
    (frame 0's fixed at (1, 0)).  A step is kept only when the energy does
    not increase, every value stays finite and at least ``min_pair_ratio``
    of the initially contributing pairs still contribute; lambda x0.3 on
    accept, x10 on reject.  Each accepted step moves a frame's twist by at
    most ``max_step`` and an inverse depth by at most ``max_depth_step``
    relative.  Depths stay frozen for up to ``pose_only_iterations``
    iterations (all of them with ``refine_depth=False``).
    ``pose_prior=(H (F,6,F,6), anchors Pose (F,))`` adds the energy
    ``ρᵀHρ``, ``ρ_f = log(anchor_f⁻¹ ∘ pose_f)``; ``idepth_init`` starts the
    depths elsewhere than at the sensor's anchor ``win.idepth``;
    ``solve_window_sharded`` spreads the candidates over several devices."""
    prior = None
    if pose_prior is not None:
        H, anchors = pose_prior
        prior = (torch.as_tensor(H, dtype=Float)[None], _lane(anchors))
    res = _solve_window_impl(
        _lanes(win), pose_prior=prior, idepth_init=None if idepth_init is None else idepth_init[None],
        **_options(opts),
    )
    return WindowResult(*(Pose(x.q[0], x.t[0]) if isinstance(x, Pose) else x[0] for x in res))


def solve_window_sharded(win: Window, mesh, axis: str = "points", *, pose_prior=None, idepth_init=None,
                         **opts) -> WindowResult:
    """``solve_window`` with the candidates sharded over the ranks of
    ``mesh[axis]`` (``parallel.mesh``): every rank passes the whole window,
    evaluates and eliminates the depths of its own ``N/n`` candidates on its
    device against the replicated images, and the (P F, P F + 1) camera
    system is summed across the ranks once per iteration (a fixed-order
    sum); the camera solve runs on every rank, the depth back-substitution
    on each rank's candidates.  Returns the replicated poses and this
    rank's shard of the refined depths (N/n,).  The candidate count must be
    a multiple of the axis size."""
    from ..parallel import collectives

    ag = collectives.axis_group(mesh, axis)
    n, rank = (1, 0) if ag is None else (ag.size, ag.rank)
    N = win.tmpl_xs.shape[0]
    if N % n:
        raise ValueError(f"{N} candidates do not split over the {n} ranks of axis {axis!r}")
    device = mesh.device
    part = slice(rank * (N // n), (rank + 1) * (N // n))
    local = Window(
        tmpl_xs=win.tmpl_xs[part], tmpl_ys=win.tmpl_ys[part], tmpl_vals=win.tmpl_vals[part], valid=win.valid[part],
        idepth=win.idepth[part], poses=win.poses, images=win.images, intrinsics=win.intrinsics,
    )
    local = Window(*(x.to(device) for x in local))
    prior = None
    if pose_prior is not None:
        H, anchors = pose_prior
        prior = (torch.as_tensor(H, dtype=Float).to(device)[None], _lane(anchors.to(device)))
    init = None if idepth_init is None else idepth_init[part].to(device)[None]
    res = _solve_window_impl(_lanes(local), pose_prior=prior, idepth_init=init,
                             allreduce=lambda x: collectives.psum(x, mesh, axis), **_options(opts))
    return WindowResult(*(Pose(x.q[0], x.t[0]) if isinstance(x, Pose) else x[0] for x in res))


def stack_windows(wins) -> Window:
    """Stack same-shape windows along a new leading lane axis (the input of
    ``solve_window_batched``).  Intrinsics that every window shares stay
    shared; otherwise they are stacked too."""
    wins = list(wins)
    k0 = wins[0].intrinsics
    same = all(all(bool(torch.equal(torch.as_tensor(a), torch.as_tensor(b))) for a, b in zip(w.intrinsics, k0))
               for w in wins[1:])
    intrinsics = k0 if same else Intrinsics(*(torch.stack([torch.as_tensor(w.intrinsics[i]) for w in wins])
                                              for i in range(5)))
    return Window(
        tmpl_xs=torch.stack([w.tmpl_xs for w in wins]), tmpl_ys=torch.stack([w.tmpl_ys for w in wins]),
        tmpl_vals=torch.stack([w.tmpl_vals for w in wins]), valid=torch.stack([w.valid for w in wins]),
        idepth=torch.stack([w.idepth for w in wins]),
        poses=Pose(torch.stack([w.poses.q for w in wins]), torch.stack([w.poses.t for w in wins])),
        images=torch.stack([w.images for w in wins]), intrinsics=intrinsics,
    )


def solve_window_batched(wins: Window, mesh=None, axis: str = "data", *, pose_prior=None, idepth_init=None,
                         **opts) -> WindowResult:
    """Independent windows solved together: every leaf of ``wins`` carries a
    leading (B,) lane axis (``stack_windows``), and so does every field of
    the result.  Each lane keeps its own accept/reject state, so no lane's
    schedule changes another's numbers.  ``pose_prior = (H (B,F,6,F,6),
    anchors Pose (B,F))`` and ``idepth_init (B,N)`` are per lane; None is a
    zero prior (an exact no-op).

    With ``mesh`` the lanes are spread over the devices of ``mesh[axis]``
    (``parallel.mesh.shard_batch``; B a multiple of their number): each
    device solves its lanes, all at once, with no communication, and the
    results come back to the device of ``wins``.  On the CPU every lane is
    bit-equal to the run without a mesh (``_bmv``); a GPU's sums over a
    lane's pairs block by the lanes a launch holds, so there a lane agrees
    to rounding."""
    B, F = wins.poses.q.shape[:2]
    if pose_prior is not None:
        Hp, anchors = pose_prior
        Hp = torch.as_tensor(Hp, dtype=Float)
        if tuple(Hp.shape) != (B, F, 6, F, 6) or tuple(anchors.q.shape[:2]) != (B, F):
            raise ValueError(
                "batched pose_prior must carry a leading batch axis: "
                f"H (B,F,6,F,6)={(B, F, 6, F, 6)}, anchors Pose (B,F); got "
                f"H {tuple(Hp.shape)}, anchors {tuple(anchors.q.shape)}"
            )
        pose_prior = (Hp, anchors)
    if idepth_init is not None and idepth_init.shape != wins.idepth.shape:
        raise ValueError(
            f"batched idepth_init must match wins.idepth shape {tuple(wins.idepth.shape)}; "
            f"got {tuple(idepth_init.shape)}"
        )
    opts = _options(opts)
    if mesh is None:
        return _solve_window_impl(wins, pose_prior=pose_prior, idepth_init=idepth_init, **opts)
    from ..parallel import mesh as mesh_mod

    devices = mesh.axis_devices(axis)
    shards = mesh_mod.shard_batch((wins, pose_prior, idepth_init), mesh, axis)
    results = mesh_mod.run_on_devices(
        lambda w, prior, init: _solve_window_impl(w, pose_prior=prior, idepth_init=init, **opts), devices, shards,
    )
    return mesh_mod.gather_batch(results, wins.poses.q.device)


def window_from_tracking(config, intrinsics: Intrinsics, kf_levels, images, tracked_poses: Pose,
                         level: int = 0) -> Window:
    """A ``Window`` from the tracker's outputs: ``kf_levels`` is the
    keyframe's ``KeyframeData.levels`` (with or without a lane axis),
    ``images`` the frames at ``level`` and ``tracked_poses`` the
    keyframe->frame motions that the solve starts from."""
    obs = kf_levels[level]
    return Window(
        tmpl_xs=obs.xs, tmpl_ys=obs.ys, tmpl_vals=obs.tmpl_vals, valid=obs.valid, idepth=obs.idepth,
        poses=tracked_poses, images=images, intrinsics=obs.intrinsics,
    )
