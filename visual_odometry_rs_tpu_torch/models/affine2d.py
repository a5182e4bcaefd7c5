"""Pyramidal inverse-compositional 2D affine image alignment.

The port of ``visual_odometry_rs_tpu/models/affine2d.py`` (reference
``examples/optim_affine-2d.rs``): estimate the 6-parameter affine warp
between a template and an image by coarse-to-fine Lucas-Kanade in the
inverse-compositional formulation, minimized with Levenberg-Marquardt.

Warp parameterization (affine-2d.rs:344-366)::

    W(p) = [ 1+p1  p3  p5 ]      (u, v) = W(p) @ (x, y, 1)
           [  p2  1+p4 p6 ]

Per-pixel Jacobians ``[x gx, x gy, y gx, y gy, gx, gy]`` (affine-2d.rs:408-429)
come from the template's integer centered gradients (``ops.gradient.centered``).
Each LM step composes ``W_old @ W(delta)^-1`` (affine-2d.rs:166-179); between
pyramid levels the translation doubles (affine-2d.rs:61-64).

Plain torch on the device of the inputs.  Every pixel of the template is an
observation, so a level's evaluation is one bilinear sample of the image
(``ops.interp.bilinear``, the JAX package's ``bilinear_gather``) and one
(6, N) x (N, 7) matmul for ``[H | g]`` in full f32 (TF32 stays off: torch's
default).  The LM loop is the port's ``math.optimizer.iterative_solve``:
one host read an iteration.  A singular step matrix gives NaN, as JAX's
``inv`` does, and the level stops with ``failed``; nothing raises.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..math.optimizer import LMState, damped_solve, iterative_solve, lm_update
from ..ops import gradient as gradient_ops
from ..ops import interp
from ..ops import pyramid as pyramid_ops
from ..utils.types import Float


class LevelData(NamedTuple):
    """Per-level precomputed observation data."""

    template_vals: torch.Tensor  # (N,) f32 template intensities
    xs: torch.Tensor  # (N,) f32 pixel x (column) coords
    ys: torch.Tensor  # (N,) f32 pixel y (row) coords
    jacobians: torch.Tensor  # (N, 6) f32
    image: torch.Tensor  # (H, W) u8 target image


def warp_points(params: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Apply the affine warp to pixel coordinates (affine-2d.rs:337-342)."""
    u = (1.0 + params[0]) * x + params[2] * y + params[4]
    v = params[1] * x + (1.0 + params[3]) * y + params[5]
    return u, v


def warp_matrix(params: torch.Tensor) -> torch.Tensor:
    """Params → 3x3 affine matrix (affine-2d.rs:349-355)."""
    p = params.to(Float)
    zero, one = torch.zeros_like(p[0]), torch.ones_like(p[0])
    return torch.stack(
        [1.0 + p[0], p[2], p[4], p[1], 1.0 + p[3], p[5], zero, zero, one]
    ).reshape(3, 3)


def warp_params(mat: torch.Tensor) -> torch.Tensor:
    """3x3 affine matrix → params (affine-2d.rs:357-366)."""
    return torch.stack([mat[0, 0] - 1.0, mat[1, 0], mat[0, 1], mat[1, 1] - 1.0, mat[0, 2], mat[1, 2]])


def _grid(h: int, w: int, device):
    ys = torch.arange(h, dtype=Float, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=Float, device=device)[None, :].expand(h, w)
    return xs, ys


def affine_jacobians(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Dense per-pixel Jacobians [x gx, x gy, y gx, y gy, gx, gy] (N, 6)."""
    h, w = gx.shape
    xs, ys = _grid(h, w, gx.device)
    gxf, gyf = gx.to(Float), gy.to(Float)
    return torch.stack([xs * gxf, xs * gyf, ys * gxf, ys * gyf, gxf, gyf], dim=-1).reshape(h * w, 6)


def precompute_level(template: torch.Tensor, image: torch.Tensor) -> LevelData:
    gx, gy = gradient_ops.centered(template)
    h, w = template.shape
    xs, ys = _grid(h, w, template.device)
    return LevelData(
        template_vals=template.to(Float).reshape(-1),
        xs=xs.reshape(-1),
        ys=ys.reshape(-1),
        jacobians=affine_jacobians(gx, gy),
        image=image,
    )


def _eval_energy(obs: LevelData, params: torch.Tensor):
    """Masked residual pass: energy = Σ r² / #inside (affine-2d.rs:106-132)."""
    u, v = warp_points(params, obs.xs, obs.ys)
    vals, mask = interp.bilinear(obs.image, u, v)
    r = torch.where(mask, vals - obs.template_vals, torch.zeros_like(vals))
    count = torch.sum(mask).to(Float)
    return torch.sum(r * r) / count, r, mask


def _eval_full(obs: LevelData, params: torch.Tensor):
    """Energy, gradient ``g = Jᵀ (r ⊙ m)`` and Gauss-Newton Hessian
    ``H = (J ⊙ m)ᵀ J`` as one (6, N) x (N, 7) matmul (affine-2d.rs:135-152)."""
    energy, r, mask = _eval_energy(obs, params)
    jm = obs.jacobians * mask.to(Float)[:, None]
    m = jm.T @ torch.cat([obs.jacobians, r[:, None]], dim=1)  # (6, 7)
    return energy, m[:, 6], m[:, :6]


def _inverse(mat: torch.Tensor) -> torch.Tensor:
    """``inv`` that gives NaN for a singular matrix, as JAX's does."""
    inv, info = torch.linalg.inv_ex(mat)
    return torch.where(info == 0, inv, torch.full_like(inv, float("nan")))


def solve_level(obs: LevelData, params0: torch.Tensor, *, max_iterations: int = 19, energy_tol: float = 0.01):
    """LM solve of one pyramid level (affine-2d.rs:155-227): the reference
    stops at ``nb_iter >= 20`` and ``d_energy <= 0.01``."""

    def init(obs, params):
        energy, grad, hess = _eval_full(obs, params)
        return LMState(params, energy, grad, hess, torch.tensor(0.1, dtype=Float, device=params.device))

    def step(state):
        delta = damped_solve(state.hessian, state.gradient, state.lm_coef)
        return warp_params(warp_matrix(state.model) @ _inverse(warp_matrix(delta)))

    def eval_fn(obs, state, new_params):
        return (new_params, *_eval_full(obs, new_params))

    def stop(state, nb_iter, eval_out):
        return lm_update(state, nb_iter, *eval_out, max_iterations=max_iterations, energy_tol=energy_tol)

    return iterative_solve(
        obs, params0, init=init, step=step, eval_fn=eval_fn, stop_criterion=stop,
        max_iterations=max_iterations + 3,
    )


def default_nb_levels(height: int, width: int, target_coarse_pixels: int = 200) -> int:
    """``max(1, round(1 + log4(npixels / target)))`` (affine-2d.rs:49-52);
    Python's ``round``, half to even, as the JAX package's."""
    return max(1, round(1.0 + math.log(height * width / target_coarse_pixels, 4.0)))


def random_template(img, seed: int = 0):
    """Extract a random affine-warped template from an image (host numpy).

    The reference's template generation (affine-2d.rs:256-335): a random
    scaling in [0.7, 0.8), a rotation bounded so that the template stays
    inside the image, and a translation that keeps the warped corners in
    bounds; seeded here, where the reference uses ``thread_rng``.  The same
    draws as the JAX package's for a seed.

    Returns ``(template u8 array, 2x3 ground-truth affine matrix)`` with
    ``template(i, j) = img(affine @ (j, i, 1))`` by bilinear sampling.
    """
    rng = np.random.default_rng(seed)
    img = np.asarray(img)
    rows, cols = img.shape
    s_r = rng.uniform(0.7, 0.8)
    s_c = rng.uniform(0.7, 0.8)
    tmp_rows = np.floor(s_r * rows)
    tmp_cols = np.floor(s_c * cols)

    # the largest rotation that keeps the inner rectangle inside (affine-2d.rs:317-335)
    threshold = np.pi / 8
    inner_diag = np.hypot(tmp_rows, tmp_cols)
    ri, ci = rows - 2.0, cols - 2.0
    if inner_diag > ri:
        threshold = min(threshold, np.arcsin(ri / inner_diag) - np.arcsin(tmp_rows / inner_diag))
    if inner_diag > ci:
        threshold = min(threshold, np.arcsin(ci / inner_diag) - np.arcsin(tmp_cols / inner_diag))
    angle = rng.uniform(-threshold, threshold)

    m = np.array(
        [
            [s_c * np.cos(angle), -s_r * np.sin(angle)],
            [s_c * np.sin(angle), s_r * np.cos(angle)],
        ]
    )
    corners = np.array([[0.0, cols - 1.0, cols - 1.0, 0.0], [0.0, 0.0, rows - 1.0, rows - 1.0]])
    t_corners = m @ corners
    col_min, col_max = t_corners[0].min(), t_corners[0].max()
    row_min, row_max = t_corners[1].min(), t_corners[1].max()
    t_cols = rng.uniform(-col_min, max(-col_min + 1e-6, cols - 1.0 - col_max))
    t_rows = rng.uniform(-row_min, max(-row_min + 1e-6, rows - 1.0 - row_max))
    affine = np.array([[m[0, 0], m[0, 1], t_cols], [m[1, 0], m[1, 1], t_rows]], dtype=np.float32)

    # bilinear-sample the template (every point in bounds by construction)
    jj, ii = np.meshgrid(np.arange(cols), np.arange(rows))
    pts = affine @ np.stack([jj.ravel(), ii.ravel(), np.ones(ii.size)])
    x, y = pts[0], pts[1]
    u0 = np.floor(x).astype(int)
    v0 = np.floor(y).astype(int)
    u0c = np.clip(u0, 0, cols - 2)
    v0c = np.clip(v0, 0, rows - 2)
    a = x - u0
    b = y - v0
    imf = img.astype(np.float64)
    val = (
        (1 - b) * (1 - a) * imf[v0c, u0c]
        + b * (1 - a) * imf[v0c + 1, u0c]
        + (1 - b) * a * imf[v0c, u0c + 1]
        + b * a * imf[v0c + 1, u0c + 1]
    )
    return val.reshape(rows, cols).astype(np.uint8), affine


def align(template: torch.Tensor, image: torch.Tensor, nb_levels: int) -> Tuple[torch.Tensor, bool]:
    """Full pyramidal alignment on the device of ``image``: returns
    ``(params (6,), failed)``, ``failed`` true if a level's step was not
    finite.  Coarse to fine over ``nb_levels`` with the translation doubled
    between levels (affine-2d.rs:59-73)."""
    image = torch.as_tensor(image)
    template = torch.as_tensor(template, device=image.device)
    t_pyr = pyramid_ops.mean_pyramid(nb_levels, template)
    i_pyr = pyramid_ops.mean_pyramid(nb_levels, image)
    levels: List[LevelData] = [precompute_level(t, i) for t, i in zip(t_pyr, i_pyr)]
    params = torch.zeros(6, dtype=Float, device=image.device)
    double = torch.tensor([1.0, 1.0, 1.0, 1.0, 2.0, 2.0], dtype=Float, device=image.device)
    failed = False
    for lvl in reversed(range(len(levels))):
        result = solve_level(levels[lvl], params * double)
        params = result.state.model
        failed = failed or result.failed
    return params, failed
