"""The plain reference of one tracked frame, in PyTorch, independent of the program.

A frozen, plain copy of the direct RGB-D tracker's frame path: the u8 mean
pyramid, the integer gradients, coarse-to-fine candidate selection, the
inverse-depth pyramid (DSO mean), the candidates kept at each level's cap
in the visit order (128-pixel chunks in bit-reversed order), their warp
Jacobians, and per level the Levenberg-Marquardt loop of the reference
(lm_optimizer.rs): evaluate, accept or reject, damp the diagonal by
(1 + lambda), solve by Cholesky, update ``model * exp(delta)^-1`` and
renormalise the quaternion to first order.  The levels run coarse to fine;
after a failed level the model is frozen.  The keyframe criterion is the
mean L1 optical flow of the coarsest level's candidates.

Nothing here imports the program.  Per-candidate arithmetic runs as tensor
operations on the device of the inputs; the scalar LM state (6x6 solve,
pose update) runs in float32 on the host, one read a evaluation.
``eval_dtype`` computes the Jacobians, residuals and normal-equation sums in
another precision (bfloat16 for the control); the warp stays in float32.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

F32 = torch.float32
EPS_TAYLOR_2 = 1e-4  # (1e-2)^2, the reference's Taylor-series switch
CHUNK = 128  # pixels of one chunk of the candidates' visit order


class Settings(NamedTuple):
    """The tracker settings the frame solve uses (a configuration file's keys)."""

    nb_levels: int
    diff_threshold: int
    candidate_cap: int
    depth_scale: float
    idepth_variance: float
    lm_coef_init: float
    max_iterations: int
    energy_tol: float
    flow_threshold: float

    @staticmethod
    def from_config(cfg: dict) -> "Settings":
        return Settings(
            nb_levels=int(cfg["nb_levels"]), diff_threshold=int(cfg["candidates_diff_threshold"]),
            candidate_cap=int(cfg["candidate_cap"]), depth_scale=float(cfg["depth_scale"]),
            idepth_variance=float(cfg["idepth_variance"]), lm_coef_init=float(cfg["lm_coef_init"]),
            max_iterations=int(cfg["max_iterations"]), energy_tol=float(cfg["energy_tol"]),
            flow_threshold=float(cfg["flow_threshold"]),
        )


# ---------------------------------------------------------------------------
# pose algebra (float32, quaternion [w, x, y, z], translation [x, y, z])
# ---------------------------------------------------------------------------


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]])


def quat_mul(p, q):
    w1, x1, y1, z1 = p
    w2, x2, y2, z2 = q
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def rotate(q, v):
    """``v + w (2 u x v) + u x (2 u x v)``, also for a quaternion not quite unit."""
    u, w = q[1:], q[0]
    tv = 2.0 * _cross(u, v)
    return v + w * tv + _cross(u, tv)


def compose(a, b):
    """``a * b``: (q, t) pairs."""
    return quat_mul(a[0], b[0]), a[1] + rotate(a[0], b[1])


def inverse(p):
    qi = torch.cat([p[0][:1], -p[0][1:]])
    return qi, -rotate(qi, p[1])


def se3_exp(xi):
    """Twist ``[v, w]`` -> (q, t), with the reference's Taylor branch."""
    v, w = xi[:3], xi[3:]
    th2 = torch.sum(w * w)
    wx, wy, wz = w
    z = torch.zeros((), dtype=F32)
    hat = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z]).reshape(3, 3)
    hat2 = torch.stack([-wy * wy - wz * wz, wx * wy, wx * wz, wx * wy, -wx * wx - wz * wz, wy * wz,
                        wx * wz, wy * wz, -wx * wx - wy * wy]).reshape(3, 3)
    if float(th2) < EPS_TAYLOR_2:
        real = 1.0 - 0.125 * th2
        imag = 0.5 - (1.0 / 48.0) * th2
        c1 = 0.5 - (1.0 / 24.0) * th2
        c2 = (1.0 / 6.0) - (1.0 / 120.0) * th2
    else:
        th = torch.sqrt(th2)
        real = torch.cos(0.5 * th)
        imag = torch.sin(0.5 * th) / th
        c1 = (1.0 - torch.cos(th)) / th2
        c2 = (th - torch.sin(th)) / (th * th2)
    q = torch.cat([real[None], imag * w])
    q = q / torch.linalg.vector_norm(q)
    vmat = torch.eye(3, dtype=F32) + c1 * hat + c2 * hat2
    return q, torch.sum(vmat * v[None, :], dim=1)


def lm_step(model, delta):
    """``model * exp(delta)^-1``, renormalised to first order."""
    q, t = compose(model, inverse(se3_exp(delta)))
    return 0.5 * (3.0 - torch.sum(q * q)) * q, t


# ---------------------------------------------------------------------------
# keyframe: pyramid, gradients, candidates, inverse depth, Jacobians
# ---------------------------------------------------------------------------


def _blocks(m):
    h2, w2 = m.shape[-2] // 2, m.shape[-1] // 2
    m = m[..., : 2 * h2, : 2 * w2]
    return m[..., 0::2, 0::2], m[..., 1::2, 0::2], m[..., 0::2, 1::2], m[..., 1::2, 1::2]


def pyramid(img: torch.Tensor, nb_levels: int) -> List[torch.Tensor]:
    """u8 levels, finest first: the truncating mean of each 2x2 block."""
    out = [img]
    for _ in range(1, nb_levels):
        a, b, c, d = (x.to(torch.int32) for x in _blocks(out[-1]))
        out.append(torch.div(a + b + c + d, 4, rounding_mode="trunc").to(torch.uint8))
    return out


def gradients(pyr: List[torch.Tensor]):
    """(gx, gy) f32 a level: centred differences / 2 at level 0 (0 on the
    border), 2x2-block differences / 2 of the finer image above it."""
    im = pyr[0].to(F32)
    gx = torch.zeros_like(im)
    gy = torch.zeros_like(im)
    gx[1:-1, 1:-1] = torch.div(im[1:-1, 2:] - im[1:-1, :-2], 2, rounding_mode="trunc")
    gy[1:-1, 1:-1] = torch.div(im[2:, 1:-1] - im[:-2, 1:-1], 2, rounding_mode="trunc")
    out = [(gx, gy)]
    for img in pyr[:-1]:
        a, b, c, d = (x.to(F32) for x in _blocks(img))
        out.append((torch.div(c + d - a - b, 2, rounding_mode="trunc"),
                    torch.div(b - a + d - c, 2, rounding_mode="trunc")))
    return out


def _keep_in_block(thresh, a, b, c, d):
    """Per corner of each 2x2 block: the largest value, and the second if it
    beats the third by more than ``thresh``; ties go to the earlier corner."""
    vals = torch.stack([a, b, c, d])
    ranks = torch.zeros(vals.shape, dtype=torch.int32, device=vals.device)
    for i in range(4):
        for j in range(4):
            if i == j:
                continue
            beats = vals[j] > vals[i] if j > i else vals[j] >= vals[i]
            ranks[i] += beats.to(torch.int32)
    srt = torch.sort(vals, dim=0, descending=True).values
    keep_second = srt[1] > srt[2] + thresh
    return (ranks == 0) | ((ranks == 1) & keep_second)


def candidate_mask(diff_threshold: int, grads) -> torch.Tensor:
    """The finest level's candidates, selected from the coarsest level down."""
    sq = [gx * gx + gy * gy for gx, gy in grads]
    mask = torch.ones(sq[-1].shape, dtype=torch.bool, device=sq[-1].device)
    for g in reversed(sq[:-1]):
        h2, w2 = g.shape[0] // 2, g.shape[1] // 2
        keep = _keep_in_block(diff_threshold, *_blocks(g)) & mask[:h2, :w2]
        full = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
        full[0 : 2 * h2 : 2, 0 : 2 * w2 : 2] = keep[0]
        full[1 : 2 * h2 : 2, 0 : 2 * w2 : 2] = keep[1]
        full[0 : 2 * h2 : 2, 1 : 2 * w2 : 2] = keep[2]
        full[1 : 2 * h2 : 2, 1 : 2 * w2 : 2] = keep[3]
        mask = full
    return mask


def idepth_pyramid(s: Settings, depth: torch.Tensor, mask: torch.Tensor):
    """(inverse depth, known) a level: ``scale / depth`` on the candidates with
    a depth, then per 2x2 block the variance-weighted (DSO) mean of the known."""
    known = (depth > 0) & mask
    d = depth.to(F32)
    idepth = torch.where(known, torch.full_like(d, s.depth_scale) / torch.clamp(d, min=1.0), torch.zeros_like(d))
    var = torch.where(known, torch.full_like(d, s.idepth_variance), torch.zeros_like(d))
    levels = [(idepth, known)]
    for _ in range(1, s.nb_levels):
        ds, vs = _blocks(levels[-1][0]), _blocks(var)
        ks = [k.to(F32) for k in _blocks(levels[-1][1])]
        vsum = vs[0] * ks[0] + vs[1] * ks[1] + vs[2] * ks[2] + vs[3] * ks[3]
        dsum = ds[0] * vs[0] * ks[0] + ds[1] * vs[1] * ks[1] + ds[2] * vs[2] * ks[2] + ds[3] * vs[3] * ks[3]
        known = (ks[0] + ks[1] + ks[2] + ks[3]) > 0
        idepth = torch.where(known, dsum / torch.where(known, vsum, torch.ones_like(vsum)), torch.zeros_like(vsum))
        var = torch.where(known, vsum, torch.zeros_like(vsum))
        levels.append((idepth, known))
    return levels


@lru_cache(maxsize=16)
def _bit_reversed(n: int) -> np.ndarray:
    bits = max(1, (n - 1).bit_length())
    r = np.arange(1 << bits)
    rev = np.zeros_like(r)
    x = r.copy()
    for _ in range(bits):
        rev = (rev << 1) | (x & 1)
        x >>= 1
    return rev[rev < n]


def visit_order(h: int, w: int) -> np.ndarray:
    """Flat pixel indices in the candidates' visit order."""
    n_chunks = -(-(h * w) // CHUNK)
    order = (_bit_reversed(n_chunks)[:, None] * CHUNK + np.arange(CHUNK)[None, :]).reshape(-1)
    return order[order < h * w]


class Level(NamedTuple):
    k: Tuple[float, float, float, float]  # cx, cy, fx, fy (float32 values)
    xs: torch.Tensor
    ys: torch.Tensor
    idepth: torch.Tensor
    tmpl: torch.Tensor
    jac: torch.Tensor  # (N, 6)


def level_intrinsics(k, nb_levels: int):
    """(cx, cy, fx, fy) a level in float32: each halving maps c to (c + 0.5) / 2 - 0.5."""
    cx, cy, fx, fy = (np.float32(v) for v in k)
    out = [(cx, cy, fx, fy)]
    half, one_half = np.float32(0.5), np.float32(2.0)
    for _ in range(1, nb_levels):
        cx, cy = (cx + half) / one_half - half, (cy + half) / one_half - half
        fx, fy = half * fx, half * fy
        out.append((cx, cy, fx, fy))
    return out


def warp_jacobian(gu, gv, u, v, z, k):
    cu, cv, fu, fv = (float(x) for x in k)
    a, b = u - cu, v - cv
    c = a * fv
    return torch.stack([
        gu * z * fu,
        z * (gv * fv),
        -z * (gu * a + gv * b),
        gu * (-a * b / fv) + gv * (-b * b / fv - fv),
        gu * (a * c / (fu * fv) + fu) + gv * (b * c / (fu * fv)),
        gu * (-fu * fu * b) / (fu * fv) + gv * (c / fu),
    ], dim=-1)


def keyframe(s: Settings, k, depth: torch.Tensor, img: torch.Tensor) -> List[Level]:
    """The candidates of every level of a keyframe (``depth`` int, ``img`` u8, (H, W))."""
    pyr = pyramid(img, s.nb_levels)
    grads = gradients(pyr)
    ids = idepth_pyramid(s, depth, candidate_mask(s.diff_threshold, grads))
    levels = []
    for lvl, ((idepth, known), (gx, gy), tmpl, kl) in enumerate(
            zip(ids, grads, pyr, level_intrinsics(k, s.nb_levels))):
        h, w = known.shape
        order = torch.from_numpy(visit_order(h, w)).to(known.device)
        idx = order[known.reshape(-1)[order]][: min(s.candidate_cap, h * w)]
        xs = (idx % w).to(F32)
        ys = torch.div(idx, w, rounding_mode="trunc").to(F32)
        z = idepth.reshape(-1)[idx]
        jac = warp_jacobian(gx.reshape(-1)[idx], gy.reshape(-1)[idx], xs, ys, z, kl)
        levels.append(Level(kl, xs, ys, z, tmpl.reshape(-1)[idx].to(F32), jac))
    return levels


# ---------------------------------------------------------------------------
# the frame solve
# ---------------------------------------------------------------------------


def warp(model, lv: Level):
    """Back-project at the inverse depth, move by ``model``, project."""
    cx, cy, fx, fy = (float(v) for v in lv.k)
    q, t = (x.to(lv.xs.device) for x in model)
    z = 1.0 / lv.idepth
    y1 = (lv.ys - cy) * z / fy
    x1 = ((lv.xs - cx) * z) / fx
    p = torch.stack([x1, y1, z])
    u, w = q[1:, None], q[0]
    tv = 2.0 * torch.stack([u[1] * p[2] - u[2] * p[1], u[2] * p[0] - u[0] * p[2], u[0] * p[1] - u[1] * p[0]])
    p2 = p + w * tv + torch.stack([u[1] * tv[2] - u[2] * tv[1], u[2] * tv[0] - u[0] * tv[2],
                                   u[0] * tv[1] - u[1] * tv[0]]) + t[:, None]
    return (fx * p2[0] + cx * p2[2]) / p2[2], (fy * p2[1] + cy * p2[2]) / p2[2]


def sample(img: torch.Tensor, x, y):
    """Bilinear values and the domain ``0 <= floor < size - 2``."""
    h, w = img.shape
    u, v = torch.floor(x), torch.floor(y)
    inside = (u >= 0) & (u < w - 2) & (v >= 0) & (v < h - 2)
    zero = torch.zeros_like(u)
    i00 = (torch.where(inside, v, zero) * w + torch.where(inside, u, zero)).to(torch.int64)
    flat = img.reshape(-1).to(F32)
    a, b = x - u, y - v
    val = ((1 - b) * (1 - a) * flat[i00] + b * (1 - a) * flat[i00 + w]
           + (1 - b) * a * flat[i00 + 1] + b * a * flat[i00 + w + 1])
    return torch.where(inside, val, zero), inside


def evaluate(lv: Level, img, model, eval_dtype=F32):
    """energy (mean r^2 over the inside candidates, NaN if none), H (6, 6), g (6,), on the host."""
    u, v = warp(model, lv)
    vals, inside = sample(img, u, v)
    r = torch.where(inside, vals - lv.tmpl, torch.zeros_like(vals)).to(eval_dtype)
    jac = lv.jac.to(eval_dtype)
    jm = jac * inside.to(eval_dtype)[:, None]
    hess = (jm[:, :, None] * jac[:, None, :]).sum(0)
    grad = (jm * r[:, None]).sum(0)
    rsq = (r * r).sum()
    count = inside.sum().to(eval_dtype)
    out = torch.cat([hess.reshape(-1), grad, rsq[None], count[None]]).to(F32).cpu()
    return out[42] / out[43], out[:36].reshape(6, 6), out[36:42]


def damped_solve(hess, grad, lm):
    damped = hess * (1.0 + lm * torch.eye(6, dtype=F32))
    chol, info = torch.linalg.cholesky_ex(damped)
    if int(info) != 0:
        return torch.full((6,), float("nan"), dtype=F32)
    return torch.cholesky_solve(grad[:, None], chol)[:, 0]


def solve_level(s: Settings, lv: Level, img, model_in, eval_dtype=F32):
    """One level's LM loop: (accepted model, failed, nb_iter, nb_evals)."""
    lm = torch.tensor(s.lm_coef_init, dtype=F32)
    candidate = model_in
    model = energy = hess = grad = None
    nb_iter = nb_evals = 0
    failed = False
    while True:
        new_energy, new_hess, new_grad = evaluate(lv, img, candidate, eval_dtype)
        accept, cont = True, True
        if nb_evals > 0:
            rejected = bool(new_energy > energy)  # False for NaN: accepted
            accept = not rejected
            cont = nb_iter <= s.max_iterations and (rejected or bool(energy - new_energy > s.energy_tol))
            lm = lm * (10.0 if rejected else 0.1)
        nb_evals += 1
        if accept:
            model, energy, hess, grad = candidate, new_energy, new_hess, new_grad
        if not (cont and nb_iter < s.max_iterations + 3):
            break
        nb_iter += 1
        candidate = lm_step(model, damped_solve(hess, grad, lm))
        if not (torch.isfinite(candidate[0]).all() and torch.isfinite(candidate[1]).all()):
            failed = True
            break
    return model, failed, nb_iter, nb_evals


def mean_flow(lv: Level, model) -> float:
    u, v = warp(model, lv)
    return float((torch.abs(lv.xs - u) + torch.abs(lv.ys - v)).sum() / lv.xs.numel())


class FrameResult(NamedTuple):
    model: Tuple[torch.Tensor, torch.Tensor]  # keyframe -> frame, float32 on the host
    failed: bool
    flow: float
    nb_iters: Tuple[int, ...]  # per level, finest first


def track(s: Settings, kf: List[Level], img: torch.Tensor, init_model, eval_dtype=F32) -> FrameResult:
    """Coarse-to-fine solve of one frame (u8 (H, W)) against a keyframe,
    from ``init_model`` (host float32 (q, t))."""
    pyr = pyramid(img, s.nb_levels)
    model, failed = init_model, False
    iters = [0] * s.nb_levels
    for lvl in reversed(range(s.nb_levels)):
        new_model, lvl_failed, iters[lvl], _ = solve_level(s, kf[lvl], pyr[lvl], model, eval_dtype)
        if not (failed or lvl_failed):
            model = new_model
        failed = failed or lvl_failed
    return FrameResult(model, failed, mean_flow(kf[-1], model), tuple(iters))


def frame_pose(kf_pose, prev_pose, result: FrameResult):
    """The camera pose a frame result gives: ``kf_pose * model^-1``, or the
    previous pose if the frame failed.  Poses are host float32 (q, t)."""
    if result.failed:
        return prev_pose
    return compose(kf_pose, inverse(result.model))


def warm_start(kf_pose, prev_pose):
    """The constant-position start of a frame: ``prev^-1 * kf_pose``."""
    return compose(inverse(prev_pose), kf_pose)
