"""Inverse-compositional se(3) RGB-D tracker, in PyTorch.

The port of the streaming path of ``visual_odometry_rs_tpu/models/tracker.py``
(reference ``inverse_compositional.rs`` + ``lm_optimizer.rs``): coarse-to-fine
candidates over a u8 mean pyramid, per-keyframe warp Jacobians, a per-frame
coarse-to-fine Levenberg-Marquardt alignment on se(3), and the keyframe
switch on mean optical flow >= 1 px at the coarsest level.

On a GPU the whole LM solve of a level is one launch of the hand-written
kernel ``ops.lm_solve.lm_solve_level``; a frame is six launches chained
through one device buffer, and the host reads the device once per frame.
On the CPU ``solve_level`` is ``solve_level_reference``: the Python LM loop
(``math.optimizer.iterative_solve``) whose evaluations (``_eval_full``) go
through ``ops.residual.residual_reduce``.

Candidate arrays keep static per-level capacities with a ``valid`` mask, and
their order is the JAX package's: 128-pixel chunks visited in bit-reversed
order, natural order inside a chunk, truncated at the level cap.  The JAX
package builds that order with one-hot matmuls; here it is a cumsum and a
scatter.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..core import camera as camera_mod
from ..core import inverse_depth as idepth_mod
from ..core.camera import Intrinsics
from ..core.candidates import coarse_to_fine
from ..math import pose as pose_mod
from ..math import se3
from ..math.optimizer import LMState, SolveResult, damped_solve, iterative_solve, lm_update
from ..math.pose import Pose
from ..ops import gradient as gradient_ops
from ..ops import lm_solve
from ..ops import pyramid as pyramid_ops
from ..ops import residual
from ..utils.types import Float, depth_tensor, image_tensor, resolve_device


@dataclass(frozen=True)
class TrackerConfig:
    """Static tracker configuration: the fields of the JAX ``TrackerConfig``
    that the streaming path uses, with the same defaults."""

    height: int
    width: int
    nb_levels: int = 6
    candidates_diff_threshold: int = 7
    depth_scale: float = 5000.0
    idepth_variance: float = 1e-4
    lm_coef_init: float = 0.1
    max_iterations: int = 20
    energy_tol: float = 1.0
    # per-level LM iteration caps, finest first; None = max_iterations
    level_max_iterations: Tuple[int, ...] | None = None
    # "constant_position" (reference) or "constant_velocity"
    warm_start: str = "constant_position"
    flow_threshold: float = 1.0
    candidate_cap: int = 8192
    # host Tracker only: slice each level to a power-of-two bucket >= count
    bucket_candidates: bool = False
    min_bucket: int = 256

    def level_shapes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(pyramid_ops.level_shapes(self.height, self.width, self.nb_levels))

    def level_iterations(self, lvl: int) -> int:
        """LM iteration cap for pyramid level ``lvl`` (0 = finest)."""
        if self.level_max_iterations is None:
            return self.max_iterations
        if len(self.level_max_iterations) != self.nb_levels:
            raise ValueError(
                f"level_max_iterations must have nb_levels={self.nb_levels} "
                f"entries, got {len(self.level_max_iterations)}"
            )
        return self.level_max_iterations[lvl]

    def level_caps(self) -> Tuple[int, ...]:
        return tuple(min(self.candidate_cap, h * w) for h, w in self.level_shapes())


class LevelObs(NamedTuple):
    """Per-level keyframe data; ``valid`` masks the padded candidates."""

    intrinsics: Intrinsics
    template: torch.Tensor  # (H, W) u8 keyframe image at this level
    xs: torch.Tensor  # (N,) f32 candidate column coords
    ys: torch.Tensor  # (N,) f32 candidate row coords
    idepth: torch.Tensor  # (N,) f32 inverse depths
    valid: torch.Tensor  # (N,) bool: real candidate vs padding
    tmpl_vals: torch.Tensor  # (N,) f32 template intensities at candidates
    jacobians: torch.Tensor  # (N, 6) f32 warp jacobians


class KeyframeData(NamedTuple):
    levels: Tuple[LevelObs, ...]


def warp_jacobian(gu, gv, u, v, idepth, k: Intrinsics) -> torch.Tensor:
    """Analytic 6-dof inverse-compositional warp Jacobian, (…, 6)
    (inverse_compositional.rs:313-341)."""
    cu, cv, fu, fv, s = k.cx, k.cy, k.fx, k.fy, k.skew
    a = u - cu
    b = v - cv
    c = a * fv - s * b
    inv_fv = 1.0 / fv
    inv_fuv = 1.0 / (fu * fv)
    z = idepth
    return torch.stack(
        [
            gu * z * fu,
            z * (gu * s + gv * fv),
            -z * (gu * a + gv * b),
            gu * (-a * b * inv_fv - s) + gv * (-b * b * inv_fv - fv),
            gu * (a * c * inv_fuv + fu) + gv * (b * c * inv_fuv),
            gu * (-fu * fu * b + s * c) * inv_fuv + gv * (c / fu),
        ],
        dim=-1,
    )


@lru_cache(maxsize=64)
def _bit_reversal_order(n: int) -> np.ndarray:
    """Indices 0..n-1 in ascending bit-reversed order (a spatially
    stratified visit order)."""
    nbits = max(1, (n - 1).bit_length())
    r = np.arange(1 << nbits, dtype=np.int64)
    rev = np.zeros_like(r)
    x = r.copy()
    for _ in range(nbits):
        rev = (rev << 1) | (x & 1)
        x >>= 1
    return rev[rev < n]


_EXTRACT_CHUNK = 128


def _compaction_indices(known: torch.Tensor, cap: int):
    """Flat pixel indices of the first ``cap`` known pixels in visit order,
    and the ``valid`` mask of the (cap,) slots.

    Visit order: 128-pixel chunks in ``_bit_reversal_order(n_chunks)``,
    natural order inside a chunk (the order of the JAX package's
    ``_extract_level_onehot``).  Invalid slots hold index 0.
    """
    device = known.device
    hw = known.numel()
    m = _EXTRACT_CHUNK
    n_chunks = -(-hw // m)
    known_pad = torch.zeros(n_chunks * m, dtype=torch.bool, device=device)
    known_pad[:hw] = known.reshape(-1)
    chunk_perm = torch.from_numpy(_bit_reversal_order(n_chunks)).to(device)
    perm = (chunk_perm[:, None] * m + torch.arange(m, device=device)).reshape(-1)
    known_p = known_pad[perm]
    ranks = torch.cumsum(known_p.to(torch.int64), dim=0) - 1
    take = known_p & (ranks < cap)
    dest = torch.where(take, ranks, torch.full_like(ranks, cap))  # cap = dump slot
    idxs = torch.zeros(cap + 1, dtype=torch.int64, device=device).scatter_(0, dest, perm)[:cap]
    total = torch.clamp(known_p.sum(), max=cap)
    valid = torch.arange(cap, device=device) < total
    return torch.where(valid, idxs, torch.zeros_like(idxs)), valid


def precompute_keyframe(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    depth_map: torch.Tensor,
    img_pyramid: List[torch.Tensor],
) -> KeyframeData:
    """All per-keyframe data (inverse_compositional.rs:105-161): candidate
    masks by coarse-to-fine gradient selection, the DSO-mean inverse-depth
    pyramid, and per-level candidates with template values and Jacobians.

    ``depth_map`` is the int32 depth tensor on the pyramid's device.
    """
    nb_levels = len(img_pyramid)
    intr_levels = camera_mod.multi_res(intrinsics, nb_levels)
    grads = [gradient_ops.centered_f32(img_pyramid[0])]
    grads.extend(gradient_ops.gradients_xy_f32(img_pyramid))
    sqn = [gradient_ops.squared_norm_f32(gx, gy) for gx, gy in grads]
    finest_mask = coarse_to_fine.select(config.candidates_diff_threshold, sqn)[-1]
    id0 = idepth_mod.masked(
        idepth_mod.from_depth(config.depth_scale, depth_map, config.idepth_variance),
        finest_mask,
    )
    id_levels = idepth_mod.pyramid(id0, nb_levels)

    caps = config.level_caps()
    levels = []
    for lvl in range(nb_levels):
        k = intr_levels[lvl]
        gx, gy = grads[lvl]
        img = img_pyramid[lvl]
        w = img.shape[-1]
        idx, valid = _compaction_indices(id_levels[lvl].known, caps[lvl])
        zero = torch.zeros(idx.shape, dtype=Float, device=idx.device)
        xs = (idx % w).to(Float)
        ys = torch.div(idx, w, rounding_mode="trunc").to(Float)
        gu = torch.where(valid, gx.reshape(-1)[idx], zero)
        gv = torch.where(valid, gy.reshape(-1)[idx], zero)
        tmpl_vals = torch.where(valid, img.reshape(-1)[idx].to(Float), zero)
        # at level 0 this is scale / max(depth, 1) of the raw depth, the value
        # the JAX package recomputes from the gathered depth bytes
        z = torch.where(valid, id_levels[lvl].idepth.reshape(-1)[idx], zero)
        jac = warp_jacobian(gu, gv, xs, ys, z, k)
        jac = torch.where(valid[:, None], jac, torch.zeros_like(jac))
        levels.append(
            LevelObs(
                intrinsics=k, template=img, xs=xs, ys=ys, idepth=z, valid=valid,
                tmpl_vals=tmpl_vals, jacobians=jac,
            )
        )
    return KeyframeData(levels=tuple(levels))


# ---------------------------------------------------------------------------
# Per-level LM solve
# ---------------------------------------------------------------------------


def _eval_energy(obs: LevelObs, image: torch.Tensor, model: Pose):
    """Warp + sample + residual pass (lm_optimizer.rs:68-87): ``(energy, r,
    inside)``, energy = Σ_inside r² / #inside (NaN when nothing is inside).
    Plain torch on every device: the streaming path evaluates through
    ``_eval_full``; this energy-only pass serves lost-track detection."""
    r, inside = residual.residuals(
        image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, model, obs.intrinsics
    )
    return torch.sum(r * r) / torch.sum(inside).to(Float), r, inside


def _eval_full(obs: LevelObs, image: torch.Tensor, model: Pose, out=None):
    """Energy, ``Jᵀr`` and ``Σ JᵀJ`` of one LM evaluation
    (lm_optimizer.rs:68-107).  energy = Σ_inside r² / #inside: NaN when no
    candidate lands inside, like the reference.  ``out`` is passed on to
    ``residual_reduce``."""
    params = torch.cat([model.q, model.t, obs.intrinsics.vector()])
    m, rsq, count = residual.residual_reduce(
        image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians, params,
        out=out,
    )
    return rsq / count, m[:, 6], m[:, :6]


def solve_level_reference(
    obs: LevelObs,
    image: torch.Tensor,
    model0: Pose,
    *,
    lm_coef_init: float = 0.1,
    max_iterations: int = 20,
    energy_tol: float = 1.0,
) -> SolveResult:
    """The LM solve of one level as a Python loop: the plain version of
    ``ops.lm_solve.lm_solve_level`` (lm_optimizer.rs:111-193).  Damp the
    diagonal by (1+λ), solve the 6x6 system by Cholesky, update
    ``model ∘ exp(δ)⁻¹`` and renormalize the quaternion to first order.
    The host reads the device once per iteration.  On CUDA tensors its
    evaluations launch the ``residual_reduce`` kernel."""
    # one output row per evaluation: an accepted state keeps views of its row
    outs = None
    if image.device.type == "cuda":
        outs = iter(
            torch.empty((max_iterations + 4, residual.OUT_SIZE), dtype=Float, device=image.device)
        )

    def evaluate(model):
        return _eval_full(obs, image, model, out=None if outs is None else next(outs))

    def init(_, model):
        energy, grad, hess = evaluate(model)
        lm_coef = torch.full((), lm_coef_init, dtype=Float, device=image.device)
        return LMState(model, energy, grad, hess, lm_coef)

    def step(state):
        delta = damped_solve(state.hessian, state.gradient, state.lm_coef)
        new_model = pose_mod.compose(state.model, pose_mod.inverse(se3.exp(delta)))
        return pose_mod.renormalize_first_order(new_model)

    def eval_fn(_, state, new_model):
        return (new_model, *evaluate(new_model))

    def stop(state, nb_iter, eval_out):
        new_model, energy, grad, hess = eval_out
        return lm_update(
            state, nb_iter, new_model, energy, grad, hess,
            max_iterations=max_iterations, energy_tol=energy_tol,
        )

    return iterative_solve(
        None, model0, init=init, step=step, eval_fn=eval_fn, stop_criterion=stop,
        max_iterations=max_iterations + 3,
    )


def _launch_level(obs: LevelObs, image, state_in, record, **kwargs):
    return lm_solve.lm_solve_level(
        image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians,
        obs.intrinsics.vector(), state_in, record, **kwargs,
    )


def _start_state(model: Pose) -> torch.Tensor:
    """``state_in`` of a frame's first launch: the pose, nothing failed yet."""
    return torch.cat([model.q, model.t, model.t.new_zeros(1)])


def solve_level(
    obs: LevelObs,
    image: torch.Tensor,
    model0: Pose,
    *,
    lm_coef_init: float = 0.1,
    max_iterations: int = 20,
    energy_tol: float = 1.0,
) -> SolveResult:
    """LM solve of one pyramid level (lm_optimizer.rs:111-193).

    CPU tensors take ``solve_level_reference``; CUDA tensors launch the
    ``lm_solve_level`` kernel once, and ``nb_iter`` and ``failed`` of the
    result are then 0-d device tensors: nothing is read on the host."""
    kwargs = dict(lm_coef_init=lm_coef_init, max_iterations=max_iterations, energy_tol=energy_tol)
    if image.device.type == "cpu":
        return solve_level_reference(obs, image, model0, **kwargs)
    record = torch.empty((lm_solve.RECORD_SIZE,), dtype=Float, device=image.device)
    _launch_level(obs, image, _start_state(model0), record, **kwargs)
    pose = record[lm_solve.POSE]
    m = record[lm_solve.NORMAL_EQUATIONS].view(6, 7)
    state = LMState(
        Pose(pose[0:4], pose[4:7]), record[lm_solve.ENERGY], m[:, 6], m[:, :6],
        record[lm_solve.LM_COEF],
    )
    return SolveResult(
        state=state, nb_iter=record[lm_solve.NB_ITER].to(torch.int32),
        failed=record[lm_solve.FAILED] != 0,
    )


# ---------------------------------------------------------------------------
# Per-frame tracking
# ---------------------------------------------------------------------------


def warm_start_init(
    config: TrackerConfig, keyframe_pose: Pose, current_pose: Pose,
    prev_pose: Pose | None = None,
) -> Pose:
    """Initial keyframe→frame model: ``cur⁻¹ ∘ kfp`` (constant_position,
    inverse_compositional.rs:177), or with ``constant_velocity`` the
    extrapolation ``pred = cur ∘ (prev⁻¹ ∘ cur)`` and ``pred⁻¹ ∘ kfp``."""
    if config.warm_start not in ("constant_position", "constant_velocity"):
        raise ValueError(f"unknown warm_start {config.warm_start!r}")
    if config.warm_start == "constant_position" or prev_pose is None:
        return pose_mod.compose(pose_mod.inverse(current_pose), keyframe_pose)
    vel = pose_mod.compose(pose_mod.inverse(prev_pose), current_pose)
    pred = pose_mod.renormalize_first_order(pose_mod.compose(current_pose, vel))
    return pose_mod.compose(pose_mod.inverse(pred), keyframe_pose)


class TrackResult(NamedTuple):
    model: Pose  # keyframe → current-frame motion estimate
    failed: torch.Tensor  # 0-d bool: some level's Cholesky failed
    flow: torch.Tensor  # 0-d: mean abs optical flow at the coarsest level (px)
    nb_iters: torch.Tensor  # (nb_levels,) int32: LM iterations per level, 0 = finest
    nb_evals: torch.Tensor  # (nb_levels,) int32: LM evaluations per level


def _level_kwargs(config: TrackerConfig, lvl: int) -> dict:
    return dict(
        lm_coef_init=config.lm_coef_init,
        max_iterations=config.level_iterations(lvl),
        energy_tol=config.energy_tol,
    )


def _mean_flow(model: Pose, coarse: LevelObs) -> torch.Tensor:
    """Optical-flow keyframe criterion at the coarsest level
    (inverse_compositional.rs:211-222): mean |Δu| + |Δv| over the candidates.
    Padding candidates warp to NaN and make the mean NaN, which never
    triggers a switch, as in the JAX package."""
    u, v = camera_mod.warp(model, coarse.xs, coarse.ys, coarse.idepth, coarse.intrinsics)
    dflow = torch.abs(coarse.xs - u) + torch.abs(coarse.ys - v)
    validf = coarse.valid.to(Float)
    return torch.sum(dflow * validf) / torch.sum(validf)


def _track_frame_kernel(config, kf, img_pyramid, init_model) -> TrackResult:
    """Coarse-to-fine ``lm_solve_level``: one launch per level, each reading
    its start pose and the failed-so-far flag from the record of the level
    before; the finest level's launch also computes the flow.  No host read."""
    records = torch.empty(
        (config.nb_levels, lm_solve.RECORD_SIZE), dtype=Float, device=init_model.q.device
    )
    coarse = kf.levels[-1]
    state = _start_state(init_model)
    for lvl in reversed(range(config.nb_levels)):
        flow_of = None
        if lvl == 0:  # the last launch: its handed-on pose is the frame's
            flow_of = (coarse.xs, coarse.ys, coarse.idepth, coarse.valid, coarse.intrinsics.vector())
        _launch_level(
            kf.levels[lvl], img_pyramid[lvl], state, records[lvl],
            flow_of=flow_of, **_level_kwargs(config, lvl),
        )
        state = records[lvl, : lm_solve.STATE_SIZE]
    counts = records[:, lm_solve.NB_ITER : lm_solve.NB_EVALS + 1].to(torch.int32)
    return TrackResult(
        model=Pose(state[0:4], state[4:7]), failed=state[lm_solve.FAILED_SO_FAR] != 0,
        flow=records[0, lm_solve.FLOW], nb_iters=counts[:, 0], nb_evals=counts[:, 1],
    )


def track_frame(
    config: TrackerConfig,
    kf: KeyframeData,
    img_pyramid: List[torch.Tensor],
    init_model: Pose,
) -> TrackResult:
    """Coarse-to-fine LM alignment of one frame against the keyframe
    (inverse_compositional.rs:170-240).  After a failed level the model is
    frozen for the rest of the frame; the remaining levels still run, as in
    the JAX package, so their iteration counts are reported.

    CUDA tensors go through the ``lm_solve_level`` kernel (one launch per
    level, no host read); CPU tensors through ``track_frame_reference``."""
    if init_model.q.device.type == "cpu":
        return track_frame_reference(config, kf, img_pyramid, init_model)
    return _track_frame_kernel(config, kf, img_pyramid, init_model)


def track_frame_reference(
    config: TrackerConfig,
    kf: KeyframeData,
    img_pyramid: List[torch.Tensor],
    init_model: Pose,
) -> TrackResult:
    """``track_frame`` through ``solve_level_reference``, chained on the
    host, on any device: the plain version that the kernel path is held
    against."""
    model = init_model
    failed = False
    nb_iters = [0] * config.nb_levels
    for lvl in reversed(range(config.nb_levels)):
        result = solve_level_reference(
            kf.levels[lvl], img_pyramid[lvl], model, **_level_kwargs(config, lvl)
        )
        if not (failed or result.failed):
            model = result.state.model
        failed = failed or result.failed
        nb_iters[lvl] = result.nb_iter
    device = init_model.q.device
    nb_iters = torch.tensor(nb_iters, dtype=torch.int32, device=device)
    return TrackResult(
        model=model, failed=torch.tensor(failed, device=device),
        flow=_mean_flow(model, kf.levels[-1]), nb_iters=nb_iters,
        nb_evals=nb_iters + 1,  # the loop evaluates once at the start and once per iteration
    )


# ---------------------------------------------------------------------------
# Host-side Tracker: the reference's 4-call product API
# ---------------------------------------------------------------------------


class Tracker:
    """Stateful camera tracker over an RGB-D stream (``Config::init`` →
    ``Tracker::track`` → ``Tracker::current_frame``, vors_track.rs:34-63).

    Images and depth maps come as numpy arrays or tensors; they are moved to
    ``device`` here, which is the GPU unless the caller names another.  The
    tracker's own three poses (keyframe, current, previous) are 7 floats each
    and live on the host, where composing them costs microseconds.  On a GPU
    the host reads the device once per frame (the solved pose, flow, failed
    flag and per-level counts in one transfer), and once more on a keyframe
    switch with bucketing on.
    """

    # the frame solver; a subclass may put ``track_frame_reference`` here
    _track_frame = staticmethod(track_frame)

    def __init__(
        self,
        config: TrackerConfig,
        intrinsics: Intrinsics,
        depth_timestamp: float,
        depth_map,
        img_timestamp: float,
        img,
        device="cuda",
    ):
        self.config = config
        self.device = resolve_device(device)
        self.intrinsics = intrinsics.to(self.device)
        pyr = pyramid_ops.mean_pyramid(config.nb_levels, image_tensor(img, self.device))
        self.keyframe_data = self._precompute(depth_map, pyr)
        self.keyframe_pose = pose_mod.identity()
        self.keyframe_depth_timestamp = depth_timestamp
        self.keyframe_img_timestamp = img_timestamp
        self.current_pose = pose_mod.identity()
        # previous frame's pose, for the constant-velocity warm start
        self.prev_pose = self.current_pose
        self.current_depth_timestamp = depth_timestamp
        self.current_img_timestamp = img_timestamp
        self.last_flow: float = 0.0
        self.last_failed: bool = False
        self.last_nb_iters: Tuple[int, ...] = (0,) * config.nb_levels
        self.last_nb_evals: Tuple[int, ...] = (0,) * config.nb_levels
        self.keyframe_switches: int = 0

    def _precompute(self, depth_map, pyr) -> KeyframeData:
        kf = precompute_keyframe(
            self.config, self.intrinsics, depth_tensor(depth_map, self.device), pyr
        )
        return self._maybe_bucket(kf)

    def track(self, depth_timestamp: float, depth_map, img_timestamp: float, img) -> None:
        """Track one frame (inverse_compositional.rs:170-240)."""
        pyr = pyramid_ops.mean_pyramid(self.config.nb_levels, image_tensor(img, self.device))
        init_model = warm_start_init(
            self.config, self.keyframe_pose, self.current_pose, self.prev_pose
        ).to(self.device)
        result = self._track_frame(self.config, self.keyframe_data, pyr, init_model)
        # the frame's one device→host read
        stats = torch.cat(
            [torch.stack([result.flow, result.failed.to(Float)]),
             result.nb_iters.to(Float), result.nb_evals.to(Float), result.model.q, result.model.t]
        ).cpu()
        levels = self.config.nb_levels
        values = stats.tolist()
        self.last_flow = values[0]
        self.last_failed = values[1] != 0.0
        self.last_nb_iters = tuple(int(n) for n in values[2 : 2 + levels])
        self.last_nb_evals = tuple(int(n) for n in values[2 + levels : 2 + 2 * levels])
        model = Pose(stats[-7:-3], stats[-3:])

        self.current_depth_timestamp = depth_timestamp
        self.current_img_timestamp = img_timestamp
        self.prev_pose = self.current_pose
        # a failed frame keeps the pose, which also zeroes the velocity of the
        # next warm start
        if not self.last_failed:
            self.current_pose = pose_mod.compose(self.keyframe_pose, pose_mod.inverse(model))

        if self.last_flow >= self.config.flow_threshold:
            self.keyframe_data = self._precompute(depth_map, pyr)
            self.keyframe_depth_timestamp = depth_timestamp
            self.keyframe_img_timestamp = img_timestamp
            self.keyframe_pose = self.current_pose
            self.keyframe_switches += 1

    def _maybe_bucket(self, kf: KeyframeData) -> KeyframeData:
        """Slice each level's candidates to the smallest power-of-two bucket
        >= its count (at least ``min_bucket``, at most the level cap).  Valid
        candidates are compacted to the front, so the slice keeps them all.
        One host sync reads the counts of all levels."""
        if not self.config.bucket_candidates:
            return kf
        counts = torch.stack([obs.valid.sum() for obs in kf.levels]).tolist()
        levels = []
        for obs, count in zip(kf.levels, counts):
            bucket = max(self.config.min_bucket, 1 << (max(count, 1) - 1).bit_length())
            b = min(bucket, obs.valid.shape[0])
            levels.append(
                obs._replace(
                    xs=obs.xs[:b], ys=obs.ys[:b], idepth=obs.idepth[:b],
                    valid=obs.valid[:b], tmpl_vals=obs.tmpl_vals[:b],
                    jacobians=obs.jacobians[:b],
                )
            )
        return KeyframeData(levels=tuple(levels))

    def current_frame(self) -> Tuple[float, Pose]:
        """(depth timestamp, pose) of the last tracked frame."""
        return self.current_depth_timestamp, self.current_pose


def init_tracker(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    depth_timestamp: float,
    depth_map,
    img_timestamp: float,
    img,
    device="cuda",
) -> Tracker:
    """The analog of ``Config::init`` (inverse_compositional.rs:74-100).
    Runs on the GPU, and raises without one, unless ``device`` says "cpu"."""
    return Tracker(config, intrinsics, depth_timestamp, depth_map, img_timestamp, img, device)
