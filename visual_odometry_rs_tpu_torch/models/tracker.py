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

``precompute_keyframe`` and ``track_frame`` also take a leading lane axis
(one sequence per lane, the batched tracker of ``parallel.batch``): on a GPU
the precompute is two launches of the hand-written kernels of
``ops.precompute`` (on the CPU its plain version,
``precompute_keyframe_reference``, one set of tensor operations) and
``track_frame`` six launches, each solving one level for every lane.  The
intrinsics are shared by all lanes.

The tracker's options (the JAX package's ``TrackerConfig`` fields of the
same names) run in the same launches: Huber weights (``robust_delta``) and
the affine brightness model (``brightness_model``: the pose and a per-frame
gain and bias solved together) are instantiations of the solver kernel; the
lost-frame detector of relocalization (``relocalize_window``) is computed by
the finest level's launch; the DSO selectors (``candidate_selector``) change
only which pixels the keyframe precompute keeps.  Each has a plain version
on the CPU path, and nothing on the CUDA path falls back to it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..core import camera as camera_mod
from ..core import inverse_depth as idepth_mod
from ..core.camera import Intrinsics
from ..core.candidates import coarse_to_fine
from ..core.candidates import dso as dso_mod
from ..math import pose as pose_mod
from ..math import se3
from ..math.optimizer import LMState, SolveResult, damped_solve, iterative_solve, lm_update
from ..math.pose import Pose
from ..ops import gradient as gradient_ops
from ..ops import lm_solve
from ..ops import precompute as precompute_ops
from ..ops import pyramid as pyramid_ops
from ..ops import residual
from ..utils import profiling
from ..utils.types import Float, depth_tensor, image_tensor, resolve_device


@dataclass(frozen=True)
class TrackerConfig:
    """Static tracker configuration: the fields of the JAX ``TrackerConfig``
    that the streaming and batched paths use, with the same defaults, and
    ``dso_seed``, the seed of the DSO selectors' random thinning: the plane
    is ``randint(PRNGKey(dso_seed), shape, 0, 256)`` with JAX's bits, and
    the JAX package always draws from ``PRNGKey(0)``."""

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
    # Huber IRLS weights on the photometric residuals; 0 = off (plain L2)
    robust_delta: float = 0.0
    # per-frame affine brightness (gain a, bias b) solved with the pose
    brightness_model: bool = False
    # keep the last K unbucketed keyframes and recover a lost frame (failed,
    # or finest-level plain energy not finite or above the accept energy)
    # against them; 0 = off
    relocalize_window: int = 0
    relocalize_energy_accept: float = 150.0
    relocalize_min_inside_frac: float = 0.5
    # "coarse_to_fine", "dso" (host Tracker only: a host recursion on the
    # block size) or "dso_fixed" (one pass at dso_block_size, no host read)
    candidate_selector: str = "coarse_to_fine"
    dso_target: int = 2000
    dso_block_size: int = 4
    dso_threshold_coef_a: float = 1.0
    dso_threshold_coef_b: int = 3
    dso_seed: int = 0

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
    and the ``valid`` mask of the (…, cap) slots, per lane of ``known``
    (…, H, W).

    Visit order: 128-pixel chunks in ``_bit_reversal_order(n_chunks)``,
    natural order inside a chunk (the order of the JAX package's
    ``_extract_level_onehot``).  Invalid slots hold index 0.
    """
    device = known.device
    lead = known.shape[:-2]
    hw = known.shape[-2] * known.shape[-1]
    m = _EXTRACT_CHUNK
    n_chunks = -(-hw // m)
    known_pad = torch.zeros((*lead, n_chunks * m), dtype=torch.bool, device=device)
    known_pad[..., :hw] = known.reshape(*lead, hw)
    chunk_perm = torch.from_numpy(_bit_reversal_order(n_chunks)).to(device)
    perm = (chunk_perm[:, None] * m + torch.arange(m, device=device)).reshape(-1)
    known_p = known_pad[..., perm]
    ranks = torch.cumsum(known_p.to(torch.int64), dim=-1) - 1
    take = known_p & (ranks < cap)
    dest = torch.where(take, ranks, torch.full_like(ranks, cap))  # cap = dump slot
    idxs = torch.zeros((*lead, cap + 1), dtype=torch.int64, device=device)
    idxs = idxs.scatter_(-1, dest, perm.expand_as(dest))[..., :cap]
    total = torch.clamp(known_p.sum(dim=-1, keepdim=True), max=cap)
    valid = torch.arange(cap, device=device) < total
    return torch.where(valid, idxs, torch.zeros_like(idxs)), valid


def _region_config(config: TrackerConfig) -> dso_mod.RegionConfig:
    return dso_mod.RegionConfig(
        threshold_coef_a=config.dso_threshold_coef_a, threshold_coef_b=config.dso_threshold_coef_b
    )


def dso_mask(config: TrackerConfig, img: torch.Tensor) -> torch.Tensor:
    """The level-0 candidate mask of the ``dso`` selector: the host
    recursion ``core.candidates.dso.select`` on the image's gradient norm
    (one or two host reads)."""
    return dso_mod.select(
        gradient_ops.norm_direct(img), config.dso_target, region_config=_region_config(config),
        seed=config.dso_seed,
    )


def precompute_keyframe(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    depth_map: torch.Tensor,
    img_pyramid: List[torch.Tensor],
    finest_mask: torch.Tensor | None = None,
) -> KeyframeData:
    """All per-keyframe data (inverse_compositional.rs:105-161): candidate
    masks by coarse-to-fine gradient selection (or a DSO selector), the
    DSO-mean inverse-depth pyramid, and per-level candidates with template
    values and Jacobians.

    ``depth_map`` is the int32 depth tensor on the pyramid's device.  With a
    leading lane axis (depth (K, H, W), levels (K, h, w)) every leaf but the
    shared intrinsics carries it too, (K, N, …), bit-equal to K one-lane
    calls.  ``finest_mask`` replaces the level-0 candidate selection: it
    carries the ``dso`` selector's mask, whose host recursion cannot run
    here (``dso_mask``).  The keyframe of ``precompute_keyframe_counts``,
    which picks the kernels or the plain version by the device.
    """
    levels = level_intrinsics(intrinsics, len(img_pyramid))
    return precompute_keyframe_counts(config, levels, depth_map, img_pyramid, finest_mask)[0]


def precompute_keyframe_counts(
    config: TrackerConfig,
    levels: Tuple[List[Intrinsics], torch.Tensor],
    depth_map: torch.Tensor,
    img_pyramid: List[torch.Tensor],
    finest_mask: torch.Tensor | None = None,
    *,
    lanes: torch.Tensor | None = None,
    into: KeyframeData | None = None,
) -> Tuple[KeyframeData, torch.Tensor]:
    """``precompute_keyframe`` of the intrinsics whose ``level_intrinsics``
    are ``levels`` (a caller that precomputes many keyframes computes them
    once), and the valid candidates of each level, (…, L) int32 on the
    device: on CUDA the counts the candidate kernel writes beside the
    slots, so reading them launches nothing.

    ``lanes`` ((K,) int64 on the device) picks lanes of a batch, depth
    (B, H, W) and pyramid levels (B, h, w): the result is the keyframe of
    those K lanes (``finest_mask`` (K, H, W) if given).  With ``into``, a
    batched keyframe, lane ``lanes[k]`` goes into row ``lanes[k]`` of every
    lane field of ``into``, the template included, in place, and ``into``
    is returned: what ``index_copy(0, lanes, …)`` of the picked lanes'
    keyframe gives.

    CPU tensors take ``precompute_keyframe_reference`` of the picked lanes
    (then ``index_copy_``); CUDA tensors the two kernels of
    ``ops.precompute`` (the intrinsics on the same device), which read the
    picked lanes where they lie and write ``into``'s rows themselves, and
    whose every leaf is the reference's bits.
    """
    intr_levels, table = levels
    if depth_map.device.type == "cpu":
        if lanes is not None:
            depth_map, img_pyramid = depth_map.index_select(0, lanes), [p.index_select(0, lanes) for p in img_pyramid]
        kf = precompute_keyframe_reference(config, intr_levels[0], depth_map, img_pyramid, finest_mask)
        counts = torch.stack([obs.valid.sum(dim=-1) for obs in kf.levels], dim=-1).to(torch.int32)
        if into is None:
            return kf, counts
        for old, fresh in zip(into.levels, kf.levels):
            for f in LANE_FIELDS:
                getattr(old, f).index_copy_(0, lanes, getattr(fresh, f))
        return into, counts
    if finest_mask is None and config.candidate_selector != "coarse_to_fine":
        finest_mask = _selector_mask(config, img_pyramid[0] if lanes is None else img_pyramid[0].index_select(0, lanes))
    if finest_mask is not None:
        lead = depth_map.shape[:-2] if lanes is None else lanes.shape
        finest_mask = torch.broadcast_to(finest_mask, (*lead, *depth_map.shape[-2:])).to(torch.bool).contiguous()
    out = precompute_ops.keyframe_levels(
        img_pyramid, depth_map, table, config.level_caps(), finest_mask=finest_mask, lanes=lanes,
        into=None if into is None else [
            (obs.xs, obs.ys, obs.idepth, obs.valid, obs.tmpl_vals, obs.jacobians, obs.template)
            for obs in into.levels],
        **_kernel_settings(config),
    )
    if into is not None:
        return into, out
    fields, counts = out
    if lanes is not None:
        img_pyramid = [p.index_select(0, lanes) for p in img_pyramid]
    return KeyframeData(levels=tuple(
        LevelObs(k, img, *f) for k, img, f in zip(intr_levels, img_pyramid, fields)
    )), counts


def level_intrinsics(intrinsics: Intrinsics, nb_levels: int) -> Tuple[List[Intrinsics], torch.Tensor]:
    """``camera.multi_res`` of the intrinsics, and the same levels as one
    (L, 5) tensor ``[cx cy fx fy skew]``: the precompute kernels' input."""
    levels = camera_mod.multi_res(intrinsics, nb_levels)
    return levels, _intrinsics_table(levels)


def _intrinsics_table(levels: List[Intrinsics]) -> torch.Tensor:
    """The (L, 5) rows ``[cx cy fx fy skew]`` of ``levels``, in one stack."""
    return torch.stack([x for k in levels for x in k]).view(-1, 5)


def _kernel_settings(config: TrackerConfig) -> dict:
    return dict(scale=config.depth_scale, variance=config.idepth_variance,
                threshold=config.candidates_diff_threshold)


def _selector_mask(config: TrackerConfig, image0: torch.Tensor) -> torch.Tensor | None:
    """The finest mask of the configured selector: the ``dso_fixed``
    selector's, or None for ``coarse_to_fine``, which the kernels and the
    reference select themselves."""
    selector = config.candidate_selector
    if selector == "dso":
        raise ValueError(
            "candidate_selector='dso' needs its host recursion (dso_mask): use the host "
            "Tracker, pass finest_mask=, or use 'dso_fixed'.  The batched driver supports "
            "coarse_to_fine and dso_fixed."
        )
    if selector == "dso_fixed":
        return dso_mod.select_fixed_block(
            gradient_ops.norm_direct(image0), config.dso_target, block_size=config.dso_block_size,
            region_config=_region_config(config), seed=config.dso_seed,
        )
    if selector != "coarse_to_fine":
        raise ValueError(f"unknown candidate_selector {selector!r}")
    return None


def precompute_keyframe_reference(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    depth_map: torch.Tensor,
    img_pyramid: List[torch.Tensor],
    finest_mask: torch.Tensor | None = None,
) -> KeyframeData:
    """``precompute_keyframe`` as plain tensor operations, on any device:
    the plain version that the kernels are held against, and the CPU path
    (inverse_compositional.rs:105-161).  With a lane axis one set of tensor
    operations serves all lanes."""
    nb_levels = len(img_pyramid)
    intr_levels = camera_mod.multi_res(intrinsics, nb_levels)
    grads = [gradient_ops.centered_f32(img_pyramid[0])]
    grads.extend(gradient_ops.gradients_xy_f32(img_pyramid))
    if finest_mask is None:
        finest_mask = _selector_mask(config, img_pyramid[0])
    if finest_mask is None:  # coarse_to_fine
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

        def gather(x):
            return torch.gather(x.reshape(*x.shape[:-2], -1), -1, idx)

        zero = torch.zeros(idx.shape, dtype=Float, device=idx.device)
        xs = (idx % w).to(Float)
        ys = torch.div(idx, w, rounding_mode="trunc").to(Float)
        gu = torch.where(valid, gather(gx), zero)
        gv = torch.where(valid, gather(gy), zero)
        tmpl_vals = torch.where(valid, gather(img).to(Float), zero)
        # at level 0 this is scale / max(depth, 1) of the raw depth, the value
        # the JAX package recomputes from the gathered depth bytes
        z = torch.where(valid, gather(id_levels[lvl].idepth), zero)
        jac = warp_jacobian(gu, gv, xs, ys, z, k)
        jac = torch.where(valid[..., None], jac, torch.zeros_like(jac))
        levels.append(
            LevelObs(
                intrinsics=k, template=img, xs=xs, ys=ys, idepth=z, valid=valid,
                tmpl_vals=tmpl_vals, jacobians=jac,
            )
        )
    return KeyframeData(levels=tuple(levels))


LANE_FIELDS = ("template", "xs", "ys", "idepth", "valid", "tmpl_vals", "jacobians")


def map_keyframe(fn, *kfs: KeyframeData) -> KeyframeData:
    """Keyframe data whose every per-lane tensor is ``fn`` of the matching
    tensors of ``kfs``; the shared intrinsics are the first keyframe's.
    ``map_keyframe(lambda x: x[b], kf)`` is lane ``b`` of a batched keyframe."""
    return KeyframeData(levels=tuple(
        levels[0]._replace(**{f: fn(*(getattr(o, f) for o in levels)) for f in LANE_FIELDS})
        for levels in zip(*(kf.levels for kf in kfs))
    ))


# ---------------------------------------------------------------------------
# Per-level LM solve
# ---------------------------------------------------------------------------


def _eval_energy(obs: LevelObs, image: torch.Tensor, model: Pose):
    """Warp + sample + residual pass (lm_optimizer.rs:68-87): ``(energy, r,
    inside)``, energy = Σ_inside r² / #inside (NaN when nothing is inside).
    Plain torch on every device: the plain version of the lost-frame
    detector, which on a GPU the finest level's solver launch computes."""
    r, inside = residual.residuals(
        image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, model, obs.intrinsics
    )
    return torch.sum(r * r) / torch.sum(inside).to(Float), r, inside


def _eval_full(obs: LevelObs, image: torch.Tensor, model: Pose, out=None, robust_delta: float = 0.0):
    """Energy, ``Jᵀr`` and ``Σ JᵀJ`` of one LM evaluation
    (lm_optimizer.rs:68-107).  energy = Σ_inside r² / #inside: NaN when no
    candidate lands inside, like the reference.  ``robust_delta > 0``
    weights every inside residual with its Huber weight w (energy Σ w r² /
    #inside, weighted normal equations).  ``out`` is passed on to
    ``residual_reduce``."""
    params = torch.cat([model.q, model.t, obs.intrinsics.vector()])
    m, rsq, count = residual.residual_reduce(
        image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians, params,
        out=out, robust_delta=robust_delta,
    )
    return rsq / count, m[:, 6], m[:, :6]


class BrightnessState(NamedTuple):
    """Pose and per-frame affine brightness ``ab = (gain a, bias b)``:
    residual ``r = I(warp(p)) - (a T(p) + b)``.  The reference assumes
    brightness constancy; auto-exposure cameras (TUM fr1) break it."""

    pose: Pose
    ab: torch.Tensor  # (2,) f32, (1, 0) at the start of a frame


def _eval_full_brightness(obs: LevelObs, image: torch.Tensor, bst: BrightnessState, out=None,
                          robust_delta: float = 0.0):
    """The 8-parameter normal equations, columns ``[J | T | 1]``: energy,
    ``g`` (8,) and ``H`` (8, 8).  The residual is linear in (a, b), so their
    block is Gauss-Newton with additive updates while the pose keeps the
    inverse-compositional update; one system updates both."""
    params = torch.cat([bst.pose.q, bst.pose.t, obs.intrinsics.vector()])
    m, rsq, count = residual.residual_reduce(
        image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians, params,
        out=out, robust_delta=robust_delta, ab=bst.ab,
    )
    return rsq / count, m[:, 8], m[:, :8]


def _pose_step(pose: Pose, delta: torch.Tensor) -> Pose:
    """``pose ∘ exp(δ)⁻¹`` renormalized to first order (lm_optimizer.rs:195-209)."""
    return pose_mod.renormalize_first_order(pose_mod.compose(pose, pose_mod.inverse(se3.exp(delta))))


def _lm_loop(evaluate, step, model0, image, *, lm_coef_init, max_iterations, energy_tol, out_size):
    """The Python LM loop of ``solve_level_reference`` and
    ``solve_level_brightness_reference``: ``evaluate(model, out)`` gives
    (energy, g, H), ``step(model, delta)`` the next model."""
    # one output row per evaluation: an accepted state keeps views of its row
    outs = None
    if image.device.type == "cuda":
        outs = iter(torch.empty((max_iterations + 4, out_size), dtype=Float, device=image.device))

    def run(model):
        return evaluate(model, None if outs is None else next(outs))

    def init(_, model):
        energy, grad, hess = run(model)
        lm_coef = torch.full((), lm_coef_init, dtype=Float, device=image.device)
        return LMState(model, energy, grad, hess, lm_coef)

    def lm_step(state):
        return step(state.model, damped_solve(state.hessian, state.gradient, state.lm_coef))

    def eval_fn(_, state, new_model):
        return (new_model, *run(new_model))

    def stop(state, nb_iter, eval_out):
        new_model, energy, grad, hess = eval_out
        return lm_update(
            state, nb_iter, new_model, energy, grad, hess,
            max_iterations=max_iterations, energy_tol=energy_tol,
        )

    return iterative_solve(
        None, model0, init=init, step=lm_step, eval_fn=eval_fn, stop_criterion=stop,
        max_iterations=max_iterations + 3,
    )


def solve_level_reference(
    obs: LevelObs,
    image: torch.Tensor,
    model0: Pose,
    *,
    lm_coef_init: float = 0.1,
    max_iterations: int = 20,
    energy_tol: float = 1.0,
    robust_delta: float = 0.0,
) -> SolveResult:
    """The LM solve of one level as a Python loop: the plain version of
    ``ops.lm_solve.lm_solve_level`` (lm_optimizer.rs:111-193).  Damp the
    diagonal by (1+λ), solve the 6x6 system by Cholesky, update
    ``model ∘ exp(δ)⁻¹`` and renormalize the quaternion to first order.
    The host reads the device once per iteration.  On CUDA tensors its
    evaluations launch the ``residual_reduce`` kernel."""
    return _lm_loop(
        lambda model, out: _eval_full(obs, image, model, out=out, robust_delta=robust_delta),
        _pose_step, model0, image, lm_coef_init=lm_coef_init, max_iterations=max_iterations,
        energy_tol=energy_tol, out_size=residual.OUT_SIZE,
    )


def solve_level_brightness_reference(
    obs: LevelObs,
    image: torch.Tensor,
    state0: BrightnessState,
    *,
    lm_coef_init: float = 0.1,
    max_iterations: int = 20,
    energy_tol: float = 1.0,
    robust_delta: float = 0.0,
) -> SolveResult:
    """The LM solve of one level over (pose, gain, bias) as a Python loop:
    the plain version of the brightness instantiation of
    ``lm_solve_level``.  A step updates the pose with ``δ[0:6]``
    inverse-compositionally and adds ``δ[6:8]`` to (a, b)."""

    def step(bst, delta):
        return BrightnessState(pose=_pose_step(bst.pose, delta[:6]), ab=bst.ab + delta[6:8])

    return _lm_loop(
        lambda bst, out: _eval_full_brightness(obs, image, bst, out=out, robust_delta=robust_delta),
        step, state0, image, lm_coef_init=lm_coef_init, max_iterations=max_iterations,
        energy_tol=energy_tol, out_size=residual.OUT_SIZE_BRIGHTNESS,
    )


def _launch_level(obs: LevelObs, intrinsics: torch.Tensor, image, state_in, record, **kwargs):
    """One ``lm_solve_level`` launch of level ``obs``, whose intrinsics are the
    (5,) row ``intrinsics``."""
    return lm_solve.lm_solve_level(
        image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians,
        intrinsics, state_in, record, **kwargs,
    )


@lru_cache(maxsize=None)
def _constant(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A small f32 constant on ``device``, copied there once: a copy from the
    host inside a frame would wait for the device."""
    return torch.tensor(values, dtype=Float, device=device)


def identity_lanes(nb_lanes: int, device) -> Pose:
    """``nb_lanes`` identity poses, (B, 4) and (B, 3) views of one constant."""
    device = torch.device(device)
    return Pose(_constant((1.0, 0.0, 0.0, 0.0), device).expand(nb_lanes, 4),
                _constant((0.0, 0.0, 0.0), device).expand(nb_lanes, 3))


def _start_state(model: Pose, ab: torch.Tensor | None = None) -> torch.Tensor:
    """``state_in`` of a frame's first launch, (…, 10): the pose, nothing
    failed yet, and the brightness (a, b), (1, 0) unless given."""
    lead = model.t.shape[:-1]
    if ab is None:
        ab = _constant((1.0, 0.0), model.t.device).expand(*lead, 2)
    return torch.cat([model.q, model.t, model.t.new_zeros((*lead, 1)), ab], dim=-1)


def _solve_launch(obs, image, state_in, brightness: bool, **kwargs):
    """One ``lm_solve_level`` launch of one level: (record, nb_iter,
    failed), the counts as 0-d device tensors."""
    record = torch.empty((lm_solve.RECORD_SIZE,), dtype=Float, device=image.device)
    _launch_level(obs, obs.intrinsics.vector(), image, state_in, record, brightness=brightness, **kwargs)
    return record, record[lm_solve.NB_ITER].to(torch.int32), record[lm_solve.FAILED] != 0


def solve_level(
    obs: LevelObs,
    image: torch.Tensor,
    model0: Pose,
    *,
    lm_coef_init: float = 0.1,
    max_iterations: int = 20,
    energy_tol: float = 1.0,
    robust_delta: float = 0.0,
) -> SolveResult:
    """LM solve of one pyramid level (lm_optimizer.rs:111-193).

    CPU tensors take ``solve_level_reference``; CUDA tensors launch the
    ``lm_solve_level`` kernel once, and ``nb_iter`` and ``failed`` of the
    result are then 0-d device tensors: nothing is read on the host."""
    kwargs = dict(lm_coef_init=lm_coef_init, max_iterations=max_iterations, energy_tol=energy_tol,
                  robust_delta=robust_delta)
    if image.device.type == "cpu":
        return solve_level_reference(obs, image, model0, **kwargs)
    record, nb_iter, failed = _solve_launch(obs, image, _start_state(model0), False, **kwargs)
    pose = record[lm_solve.POSE]
    m = record[lm_solve.NORMAL_EQUATIONS].view(6, 7)
    state = LMState(
        Pose(pose[0:4], pose[4:7]), record[lm_solve.ENERGY], m[:, 6], m[:, :6],
        record[lm_solve.LM_COEF],
    )
    return SolveResult(state=state, nb_iter=nb_iter, failed=failed)


def solve_level_brightness(
    obs: LevelObs,
    image: torch.Tensor,
    state0: BrightnessState,
    *,
    lm_coef_init: float = 0.1,
    max_iterations: int = 20,
    energy_tol: float = 1.0,
    robust_delta: float = 0.0,
) -> SolveResult:
    """LM solve of one level over (pose, gain, bias).  CPU tensors take
    ``solve_level_brightness_reference``; CUDA tensors launch the
    8-parameter instantiation of ``lm_solve_level`` once, with no host
    read."""
    kwargs = dict(lm_coef_init=lm_coef_init, max_iterations=max_iterations, energy_tol=energy_tol,
                  robust_delta=robust_delta)
    if image.device.type == "cpu":
        return solve_level_brightness_reference(obs, image, state0, **kwargs)
    state_in = _start_state(state0.pose, state0.ab)
    record, nb_iter, failed = _solve_launch(obs, image, state_in, True, **kwargs)
    pose = record[lm_solve.POSE]
    m = record[lm_solve.NORMAL_EQUATIONS_BRIGHTNESS].view(8, 9)
    state = LMState(
        BrightnessState(Pose(pose[0:4], pose[4:7]), record[lm_solve.AB]), record[lm_solve.ENERGY],
        m[:, 8], m[:, :8], record[lm_solve.LM_COEF],
    )
    return SolveResult(state=state, nb_iter=nb_iter, failed=failed)


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
    # with ``detector``: (3,) the plain energy of the finest level under
    # ``model`` (the lost-frame detector, ``_eval_energy``), its inside count
    # and the level's valid count; else None
    detector: torch.Tensor | None = None


def _level_kwargs(config: TrackerConfig, lvl: int) -> dict:
    return dict(
        lm_coef_init=config.lm_coef_init,
        max_iterations=config.level_iterations(lvl),
        energy_tol=config.energy_tol,
        robust_delta=config.robust_delta,
    )


def _mean_flow(model: Pose, coarse: LevelObs) -> torch.Tensor:
    """Optical-flow keyframe criterion at the coarsest level
    (inverse_compositional.rs:211-222): mean |Δu| + |Δv| over the valid
    candidates.  Padding candidates (idepth 0) warp to NaN and are left out
    of the sum: the JAX package writes ``sum(dflow * valid)``, which XLA
    compiles into a select, so its jitted trackers (every one its CLIs run)
    ignore the padding NaNs.  A level without a valid candidate gives 0 / 0,
    NaN, which never triggers a switch."""
    u, v = camera_mod.warp(model, coarse.xs, coarse.ys, coarse.idepth, coarse.intrinsics)
    dflow = torch.abs(coarse.xs - u) + torch.abs(coarse.ys - v)
    validf = coarse.valid.to(Float)
    return torch.sum(torch.where(coarse.valid, dflow, torch.zeros_like(dflow))) / torch.sum(validf)


def _track_frame_kernel(config, kf, img_pyramid, init_model, detector, image_index, active) -> TrackResult:
    """Coarse-to-fine ``lm_solve_level``: one launch per level for all lanes,
    each reading its start state (pose, failed-so-far flag, brightness) from
    the record of the level before; the finest level's launch also computes
    the flow and, with ``detector``, the lost-frame detector.  The levels'
    intrinsics reach the launches as rows of one (L, 5) table, one stack a
    frame.  No host read."""
    lead = init_model.q.shape[:-1]
    table = _intrinsics_table([obs.intrinsics for obs in kf.levels])
    records = torch.empty(
        (config.nb_levels, *lead, lm_solve.RECORD_SIZE), dtype=Float, device=init_model.q.device
    )
    coarse = kf.levels[-1]
    state = _start_state(init_model)
    for lvl in reversed(range(config.nb_levels)):
        flow_of = None
        if lvl == 0:  # the last launch: its handed-on pose is the frame's
            flow_of = (coarse.xs, coarse.ys, coarse.idepth, coarse.valid, table[-1])
        _launch_level(
            kf.levels[lvl], table[lvl], img_pyramid[lvl], state, records[lvl], flow_of=flow_of,
            brightness=config.brightness_model, detector=detector and lvl == 0,
            image_index=image_index, active=active, **_level_kwargs(config, lvl),
        )
        state = records[lvl, ..., : lm_solve.STATE_SIZE]
    # (…, nb_levels, 2): iterations and evaluations per level
    counts = records[..., lm_solve.NB_ITER : lm_solve.NB_EVALS + 1].to(torch.int32).movedim(0, -2)
    return TrackResult(
        model=Pose(state[..., 0:4], state[..., 4:7]), failed=state[..., lm_solve.FAILED_SO_FAR] != 0,
        flow=records[0, ..., lm_solve.FLOW], nb_iters=counts[..., 0], nb_evals=counts[..., 1],
        detector=records[0, ..., lm_solve.DETECTOR] if detector else None,
    )


def track_frame(
    config: TrackerConfig,
    kf: KeyframeData,
    img_pyramid: List[torch.Tensor],
    init_model: Pose,
    *,
    detector: bool = False,
    image_index: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
) -> TrackResult:
    """Coarse-to-fine LM alignment of one frame against the keyframe
    (inverse_compositional.rs:170-240).  After a failed level the model is
    frozen for the rest of the frame; the remaining levels still run, as in
    the JAX package, so their iteration counts are reported.  With
    ``config.brightness_model`` every level also solves the gain and bias
    (a, b), which start at (1, 0), hand on from level to level and freeze
    with the pose (the JAX package's ``_track_frame_brightness``); the
    result carries the pose only.

    CUDA tensors go through the ``lm_solve_level`` kernel (one launch per
    level for all lanes, no host read); CPU tensors through
    ``track_frame_reference``.  With a lane axis (``init_model`` (B, 4) and
    (B, 3), keyframe and pyramid (B, …)) every field of the result carries
    it.  ``image_index`` (B,) int32 makes lane b track image
    ``image_index[b]`` of pyramid levels (M, h, w); ``active`` (B,) bool
    leaves the lanes whose flag is False untracked (their result is the
    init model, not failed, NaN flow and detector energy, zero counts).
    ``detector`` also reports ``TrackResult.detector``."""
    kwargs = dict(detector=detector, image_index=image_index, active=active)
    if init_model.q.device.type == "cpu":
        return track_frame_reference(config, kf, img_pyramid, init_model, **kwargs)
    return _track_frame_kernel(config, kf, img_pyramid, init_model, **kwargs)


def _untracked(config: TrackerConfig, init_model: Pose, detector: bool) -> TrackResult:
    """The result of an inactive lane: what its pass-through records hold."""
    zeros = torch.zeros(config.nb_levels, dtype=torch.int32, device=init_model.q.device)
    nan = torch.tensor(float("nan"), dtype=Float, device=init_model.q.device)
    det = torch.stack([nan, nan.new_zeros(()), nan.new_zeros(())]) if detector else None
    return TrackResult(model=init_model, failed=torch.tensor(False, device=nan.device), flow=nan,
                       nb_iters=zeros, nb_evals=zeros, detector=det)


def track_frame_reference(
    config: TrackerConfig,
    kf: KeyframeData,
    img_pyramid: List[torch.Tensor],
    init_model: Pose,
    *,
    detector: bool = False,
    image_index: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
) -> TrackResult:
    """``track_frame`` through ``solve_level_reference`` (or
    ``solve_level_brightness_reference``), chained on the host, on any
    device: the plain version that the kernel path is held against.  A lane
    axis is solved lane by lane and stacked: the plain version of the
    lane-axis launch, ``image_index`` and ``active`` read on the host."""
    if init_model.q.dim() == 2:
        nb_lanes = init_model.q.shape[0]
        images = range(nb_lanes) if image_index is None else image_index.tolist()
        running = [True] * nb_lanes if active is None else active.tolist()
        lanes = []
        for b in range(nb_lanes):
            init_b = Pose(init_model.q[b], init_model.t[b])
            if not running[b]:
                lanes.append(_untracked(config, init_b, detector))
                continue
            lanes.append(track_frame_reference(
                config, map_keyframe(lambda x: x[b], kf), [p[images[b]] for p in img_pyramid], init_b,
                detector=detector,
            ))
        fields = {f: torch.stack([getattr(r, f) for r in lanes]) for f in TrackResult._fields[1:-1]}
        return TrackResult(
            model=Pose(torch.stack([r.model.q for r in lanes]), torch.stack([r.model.t for r in lanes])),
            detector=torch.stack([r.detector for r in lanes]) if detector else None, **fields,
        )
    device = init_model.q.device
    model = init_model
    ab = torch.tensor([1.0, 0.0], dtype=Float, device=device)
    failed = False
    nb_iters = [0] * config.nb_levels
    for lvl in reversed(range(config.nb_levels)):
        obs, image, kwargs = kf.levels[lvl], img_pyramid[lvl], _level_kwargs(config, lvl)
        if config.brightness_model:
            result = solve_level_brightness_reference(obs, image, BrightnessState(model, ab), **kwargs)
            new_model, new_ab = result.state.model
        else:
            result = solve_level_reference(obs, image, model, **kwargs)
            new_model, new_ab = result.state.model, ab
        if not (failed or result.failed):
            model, ab = new_model, new_ab
        failed = failed or result.failed
        nb_iters[lvl] = result.nb_iter
    det = None
    if detector:
        finest = kf.levels[0]
        energy, _, inside = _eval_energy(finest, img_pyramid[0], model)
        det = torch.stack([energy, inside.sum().to(Float), finest.valid.sum().to(Float)])
    nb_iters = torch.tensor(nb_iters, dtype=torch.int32, device=device)
    return TrackResult(
        model=model, failed=torch.tensor(failed, device=device),
        flow=_mean_flow(model, kf.levels[-1]), nb_iters=nb_iters,
        nb_evals=nb_iters + 1,  # the loop evaluates once at the start and once per iteration
        detector=det,
    )


# ---------------------------------------------------------------------------
# Host-side Tracker: the reference's 4-call product API
# ---------------------------------------------------------------------------


class Tracker:
    """Stateful camera tracker over an RGB-D stream (``Config::init`` →
    ``Tracker::track`` → ``Tracker::current_frame``, vors_track.rs:34-63).

    Images and depth maps come as numpy arrays or tensors; they are moved to
    ``device``, which is the GPU unless the caller names another.  The
    tracker's own three poses (keyframe, current, previous) are 7 floats each
    and live on the host, where composing them costs microseconds.  On a GPU
    the host reads the device once per frame (the solved pose, flow, failed
    flag, per-level counts and, with relocalization, the detector's energy
    in one transfer), and once more on a keyframe switch with bucketing on
    or with the ``dso`` selector.

    With ``relocalize_window = K > 0`` the tracker keeps its last K
    keyframes, unbucketed, and a frame that is lost (failed, or the plain
    energy of the finest level under the solved pose not finite or above
    ``relocalize_energy_accept``) is tracked again against all of them at
    once (``models.relocalize.attempt``); the best verified keyframe becomes
    the anchor again.  A lost frame never becomes a keyframe.
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
        self._levels = level_intrinsics(self.intrinsics, config.nb_levels)  # every keyframe's
        pyr = pyramid_ops.mean_pyramid(config.nb_levels, image_tensor(img, self.device))
        raw_kf, counts = self._precompute(depth_map, pyr)
        self.keyframe_data = self._maybe_bucket(raw_kf, counts)
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
        self.last_energy: float = 0.0
        self.last_nb_iters: Tuple[int, ...] = (0,) * config.nb_levels
        self.last_nb_evals: Tuple[int, ...] = (0,) * config.nb_levels
        self.keyframe_switches: int = 0
        self.frames_tracked: int = 0  # the id of the frame's spans
        # the relocalization ring: unbucketed keyframes, so that they stack
        self.relocalizations: int = 0
        self._reloc_history = []
        if config.relocalize_window > 0:
            self._reloc_history.append((raw_kf, self.keyframe_pose, depth_timestamp, img_timestamp))

    def _precompute(self, depth_map, pyr) -> Tuple[KeyframeData, torch.Tensor]:
        """The unbucketed keyframe of a depth map and pyramid, and its valid
        candidates a level on the device."""
        mask = dso_mask(self.config, pyr[0]) if self.config.candidate_selector == "dso" else None
        with profiling.span("vors.upload", bytes=depth_map.nbytes):
            depth = depth_tensor(depth_map, self.device)
        return precompute_keyframe_counts(self.config, self._levels, depth, pyr, finest_mask=mask)

    def track(self, depth_timestamp: float, depth_map, img_timestamp: float, img) -> None:
        """Track one frame (inverse_compositional.rs:170-240)."""
        self.frames_tracked += 1
        with profiling.span("vors.track", id=self.frames_tracked, switched=0) as frame_span:
            config = self.config
            reloc = config.relocalize_window > 0
            with profiling.span("vors.upload", bytes=img.nbytes):
                img = image_tensor(img, self.device)
            with profiling.span("vors.solve"):
                pyr = pyramid_ops.mean_pyramid(config.nb_levels, img)
                init_model = warm_start_init(
                    config, self.keyframe_pose, self.current_pose, self.prev_pose
                ).to(self.device)
                result = self._track_frame(config, self.keyframe_data, pyr, init_model, detector=reloc)
            head = [result.flow, result.failed.to(Float)] + ([result.detector[0]] if reloc else [])
            levels, first = config.nb_levels, len(head)
            # the frame's one device→host read
            with profiling.span("vors.read.track", bytes=4 * (first + 2 * levels + 7)):
                stats = torch.cat(
                    [torch.stack(head), result.nb_iters.to(Float), result.nb_evals.to(Float),
                     result.model.q, result.model.t]
                ).cpu()
            values = stats.tolist()
            self.last_flow = values[0]
            self.last_failed = values[1] != 0.0
            self.last_energy = values[2] if reloc else 0.0
            self.last_nb_iters = tuple(int(n) for n in values[first : first + levels])
            self.last_nb_evals = tuple(int(n) for n in values[first + levels : first + 2 * levels])
            model = Pose(stats[-7:-3], stats[-3:])

            self.current_depth_timestamp = depth_timestamp
            self.current_img_timestamp = img_timestamp
            self.prev_pose = self.current_pose
            # a failed frame keeps the pose, which also zeroes the velocity of the
            # next warm start
            if not self.last_failed:
                self.current_pose = pose_mod.compose(self.keyframe_pose, pose_mod.inverse(model))

            if reloc and (
                self.last_failed
                or not math.isfinite(self.last_energy)
                or self.last_energy > config.relocalize_energy_accept
            ):
                # lost: try the ring; either way the frame does not become a
                # keyframe, and the velocity across it is zero
                self._try_relocalize(pyr)
                self.prev_pose = self.current_pose
                return

            if self.last_flow >= config.flow_threshold:
                frame_span.count(switched=1)
                with profiling.span("vors.precompute", lanes=1):
                    raw_kf, counts = self._precompute(depth_map, pyr)
                    self.keyframe_data = self._maybe_bucket(raw_kf, counts)
                self.keyframe_depth_timestamp = depth_timestamp
                self.keyframe_img_timestamp = img_timestamp
                self.keyframe_pose = self.current_pose
                self.keyframe_switches += 1
                if reloc:
                    self._reloc_history.append((raw_kf, self.keyframe_pose, depth_timestamp, img_timestamp))
                    del self._reloc_history[: -config.relocalize_window]

    def _try_relocalize(self, pyr) -> None:
        """Track the lost frame against every keyframe of the ring in one
        lane-axis solve per level (``models.relocalize.attempt``) and read
        the outcome in one transfer.  On success adopt the recovered pose
        and make the matched keyframe the anchor again; else keep the
        previous pose (the reference's behaviour)."""
        from . import relocalize as reloc_mod

        if not self._reloc_history:
            return
        kfs, kf_q, kf_t = reloc_mod.stack_history(self._reloc_history)
        res = reloc_mod.attempt(
            self.config, kfs, kf_q, kf_t, pyr,
            self.config.relocalize_energy_accept, self.config.relocalize_min_inside_frac,
        )
        host = torch.cat([torch.stack([res.ok.to(Float), res.best.to(Float), res.energy]),
                          res.pose.q, res.pose.t]).cpu()
        if host[0] == 0.0:
            return
        raw_kf, kf_pose, kf_dts, kf_its = self._reloc_history[int(host[1])]
        self.current_pose = Pose(host[3:7], host[7:10])
        self.keyframe_data = self._maybe_bucket(raw_kf)
        self.keyframe_pose = kf_pose
        self.keyframe_depth_timestamp = kf_dts
        self.keyframe_img_timestamp = kf_its
        self.last_failed = False
        self.last_energy = float(host[2])
        self.relocalizations += 1

    def _maybe_bucket(self, kf: KeyframeData, counts: torch.Tensor | None = None) -> KeyframeData:
        """Slice each level's candidates to the smallest power-of-two bucket
        >= its count (at least ``min_bucket``, at most the level cap).  Valid
        candidates are compacted to the front, so the slice keeps them all.
        One host sync reads the counts of all levels: ``counts`` (L,) if the
        precompute gave them, else the valid sums."""
        if not self.config.bucket_candidates:
            return kf
        with profiling.span("vors.read.bucket"):
            if counts is None:
                counts = torch.stack([obs.valid.sum() for obs in kf.levels])
            counts = counts.tolist()
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
