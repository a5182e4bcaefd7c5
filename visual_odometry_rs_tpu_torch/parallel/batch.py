"""Batched multi-sequence tracking: one lane per sequence.

The port of ``visual_odometry_rs_tpu/parallel/batch.py``.  Every tensor of a
batched ``TrackState`` carries a leading lane axis (B, …); the intrinsics
are shared by all lanes.

- ``track_step`` / ``batched_track_step``: one frame as a function of the
  state, with the keyframe precompute run every frame and the switch a
  per-lane select (the JAX package's branch-free form).
- ``track_sequence`` / ``batched_track_sequence``: a clip of frames, with the
  keyframe precompute run only for the lanes that switch, and
  ``switch_cadence`` batching switches onto check frames as in the JAX
  package.

On a GPU the host loop over frames takes the place of the JAX package's
``lax.scan``.  A frame is the batched pyramid, the pose algebra on (B, 4)
and (B, 3) device tensors, six ``lm_solve_level`` launches that each solve
one level for all lanes, and the per-lane selects.  The host reads the
device only where the semantics need it: the B-lane switch mask on a check
frame, and the stacked poses and diagnostics once per clip
(``outputs_to_numpy``, called by the caller).  On a check frame only the
switching lanes are precomputed: they are picked with ``index_select`` and
written back with ``index_copy``, which replaces the JAX package's one-hot
lane moves and its ``switch_subbatch`` compaction.  Lanes never wait on each
other: each lane's solve ends after its own iterations.

On the CPU the same code runs the plain versions (the Python LM loop, lane
by lane).

Not in this slice: in-scan relocalization (``reloc_ring``,
``batched_init_ring``; ROADMAP A9) and the sharded step
(``make_sharded_step``; ROADMAP A12).  The JAX package's
``_resolve_batched_interp`` picks a TPU interpolation and has no
counterpart here.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math.pose import Pose
from ..models import tracker as tracker_mod
from ..models.tracker import KeyframeData, TrackerConfig
from ..ops import pyramid as pyramid_ops
from ..utils.types import Float, depth_tensor, image_tensor, resolve_device


class TrackState(NamedTuple):
    """Per-sequence tracker state (with a leading lane axis when batched)."""

    kf: KeyframeData
    keyframe_pose: Pose
    current_pose: Pose


class StepDiagnostics(NamedTuple):
    flow: torch.Tensor  # mean optical flow at the coarsest level (px)
    failed: torch.Tensor  # bool: some level's Cholesky failed
    switched: torch.Tensor  # bool: the keyframe was replaced this frame
    relocalized: torch.Tensor  # bool, all False: relocalization is ROADMAP A9
    nb_iters: torch.Tensor  # (…, nb_levels) int32 LM iterations, 0 = finest


def _bcast(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return flag.reshape(flag.shape + (1,) * (like.dim() - flag.dim()))


def _where_pose(flag: torch.Tensor, new: Pose, old: Pose) -> Pose:
    """Per lane: ``new`` where ``flag``, else ``old``."""
    return Pose(*(torch.where(_bcast(flag, n), n, o) for n, o in zip(new, old)))


def _map_state(fn, state: TrackState) -> TrackState:
    return TrackState(
        kf=tracker_mod.map_keyframe(fn, state.kf),
        keyframe_pose=Pose(*map(fn, state.keyframe_pose)),
        current_pose=Pose(*map(fn, state.current_pose)),
    )


def _solved_pose(keyframe_pose: Pose, model: Pose) -> Pose:
    """The camera pose a solved keyframe→frame model gives."""
    return pose_mod.compose(keyframe_pose, pose_mod.inverse(model))


def init_state(
    config: TrackerConfig, intrinsics: Intrinsics, depth, img, device="cuda"
) -> TrackState:
    """Functional ``Config::init`` (inverse_compositional.rs:74-100).

    ``depth`` (u16 or int32) and ``img`` (u8) are (H, W), or (B, H, W) for a
    batch, as numpy arrays or tensors; they are moved to ``device``, which is
    the GPU unless the caller names another."""
    device = resolve_device(device)
    img = image_tensor(img, device)
    pyr = pyramid_ops.mean_pyramid(config.nb_levels, img)
    kf = tracker_mod.precompute_keyframe(config, intrinsics.to(device), depth_tensor(depth, device), pyr)
    identity = pose_mod.identity(device)
    lead = tuple(img.shape[:-2])
    pose = Pose(identity.q.expand(*lead, 4).contiguous(), identity.t.expand(*lead, 3).contiguous())
    return TrackState(kf=kf, keyframe_pose=pose, current_pose=pose)


def batched_init_state(
    config: TrackerConfig, intrinsics: Intrinsics, depths, imgs, device="cuda"
) -> TrackState:
    """Initialize a batch of sequences: ``depths`` and ``imgs`` are (B, H, W);
    one batched keyframe precompute serves all lanes."""
    if imgs.ndim != 3 or depths.ndim != 3:
        raise ValueError(f"depths and imgs must be (B, H, W), got {depths.shape} and {imgs.shape}")
    return init_state(config, intrinsics, depths, imgs, device)


def track_step(config: TrackerConfig, intrinsics: Intrinsics, state: TrackState, depth, img):
    """One tracking step as a function of the state: ``(new_state,
    diagnostics)``.

    Mirrors ``Tracker::track`` (inverse_compositional.rs:170-240) with the
    keyframe switch as a per-lane select: the keyframe precompute runs every
    frame.  ``depth`` and ``img`` go to the state's device.  With a lane axis
    on the state and (B, H, W) inputs this is ``batched_track_step``."""
    device = state.current_pose.q.device
    pyr = pyramid_ops.mean_pyramid(config.nb_levels, image_tensor(img, device))
    init_model = pose_mod.compose(pose_mod.inverse(state.current_pose), state.keyframe_pose)
    result = tracker_mod.track_frame(config, state.kf, pyr, init_model)
    new_current = _where_pose(
        result.failed, state.current_pose, _solved_pose(state.keyframe_pose, result.model)
    )
    switch = result.flow >= config.flow_threshold  # False for a NaN flow
    new_kf = tracker_mod.precompute_keyframe(
        config, intrinsics.to(device), depth_tensor(depth, device), pyr
    )
    kf = tracker_mod.map_keyframe(
        lambda new, old: torch.where(_bcast(switch, new), new, old), new_kf, state.kf
    )
    new_state = TrackState(
        kf=kf, keyframe_pose=_where_pose(switch, new_current, state.keyframe_pose),
        current_pose=new_current,
    )
    return new_state, StepDiagnostics(
        flow=result.flow, failed=result.failed, switched=switch,
        relocalized=torch.zeros_like(switch), nb_iters=result.nb_iters,
    )


def batched_track_step(config: TrackerConfig, intrinsics: Intrinsics, state: TrackState, depths, imgs):
    """``track_step`` over the leading lane axis (the JAX package's vmap):
    ``depths`` and ``imgs`` are (B, H, W)."""
    return track_step(config, intrinsics, state, depths, imgs)


def track_sequence(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    state: TrackState,
    depths,
    imgs,
    prev_pose0: Pose | None = None,
    return_prev: bool = False,
):
    """Track a clip of one sequence, ``depths``/``imgs`` (F, H, W): returns the
    final state and the per-frame poses and diagnostics stacked on the
    leading axis (and, with ``return_prev``, the warm-start carry).  It is
    ``batched_track_sequence`` on one lane at cadence 1, the reference's
    per-frame keyframe switching."""
    add_lane = (lambda x: x[None])
    outs = batched_track_sequence(
        config, intrinsics, _map_state(add_lane, state), depths[:, None], imgs[:, None],
        prev_pose0=None if prev_pose0 is None else Pose(*map(add_lane, prev_pose0)),
        return_prev=return_prev,
    )
    final, (poses, diags) = outs[:2]

    def frame_axis_only(x):
        return x[:, 0]

    outs_1 = (
        _map_state(lambda x: x[0], final),
        (Pose(*map(frame_axis_only, poses)), StepDiagnostics(*map(frame_axis_only, diags))),
    )
    if return_prev:
        outs_1 = outs_1 + (Pose(*(x[0] for x in outs[2])),)
    return outs_1


def batched_track_sequence(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    state: TrackState,
    depths,
    imgs,
    switch_cadence: int = 1,
    switch_subbatch: int = 0,
    pending0=None,
    frame_offset: int = 0,
    return_pending: bool = False,
    reloc_ring=None,
    prev_pose0: Pose | None = None,
    return_prev: bool = False,
):
    """Track a clip of a batch, ``depths``/``imgs`` (F, B, H, W), frame by
    frame (the JAX package's ``lax.scan`` of ``_lazy_switch_step``).

    Returns ``(final_state, (poses, diagnostics))`` with poses and
    diagnostics stacked (F, B, …) on the state's device, then the pending
    mask if ``return_pending`` and the warm-start carry if ``return_prev``.

    ``switch_cadence=K``: lanes whose flow crosses ``config.flow_threshold``
    become pending, and pending lanes switch together on check frames, the
    frames whose global index ``frame_offset + t`` has ``(frame_offset + t +
    1) % K == 0``, to THAT frame's image and depth.  ``K=1`` is the
    reference's per-frame switching.  Chunked callers carry ``pending0``,
    ``frame_offset`` and, with ``config.warm_start == "constant_velocity"``,
    ``prev_pose0`` across calls.  ``switch_subbatch`` is accepted for the
    JAX package's signature (-1 resolves to ``max(1, B // 4)``) and changes
    nothing: only the switching lanes are precomputed whatever it says, and
    the JAX package's switch pattern is the same for every value.
    """
    if reloc_ring is not None:
        raise NotImplementedError("in-scan relocalization (reloc_ring) is not ported yet: ROADMAP A9")
    if switch_cadence < 1:
        raise ValueError(f"switch_cadence must be >= 1, got {switch_cadence}")
    if switch_subbatch < -1:
        raise ValueError(f"switch_subbatch must be >= -1, got {switch_subbatch}")
    device = state.current_pose.q.device
    depths = depth_tensor(depths, device)
    imgs = image_tensor(imgs, device)
    nb_frames, batch = imgs.shape[:2]
    if nb_frames == 0 or depths.shape != imgs.shape or state.current_pose.q.shape != (batch, 4):
        raise ValueError(
            f"clips must be (F >= 1, B={state.current_pose.q.shape[0]}, H, W), got depths "
            f"{tuple(depths.shape)} and imgs {tuple(imgs.shape)}"
        )
    intrinsics = intrinsics.to(device)
    vel = config.warm_start == "constant_velocity"
    kf, keyframe_pose, current = state
    pending = (
        torch.zeros(batch, dtype=torch.bool, device=device) if pending0 is None
        else torch.as_tensor(pending0, dtype=torch.bool, device=device)
    )
    prev = prev_pose0.to(device) if (vel and prev_pose0 is not None) else current
    no_switch = torch.zeros(batch, dtype=torch.bool, device=device)
    poses: List[Pose] = []
    results, switches = [], []
    for t in range(nb_frames):
        init_model = tracker_mod.warm_start_init(config, keyframe_pose, current, prev)
        pyrs = pyramid_ops.mean_pyramid(config.nb_levels, imgs[t])
        result = tracker_mod.track_frame(config, kf, pyrs, init_model)
        new_current = _where_pose(result.failed, current, _solved_pose(keyframe_pose, result.model))
        pending = pending | (result.flow >= config.flow_threshold)  # False for a NaN flow
        switched = no_switch
        if (frame_offset + t + 1) % switch_cadence == 0:
            lanes = torch.nonzero(pending.cpu()).flatten()  # the check frame's host read
            if lanes.numel() > 0:
                idx = lanes.to(device)
                new_kf = tracker_mod.precompute_keyframe(
                    config, intrinsics, depths[t].index_select(0, idx),
                    [p.index_select(0, idx) for p in pyrs],
                )
                kf = tracker_mod.map_keyframe(lambda old, new: old.index_copy(0, idx, new), kf, new_kf)
                keyframe_pose = _where_pose(pending, new_current, keyframe_pose)
                switched, pending = pending, no_switch
        if vel:
            # across a failed lane the motion is unreliable: zero velocity next
            prev = _where_pose(result.failed, new_current, current)
        current = new_current
        poses.append(current)
        results.append(result)
        switches.append(switched)

    switched = torch.stack(switches)
    diags = StepDiagnostics(
        flow=torch.stack([r.flow for r in results]),
        failed=torch.stack([r.failed for r in results]),
        switched=switched,
        relocalized=torch.zeros_like(switched),
        nb_iters=torch.stack([r.nb_iters for r in results]),
    )
    stacked = Pose(torch.stack([p.q for p in poses]), torch.stack([p.t for p in poses]))
    outs = (TrackState(kf=kf, keyframe_pose=keyframe_pose, current_pose=current), (stacked, diags))
    if return_pending:
        outs = outs + (pending,)
    if return_prev:
        outs = outs + (prev if vel else current,)
    return outs


def outputs_to_numpy(poses: Pose, diags: StepDiagnostics):
    """The stacked poses and diagnostics of a clip as numpy, in ONE
    device→host copy: ``(q (…, 4), t (…, 3), StepDiagnostics)``."""
    parts = [poses.q, poses.t, diags.flow[..., None], diags.failed[..., None],
             diags.switched[..., None], diags.relocalized[..., None], diags.nb_iters]
    host = torch.cat([p.to(Float) for p in parts], dim=-1).cpu().numpy()
    q, t, rest = host[..., 0:4], host[..., 4:7], host[..., 7:]
    return q, t, StepDiagnostics(
        flow=rest[..., 0], failed=rest[..., 1] != 0, switched=rest[..., 2] != 0,
        relocalized=rest[..., 3] != 0, nb_iters=rest[..., 4:].astype(np.int32),
    )


def batched_init_ring(*_args, **_kwargs):
    """In-scan relocalization is not ported yet (ROADMAP A9)."""
    raise NotImplementedError("the relocalization ring (RelocRing) is not ported yet: ROADMAP A9")


def make_sharded_step(*_args, **_kwargs):
    """Sharding a batch over several GPUs is not ported yet (ROADMAP A12)."""
    raise NotImplementedError("the sharded batched step is not ported yet: ROADMAP A12")
