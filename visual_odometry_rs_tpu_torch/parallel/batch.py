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
switching lanes are precomputed (``precompute_keyframe_counts`` with
``lanes`` and ``into``): on a GPU the two precompute kernels read those
lanes of the frame's depth on the card and write their keyframes into the
clip's own copy of the batched keyframe, made at its first switch, which
replaces the JAX package's one-hot lane moves and its ``switch_subbatch``
compaction.  A clip handed over in host memory sends its images to the
card before the first frame, and of its depth maps only those rows: each
check frame's switching lanes cross then as u16 and widen on the card.
Lanes never wait on each other: each lane's solve ends after its own
iterations.

With ``reloc_ring`` (a ``RelocRing``: each lane's last R keyframes on the
device) every frame also runs the lost-frame detector in the finest
level's launch, keeps lost lanes from switching keyframes, and runs the
recovery of ``_recover_lost``: B x R lanes of six more ``lm_solve_level``
launches, where every lane that is not lost, and every empty ring slot, is
inactive and returns at once.  So a steady frame still reads nothing on
the host; the JAX package takes the same step behind ``lax.cond(any(lost))``.

On the CPU the same code runs the plain versions (the Python LM loop, lane
by lane).

Several devices (``parallel.mesh``): ``batched_track_sequence(mesh=)`` and
``make_sharded_step`` split the lanes over the devices of a mesh axis, run
each device's lanes on it (one thread a device, so one ``lm_solve_level``
launch a level goes to every device at once) and gather the results back
to the state's device.  Lanes never talk to each other, so every lane is
bit-equal to the run without a mesh.  The JAX package's
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
from ..models import relocalize as reloc_mod
from ..models import tracker as tracker_mod
from ..models.tracker import KeyframeData, TrackerConfig
from ..ops import pyramid as pyramid_ops
from ..utils import profiling
from ..utils.types import Depth, Float, depth_tensor, image_tensor, resolve_device, upload_clip, upload_lanes
from . import mesh as mesh_mod


class TrackState(NamedTuple):
    """Per-sequence tracker state (with a leading lane axis when batched)."""

    kf: KeyframeData
    keyframe_pose: Pose
    current_pose: Pose


class StepDiagnostics(NamedTuple):
    flow: torch.Tensor  # mean optical flow at the coarsest level (px)
    failed: torch.Tensor  # bool: some level's Cholesky failed
    switched: torch.Tensor  # bool: the keyframe was replaced this frame
    relocalized: torch.Tensor  # bool: recovered against the RelocRing this frame
    nb_iters: torch.Tensor  # (…, nb_levels) int32 LM iterations, 0 = finest


class RelocRing(NamedTuple):
    """Per-lane ring of the last R keyframes for relocalization in the
    batched driver (the host ``Tracker``'s keyframe history, one per lane):
    keyframe leaves (B, R, …) (the intrinsics shared), their poses, the
    number of filled slots and the next slot to write.  Slot 0 starts as the
    initial keyframe."""

    kf: KeyframeData  # lane leaves (B, R, ...)
    pose_q: torch.Tensor  # (B, R, 4) keyframe camera-to-world quaternions
    pose_t: torch.Tensor  # (B, R, 3)
    count: torch.Tensor  # (B,) int32 filled slots
    head: torch.Tensor  # (B,) int32 next slot to write


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


def _own_copy(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


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


def batched_init_ring(config: TrackerConfig, state: TrackState) -> RelocRing:
    """A ``RelocRing`` of ``config.relocalize_window`` slots for a freshly
    initialized batched state: slot 0 of every lane holds its initial
    keyframe; the other slots are copies that ``count`` masks out until
    switches fill them."""
    slots = config.relocalize_window
    if slots <= 0:
        raise ValueError("config.relocalize_window must be > 0 to build a ring")
    nb_lanes = state.keyframe_pose.q.shape[0]

    def repeat(x):
        return x[:, None].expand(x.shape[0], slots, *x.shape[1:]).contiguous()

    device = state.keyframe_pose.q.device
    return RelocRing(
        kf=tracker_mod.map_keyframe(repeat, state.kf),
        pose_q=repeat(state.keyframe_pose.q), pose_t=repeat(state.keyframe_pose.t),
        count=torch.ones(nb_lanes, dtype=torch.int32, device=device),
        head=torch.full((nb_lanes,), 1 % slots, dtype=torch.int32, device=device),
    )


def _ring_write(ring: RelocRing, lanes: torch.Tensor, kf: KeyframeData, pose: Pose) -> None:
    """Writes the keyframe and pose of each lane in ``lanes`` (a device
    index tensor) at that lane's head slot, and advances its head and count.
    In place: the ring is large, and ``batched_track_sequence`` works on its
    own copy."""
    slots = ring.pose_q.shape[1]
    head = ring.head[lanes].long()
    for ring_levels, levels in zip(ring.kf.levels, kf.levels):
        for f in tracker_mod.LANE_FIELDS:
            getattr(ring_levels, f)[lanes, head] = getattr(levels, f)[lanes]
    ring.pose_q[lanes, head] = pose.q[lanes]
    ring.pose_t[lanes, head] = pose.t[lanes]
    ring.head[lanes] = ((head + 1) % slots).to(torch.int32)
    ring.count[lanes] = torch.clamp(ring.count[lanes] + 1, max=slots)


def _recover_lost(config: TrackerConfig, lost, pyrs, ring: RelocRing, current: Pose, kf: KeyframeData,
                  keyframe_pose: Pose):
    """Relocalization in the batched driver (the JAX package's
    ``_recover_lost``): every lost lane tracks its frame against the filled
    slots of its ring, from identity, and adopts the best verified pose and
    its keyframe.  One lane-axis ``track_frame`` of B x R lanes whose image
    is their lane's, with every slot of a lane that is not lost (and every
    empty slot) inactive; no host read.  Returns (current, kf,
    keyframe_pose, relocalized)."""
    nb_lanes, slots = ring.pose_q.shape[:2]
    device = lost.device
    flat = tracker_mod.map_keyframe(lambda x: x.reshape(nb_lanes * slots, *x.shape[2:]), ring.kf)
    empty = torch.arange(slots, device=device)[None, :] >= ring.count[:, None]
    active = (lost[:, None] & ~empty).reshape(-1)
    image_index = (torch.arange(nb_lanes * slots, device=device) // slots).to(torch.int32)
    init = tracker_mod.identity_lanes(nb_lanes * slots, device)
    result = tracker_mod.track_frame(config, flat, pyrs, init, detector=True, image_index=image_index,
                                     active=active)
    energies, inside, valid = result.detector.reshape(nb_lanes, slots, 3).unbind(-1)
    best, ok = reloc_mod.rank(
        result.failed.reshape(nb_lanes, slots), energies, inside, valid,
        config.relocalize_energy_accept, config.relocalize_min_inside_frac, empty=empty,
    )
    adopt = lost & ok
    lane = torch.arange(nb_lanes, device=device)
    model = Pose(result.model.q.reshape(nb_lanes, slots, 4)[lane, best],
                 result.model.t.reshape(nb_lanes, slots, 3)[lane, best])
    ring_pose = Pose(ring.pose_q[lane, best], ring.pose_t[lane, best])
    current = _where_pose(adopt, _solved_pose(ring_pose, model), current)
    kf = tracker_mod.map_keyframe(
        lambda old, slot_x: torch.where(_bcast(adopt, old), slot_x[lane, best], old), kf, ring.kf
    )
    return current, kf, _where_pose(adopt, ring_pose, keyframe_pose), adopt


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
    mesh=None,
    axis: str = "data",
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

    ``reloc_ring`` (from ``batched_init_ring``, ``config.relocalize_window >
    0``) turns on relocalization: a lane is lost on a frame where its track
    failed or the plain energy of its finest level under the solved pose is
    not finite or above ``config.relocalize_energy_accept``.  A lost lane
    neither pends nor switches (a lane that pended earlier stays pending),
    and it is recovered against its ring (``_recover_lost``); switching
    lanes write their new keyframe into the ring.  The updated ring comes
    last in the outputs; the one passed in is not modified.

    ``mesh`` spreads the lanes over the devices of ``mesh[axis]`` (B a
    multiple of their number); the outputs come back to the state's device.

    Depth maps are u16 or int32 and images u8, on the host or on the
    state's device.  On a CUDA device, host u16 depth maps and u8 images
    (numpy arrays or CPU tensors, strided views too, as ``mesh`` hands each
    device its lanes) take ``upload_clip``'s staged path: the images cross
    through a page-locked block before the first frame, the depth maps stay
    on the host, and each check frame sends only the rows of its switching
    lanes (``upload_lanes``), each in a ``vors.upload`` span of their own
    between the switch mask's read and the precompute.  The caller's arrays
    are free again once this returns.  Other inputs go to the device whole.
    """
    if mesh is not None:
        kwargs = dict(switch_cadence=switch_cadence, switch_subbatch=switch_subbatch, frame_offset=frame_offset,
                      return_pending=return_pending, return_prev=return_prev)
        shards = zip(*(mesh_mod.shard_batch(tree, mesh, axis, dim) for tree, dim in (
            (state, 0), (depths, 1), (imgs, 1), (pending0, 0), (reloc_ring, 0), (prev_pose0, 0))))
        outs = mesh_mod.run_on_devices(
            lambda s, d, i, p, r, v: batched_track_sequence(
                config, intrinsics, s, d, i, pending0=p, reloc_ring=r, prev_pose0=v, **kwargs),
            mesh.axis_devices(axis), list(shards),
        )
        device = state.current_pose.q.device
        return tuple(mesh_mod.gather_batch([o[k] for o in outs], device, 1 if k == 1 else 0)
                     for k in range(len(outs[0])))
    with profiling.span("vors.clip", id=frame_offset) as clip_span:
        reloc_on = reloc_ring is not None
        if reloc_on and config.relocalize_window <= 0:
            raise ValueError("reloc_ring passed but config.relocalize_window is 0; build the config with "
                             "relocalize_window=R and the ring with batched_init_ring")
        if config.candidate_selector == "dso":
            raise ValueError("candidate_selector='dso' needs a host recursion per keyframe: the batched "
                             "driver supports coarse_to_fine and dso_fixed")
        if switch_cadence < 1:
            raise ValueError(f"switch_cadence must be >= 1, got {switch_cadence}")
        if switch_subbatch < -1:
            raise ValueError(f"switch_subbatch must be >= -1, got {switch_subbatch}")
        device = state.current_pose.q.device
        with profiling.span("vors.upload", bytes=depths.nbytes + imgs.nbytes) as upload_span:
            depths, imgs, staged = upload_clip(depths, imgs, device)
            if staged:  # a host clip: its images crossed, its depth maps stay on the host
                upload_span.count(bytes=staged, staged=staged)
        # a check frame of a host clip sends its switching lanes' depth rows into ``rows`` (the rows
        # the precompute reads) through the page-locked ``block``, both made at the first such frame
        host_depths = depths.device != device
        rows = block = None
        nb_frames, batch = imgs.shape[:2]
        clip_span.count(lanes=batch, frames=nb_frames)
        if nb_frames == 0 or depths.shape != imgs.shape or state.current_pose.q.shape != (batch, 4):
            raise ValueError(
                f"clips must be (F >= 1, B={state.current_pose.q.shape[0]}, H, W), got depths "
                f"{tuple(depths.shape)} and imgs {tuple(imgs.shape)}"
            )
        intrinsics = intrinsics.to(device)
        vel = config.warm_start == "constant_velocity"
        kf, keyframe_pose, current = state
        own_kf = False  # kf is this call's own copy, written in place, from the first switch on
        levels = None  # the level intrinsics, computed at the first switch
        ring = None
        if reloc_on:  # this call's own copy, written in place
            ring = RelocRing(tracker_mod.map_keyframe(torch.clone, reloc_ring.kf),
                             *(x.clone() for x in reloc_ring[1:]))
        pending = (
            torch.zeros(batch, dtype=torch.bool, device=device) if pending0 is None
            else torch.as_tensor(pending0, dtype=torch.bool, device=device)
        )
        prev = prev_pose0.to(device) if (vel and prev_pose0 is not None) else current
        no_switch = torch.zeros(batch, dtype=torch.bool, device=device)
        poses: List[Pose] = []
        results, switches, recoveries = [], [], []
        for t in range(nb_frames):
            with profiling.span("vors.step", id=frame_offset + t):
                with profiling.span("vors.solve"):
                    init_model = tracker_mod.warm_start_init(config, keyframe_pose, current, prev)
                    pyrs = pyramid_ops.mean_pyramid(config.nb_levels, imgs[t])
                    result = tracker_mod.track_frame(config, kf, pyrs, init_model, detector=reloc_on)
                new_current = _where_pose(result.failed, current, _solved_pose(keyframe_pose, result.model))
                switch_now = result.flow >= config.flow_threshold  # False for a NaN flow
                if reloc_on:
                    energy = result.detector[..., 0]
                    lost = result.failed | ~torch.isfinite(energy) | (energy > config.relocalize_energy_accept)
                    switch_now = switch_now & ~lost  # a lost frame never becomes a keyframe
                pending = pending | switch_now
                # a lane that pended earlier does not switch on a frame where it is lost
                switch_mask = pending & ~lost if reloc_on else pending
                switched = no_switch
                if (frame_offset + t + 1) % switch_cadence == 0:
                    with profiling.span("vors.read.switch_mask"):
                        lanes = torch.nonzero(switch_mask.cpu()).flatten()  # the check frame's host read
                    if lanes.numel() > 0:
                        depth = depths[t]
                        if host_depths:
                            with profiling.span("vors.upload", lanes=lanes.numel()) as upload_span:
                                if rows is None:
                                    rows = torch.empty(depths.shape[1:], dtype=Depth, device=device)
                                    block = torch.empty(depths.shape[1:], dtype=depths.dtype, pin_memory=True)
                                staged = upload_lanes(depth, lanes, rows, block)
                                upload_span.count(bytes=staged, staged=staged)
                            depth = rows
                        with profiling.span("vors.precompute", lanes=lanes.numel()):
                            idx = lanes.to(device)
                            if not own_kf:  # the caller's keyframe is never written
                                kf = tracker_mod.map_keyframe(_own_copy, kf)
                                levels = tracker_mod.level_intrinsics(intrinsics, len(pyrs))
                                own_kf = True
                            tracker_mod.precompute_keyframe_counts(config, levels, depth, pyrs, lanes=idx, into=kf)
                        keyframe_pose = _where_pose(switch_mask, new_current, keyframe_pose)
                        if reloc_on:
                            _ring_write(ring, idx, kf, new_current)
                        switched, pending = switch_mask, (pending & ~switch_mask) if reloc_on else no_switch
                relocalized = no_switch
                if reloc_on:
                    new_current, kf, keyframe_pose, relocalized = _recover_lost(
                        config, lost, pyrs, ring, new_current, kf, keyframe_pose
                    )
                if vel:
                    # across a failed, lost or relocalized lane the motion is
                    # unreliable: zero velocity next
                    reset = (result.failed | lost | relocalized) if reloc_on else result.failed
                    prev = _where_pose(reset, new_current, current)
                current = new_current
                poses.append(current)
                results.append(result)
                switches.append(switched)
                recoveries.append(relocalized)

        diags = StepDiagnostics(
            flow=torch.stack([r.flow for r in results]),
            failed=torch.stack([r.failed for r in results]),
            switched=torch.stack(switches),
            relocalized=torch.stack(recoveries),
            nb_iters=torch.stack([r.nb_iters for r in results]),
        )
        stacked = Pose(torch.stack([p.q for p in poses]), torch.stack([p.t for p in poses]))
        outs = (TrackState(kf=kf, keyframe_pose=keyframe_pose, current_pose=current), (stacked, diags))
        if return_pending:
            outs = outs + (pending,)
        if return_prev:
            outs = outs + (prev if vel else current,)
        if reloc_on:
            outs = outs + (ring,)
        return outs


def outputs_to_numpy(poses: Pose, diags: StepDiagnostics):
    """The stacked poses and diagnostics of a clip as numpy, in ONE
    device→host copy: ``(q (…, 4), t (…, 3), StepDiagnostics)``."""
    parts = [poses.q, poses.t, diags.flow[..., None], diags.failed[..., None],
             diags.switched[..., None], diags.relocalized[..., None], diags.nb_iters]
    with profiling.span("vors.read.outputs") as read_span:
        host = torch.cat([p.to(Float) for p in parts], dim=-1).cpu().numpy()
        read_span.count(bytes=host.nbytes)
    q, t, rest = host[..., 0:4], host[..., 4:7], host[..., 7:]
    return q, t, StepDiagnostics(
        flow=rest[..., 0], failed=rest[..., 1] != 0, switched=rest[..., 2] != 0,
        relocalized=rest[..., 3] != 0, nb_iters=rest[..., 4:].astype(np.int32),
    )


def make_sharded_step(config: TrackerConfig, intrinsics: Intrinsics, mesh, axis: str = "data"):
    """``batched_track_step`` with the lanes spread over the devices of
    ``mesh[axis]``: ``step(state, depths, imgs) -> (new_state,
    diagnostics)`` on the state's device, every lane bit-equal to the
    unsharded step."""
    devices = mesh.axis_devices(axis)

    def step(state: TrackState, depths, imgs):
        shards = zip(*(mesh_mod.shard_batch(x, mesh, axis) for x in (state, depths, imgs)))
        outs = mesh_mod.run_on_devices(
            lambda s, d, i: batched_track_step(config, intrinsics, s, d, i), devices, list(shards)
        )
        return mesh_mod.gather_batch(outs, state.current_pose.q.device)

    return step
