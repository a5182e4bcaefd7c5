"""State carried between the JAX package and the port, as numpy arrays.

The JAX package's ``Intrinsics``, ``Pose``, ``LevelObs``, ``KeyframeData``
and ``TrackState`` are NamedTuples whose fields the port's types share by
name.  These functions take any object with those fields whose leaves numpy
can read (call ``np.asarray`` on the JAX arrays first) and build the port's
tensors on ``device``, or turn the port's state back into numpy.  No JAX is
imported here.

A batched JAX ``TrackState`` (``jax.vmap`` of ``init_state``) carries the
lane axis on every leaf, the intrinsics included; the port's batched state
shares one set of intrinsics, so ``track_state_from_numpy`` checks that the
lanes agree and ``track_state_to_numpy`` repeats them per lane.  The same
holds for a ``RelocRing`` (``reloc_ring_from_numpy``/``reloc_ring_to_numpy``),
whose keyframe leaves carry a (B, R) lead.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import Intrinsics
from .math.pose import Pose
from .models.tracker import KeyframeData, LevelObs
from .parallel.batch import RelocRing, TrackState
from .utils.types import to_numpy

_FLOAT_FIELDS = ("xs", "ys", "idepth", "tmpl_vals", "jacobians")


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def intrinsics_from_numpy(k, device="cpu") -> Intrinsics:
    return Intrinsics(*(_f32(getattr(k, f), device) for f in Intrinsics._fields))


def pose_from_numpy(p, device="cpu") -> Pose:
    return Pose(_f32(p.q, device), _f32(p.t, device))


def level_from_numpy(obs, device="cpu") -> LevelObs:
    return LevelObs(
        intrinsics=intrinsics_from_numpy(obs.intrinsics, device),
        template=torch.as_tensor(np.array(obs.template, np.uint8), device=device),
        valid=torch.as_tensor(np.array(obs.valid, bool), device=device),
        **{f: _f32(getattr(obs, f), device) for f in _FLOAT_FIELDS},
    )


def keyframe_from_numpy(kf, device="cpu") -> KeyframeData:
    return KeyframeData(levels=tuple(level_from_numpy(obs, device) for obs in kf.levels))


def pose_to_numpy(p: Pose) -> Pose:
    """The port's pose as a Pose of numpy arrays (q wxyz, t)."""
    return Pose(to_numpy(p.q), to_numpy(p.t))


def level_to_numpy(obs: LevelObs) -> LevelObs:
    return LevelObs(
        intrinsics=Intrinsics(*(to_numpy(v) for v in obs.intrinsics)),
        **{f: to_numpy(getattr(obs, f)) for f in LevelObs._fields if f != "intrinsics"},
    )


def keyframe_to_numpy(kf: KeyframeData) -> KeyframeData:
    return KeyframeData(levels=tuple(level_to_numpy(obs) for obs in kf.levels))


def _shared_intrinsics(k) -> Intrinsics:
    """Intrinsics repeated per lane (the JAX batched layout) → one set."""
    values = []
    for f in Intrinsics._fields:
        lanes = np.asarray(getattr(k, f), np.float32).reshape(-1)
        if not (lanes == lanes[0]).all():
            raise ValueError(f"the lanes disagree on the intrinsics' {f}: {lanes}")
        values.append(lanes[0])
    return Intrinsics(*values)


def _keyframe_shared_from_numpy(kf, device) -> KeyframeData:
    return KeyframeData(levels=tuple(
        level_from_numpy(obs._replace(intrinsics=_shared_intrinsics(obs.intrinsics)), device)
        for obs in kf.levels
    ))


def _keyframe_to_numpy_per_lane(kf: KeyframeData, lead) -> KeyframeData:
    levels = []
    for obs in kf.levels:
        out = level_to_numpy(obs)
        k = Intrinsics(*(np.broadcast_to(v, lead).copy() for v in out.intrinsics))
        levels.append(out._replace(intrinsics=k))
    return KeyframeData(levels=tuple(levels))


def track_state_from_numpy(state, device="cpu") -> TrackState:
    """A (batched) JAX ``TrackState`` of numpy leaves → the port's state."""
    return TrackState(
        kf=_keyframe_shared_from_numpy(state.kf, device),
        keyframe_pose=pose_from_numpy(state.keyframe_pose, device),
        current_pose=pose_from_numpy(state.current_pose, device),
    )


def track_state_to_numpy(state: TrackState) -> TrackState:
    """The port's state as numpy, laid out as the JAX package's: with a lane
    axis the intrinsics are repeated per lane."""
    lead = tuple(state.current_pose.q.shape[:-1])
    return TrackState(
        kf=_keyframe_to_numpy_per_lane(state.kf, lead),
        keyframe_pose=pose_to_numpy(state.keyframe_pose),
        current_pose=pose_to_numpy(state.current_pose),
    )


def reloc_ring_from_numpy(ring, device="cpu") -> RelocRing:
    """A JAX ``RelocRing`` of numpy leaves → the port's ring."""
    return RelocRing(
        kf=_keyframe_shared_from_numpy(ring.kf, device),
        pose_q=_f32(ring.pose_q, device), pose_t=_f32(ring.pose_t, device),
        count=torch.as_tensor(np.array(ring.count, np.int32), device=device),
        head=torch.as_tensor(np.array(ring.head, np.int32), device=device),
    )


def reloc_ring_to_numpy(ring: RelocRing) -> RelocRing:
    """The port's ring as numpy, laid out as the JAX package's: the
    intrinsics repeated per lane and slot."""
    return RelocRing(
        kf=_keyframe_to_numpy_per_lane(ring.kf, tuple(ring.pose_q.shape[:2])),
        pose_q=to_numpy(ring.pose_q), pose_t=to_numpy(ring.pose_t),
        count=to_numpy(ring.count), head=to_numpy(ring.head),
    )
