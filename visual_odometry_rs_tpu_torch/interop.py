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

The photometric window's types (``Window``, ``WindowResult``) convert the
same way, and ``window_state_to_numpy``/``window_state_from_numpy`` carry a
sliding window's state (the keyframe, its pose and refined inverse depths,
the members' images and models, the prior H and its anchors, the frame ids
and counters) between a JAX ``SlidingWindow``/``BatchedSlidingWindow`` read
into numpy and the port's windows, either way.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.camera import Intrinsics
from .math.pose import Pose
from .models.photometric_ba import Window, WindowResult
from .models.tracker import KeyframeData, LevelObs, map_keyframe
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


def window_from_numpy(win, device="cpu") -> Window:
    """A JAX ``Window`` of numpy leaves (one window, or stacked) → the port's."""
    return Window(
        tmpl_xs=_f32(win.tmpl_xs, device), tmpl_ys=_f32(win.tmpl_ys, device), tmpl_vals=_f32(win.tmpl_vals, device),
        valid=torch.as_tensor(np.array(win.valid, bool), device=device), idepth=_f32(win.idepth, device),
        poses=pose_from_numpy(win.poses, device), images=_f32(win.images, device),
        intrinsics=intrinsics_from_numpy(win.intrinsics, device),
    )


def window_to_numpy(win: Window) -> Window:
    return Window(*(pose_to_numpy(x) if isinstance(x, Pose) else Intrinsics(*(to_numpy(v) for v in x))
                    if isinstance(x, Intrinsics) else to_numpy(x) for x in win))


def window_result_from_numpy(res, device="cpu") -> WindowResult:
    return WindowResult(
        poses=pose_from_numpy(res.poses, device), idepth=_f32(res.idepth, device), energy=_f32(res.energy, device),
        nb_iter=torch.as_tensor(np.array(res.nb_iter, np.int32), device=device), ab=_f32(res.ab, device),
    )


def window_result_to_numpy(res: WindowResult) -> WindowResult:
    return WindowResult(*(pose_to_numpy(x) if isinstance(x, Pose) else to_numpy(x) for x in res))


_WINDOW_HOST = ("frame_ids", "keyframe_switches", "_next_id")


def _lane_axis(fn, kf_levels, kf_c2w, idepth, images, images_coarse, models, prior_H, prior_anchors):
    """``fn`` applied to every tensor of a window's state."""
    kf = map_keyframe(fn, KeyframeData(levels=tuple(kf_levels)))
    return dict(kf_levels=kf.levels, kf_c2w=Pose(fn(kf_c2w.q), fn(kf_c2w.t)), idepth=fn(idepth),
                images=[fn(x) for x in images], images_coarse=[fn(x) for x in images_coarse],
                models=[Pose(fn(m.q), fn(m.t)) for m in models], prior_H=fn(prior_H),
                prior_anchors=Pose(fn(prior_anchors.q), fn(prior_anchors.t)))


_WINDOW_DEVICE = ("kf_levels", "kf_c2w", "idepth", "images", "images_coarse", "models", "prior_H", "prior_anchors")


def window_state_to_numpy(sw) -> dict:
    """A sliding window's state as numpy, in the JAX package's layout: the
    attributes of its ``SlidingWindow`` (without the port's lane axis of 1)
    or ``BatchedSlidingWindow`` (the intrinsics repeated per lane), with the
    per-slot lists kept as lists."""
    batched = sw.frame_ids is not None and np.ndim(sw.frame_ids) == 2
    st = {k: getattr(sw, k) for k in _WINDOW_DEVICE}
    if not batched:
        st = _lane_axis(lambda x: x[0], **st)
    kf = KeyframeData(levels=tuple(st["kf_levels"]))
    return {
        "kf_levels": (_keyframe_to_numpy_per_lane(kf, (sw.batch,)) if batched else keyframe_to_numpy(kf)).levels,
        "kf_c2w": pose_to_numpy(st["kf_c2w"]), "idepth": to_numpy(st["idepth"]),
        "images": [to_numpy(x) for x in st["images"]], "images_coarse": [to_numpy(x) for x in st["images_coarse"]],
        "models": [pose_to_numpy(m) for m in st["models"]], "prior_H": to_numpy(st["prior_H"]),
        "prior_anchors": pose_to_numpy(st["prior_anchors"]),
        **{k: np.array(getattr(sw, k)) if k != "_next_id" else int(sw._next_id) for k in _WINDOW_HOST},
    }


def window_state_from_numpy(sw, state) -> None:
    """Load a window state (``window_state_to_numpy``'s dict, or the same
    attributes read from a JAX window) into the port's window ``sw``, on
    its device.  A batched state's intrinsics must agree across lanes."""
    device = sw.device
    batched = np.ndim(state["frame_ids"]) == 2
    kf = KeyframeData(levels=tuple(state["kf_levels"]))
    st = dict(
        kf_levels=(_keyframe_shared_from_numpy(kf, device) if batched else keyframe_from_numpy(kf, device)).levels,
        kf_c2w=pose_from_numpy(state["kf_c2w"], device), idepth=_f32(state["idepth"], device),
        images=[_f32(x, device) for x in state["images"]],
        images_coarse=[_f32(x, device) for x in state["images_coarse"]],
        models=[pose_from_numpy(m, device) for m in state["models"]], prior_H=_f32(state["prior_H"], device),
        prior_anchors=pose_from_numpy(state["prior_anchors"], device),
    )
    if not batched:
        st = _lane_axis(lambda x: x[None], **st)
    for k, v in st.items():
        setattr(sw, k, v)
    if batched:
        sw.batch = int(np.shape(state["frame_ids"])[1])
        sw.frame_ids = np.asarray(state["frame_ids"], np.int64)
        sw.keyframe_switches = np.asarray(state["keyframe_switches"], np.int64)
    else:
        sw.frame_ids = [int(i) for i in state["frame_ids"]]
        sw.keyframe_switches = int(state["keyframe_switches"])
    sw._next_id = int(state["_next_id"])
