"""Checkpoint and resume of the streaming tracker and of the batched state.

The port of the tracker and batch parts of
``visual_odometry_rs_tpu/utils/checkpoint.py``, in the same file format, so
that a checkpoint written by either package resumes in the other: an npz
archive whose arrays ``leaf_0 .. leaf_N`` are the leaves of the state in the
JAX package's pytree order, and whose ``__meta__`` is a JSON object with the
format version, a fingerprint of the configuration and the host values
(timestamps, counters).  The window and SLAM parts of the JAX module belong
to the back end, which the port does not have yet (ROADMAP A11).

- **Leaf order.** ``tree_leaves`` flattens like ``jax.tree_util``: the keys
  of a dict sorted, the fields of a NamedTuple and the items of a tuple in
  order, ``None`` as no leaf.  The batched state is written in the JAX
  layout, where every lane carries its own copy of the intrinsics.
- **Fingerprint.** The hash covers the payload the JAX package would hash for
  the same configuration: its ``interp_method`` (the port indexes directly,
  which the JAX package's ``"auto"`` stands for) is added, and the port's
  ``dso_seed`` is left out while it is 0.  A non-default seed thins DSO
  points differently and changes the hash.
- **Dtypes and devices.** 64-bit leaves stay numpy (TUM timestamps are
  ~1.3e9 s: f32 would keep them to ~128 s).  Every other leaf becomes a
  tensor on the device of the live object's leaf it replaces: the keyframe
  on the tracker's device, which is the GPU on the card, its three poses on
  the host where the ``Tracker`` keeps them.  A save copies the device
  tensors to the host in one transfer.
- **Shapes.** The live object gives the structure and the file the shapes:
  a bucketed keyframe comes back at its bucket sizes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, List, Tuple

import numpy as np
import torch

FORMAT_VERSION = 2


class CheckpointMismatchError(RuntimeError):
    """Checkpoint is from a different format version or tracker config."""


# TrackerConfig fields that the JAX package added after its v2 fingerprint
# froze: left out of the hash while at their defaults, so that older
# checkpoints keep resuming; a non-default value changes the hash.
_FINGERPRINT_DEFAULT_EXCLUDED = {
    "candidate_selector": "coarse_to_fine",
    "dso_target": 2000,
    "dso_threshold_coef_a": 1.0,
    "dso_threshold_coef_b": 3,
    "warm_start": "constant_position",
    "level_max_iterations": None,
    "dso_block_size": 4,
}
# the JAX package's TrackerConfig field that the port has not, at the value
# that means what the port does
_JAX_ONLY_FIELDS = {"interp_method": "auto"}
# the port's TrackerConfig field that the JAX package has not, at the value
# that means what the JAX package does
_PORT_ONLY_DEFAULTS = {"dso_seed": 0}


def _config_payload(config) -> dict:
    d = dataclasses.asdict(config)
    d.update(_JAX_ONLY_FIELDS)
    for k, default in {**_PORT_ONLY_DEFAULTS, **_FINGERPRINT_DEFAULT_EXCLUDED}.items():
        if d.get(k) == default:
            d.pop(k, None)
    return d


def _intrinsics_list(intrinsics) -> List[float]:
    return [float(v) for v in (intrinsics.cx, intrinsics.cy, intrinsics.fx, intrinsics.fy, intrinsics.skew)]


def _hash(payload: dict) -> str:
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def config_fingerprint(config, intrinsics=None) -> str:
    """Stable hash of the tracker configuration (and the intrinsics)."""
    payload = {"config": _config_payload(config)}
    if intrinsics is not None:
        payload["intrinsics"] = _intrinsics_list(intrinsics)
    return _hash(payload)


# ---------------------------------------------------------------------------
# Pytrees of tensors and arrays, in the JAX package's leaf order
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_unflatten(template, leaves) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(template)


def _structure(tree) -> Any:
    """``tree`` with every leaf replaced by a placeholder that loads as numpy."""
    return tree_unflatten(tree, [0.0] * len(tree_leaves(tree)))


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _host_arrays(leaves) -> List[np.ndarray]:
    """The leaves as numpy; the tensors on a device come over in one copy."""
    out: List[Any] = [None] * len(leaves)
    on_device = [(i, x) for i, x in enumerate(leaves) if isinstance(x, torch.Tensor) and x.device.type != "cpu"]
    if on_device:
        flat = torch.cat(
            [x.detach().contiguous().reshape(-1).view(torch.uint8) for _, x in on_device]
        ).cpu().numpy()
        offset = 0
        for i, x in on_device:
            out[i] = np.frombuffer(flat, _numpy_dtype(x.dtype), x.numel(), offset).reshape(tuple(x.shape))
            offset += x.numel() * x.element_size()
    for i, x in enumerate(leaves):
        if out[i] is None:
            out[i] = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return out


def save_pytree(path: str, tree: Any, meta: dict | None = None) -> None:
    """Write ``tree``'s leaves and ``meta`` to ``path`` (npz).  The write goes
    to a temporary file that replaces ``path`` when complete, so a crash never
    leaves a truncated checkpoint; an open file keeps the exact path (numpy
    would add ``.npz`` to a bare name)."""
    arrays = {f"leaf_{i}": a for i, a in enumerate(_host_arrays(tree_leaves(tree)))}
    meta = dict(meta or {})
    meta.setdefault("format_version", FORMAT_VERSION)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _peek_meta(path: str) -> dict:
    with np.load(path) as raw:
        return json.loads(bytes(raw["__meta__"]).decode()) if "__meta__" in raw else {}


def _restore(array: np.ndarray, like):
    if array.dtype in (np.float64, np.int64) or not isinstance(like, torch.Tensor):
        return array
    return torch.from_numpy(array).to(like.device)


def load_pytree(path: str, template: Any) -> Tuple[Any, dict]:
    """Read a ``save_pytree`` file into ``template``'s structure: shapes and
    dtypes from the file; a leaf whose template leaf is a tensor becomes a
    tensor on that tensor's device, unless it is 64-bit."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
        likes = tree_leaves(template)
        restored = [_restore(data[f"leaf_{i}"], like) for i, like in enumerate(likes)]
    return tree_unflatten(template, restored), meta


def _check_meta(meta: dict, path: str, kind: str | None, expected: str, what: str) -> None:
    version = meta.get("format_version")
    if version != FORMAT_VERSION or meta.get("kind") != kind:
        raise CheckpointMismatchError(
            f"not a v{FORMAT_VERSION} {kind or 'tracker'} checkpoint "
            f"(version {version!r}, kind {meta.get('kind')!r}): {path}"
        )
    found = meta.get("config_fingerprint")
    if found != expected:
        raise CheckpointMismatchError(
            f"checkpoint config fingerprint {found!r} does not match the live {what}'s "
            f"{expected!r}: refusing to resume with mismatched semantics ({path})"
        )


# ---------------------------------------------------------------------------
# The streaming Tracker
# ---------------------------------------------------------------------------


def save_tracker(path: str, tracker) -> None:
    """Checkpoint a ``models.tracker.Tracker``'s resumable state (with the
    constant-velocity warm start, also its previous pose)."""
    state = {
        "keyframe_data": tracker.keyframe_data,
        "keyframe_pose": tracker.keyframe_pose,
        "current_pose": tracker.current_pose,
    }
    if tracker.config.warm_start == "constant_velocity":
        state["prev_pose"] = tracker.prev_pose
    meta = {
        "format_version": FORMAT_VERSION,
        "config_fingerprint": config_fingerprint(tracker.config, tracker.intrinsics),
        "keyframe_depth_timestamp": tracker.keyframe_depth_timestamp,
        "keyframe_img_timestamp": tracker.keyframe_img_timestamp,
        "current_depth_timestamp": tracker.current_depth_timestamp,
        "current_img_timestamp": tracker.current_img_timestamp,
        "keyframe_switches": tracker.keyframe_switches,
    }
    save_pytree(path, state, meta)


def load_tracker(path: str, tracker) -> None:
    """Restore ``save_tracker``'s state into a tracker with the same
    configuration and intrinsics; raises ``CheckpointMismatchError``
    otherwise, or for another format version."""
    _check_meta(_peek_meta(path), path, None, config_fingerprint(tracker.config, tracker.intrinsics), "tracker")
    template = {
        "keyframe_data": tracker.keyframe_data,
        "keyframe_pose": tracker.keyframe_pose,
        "current_pose": tracker.current_pose,
    }
    if tracker.config.warm_start == "constant_velocity":
        template["prev_pose"] = tracker.current_pose
    state, meta = load_pytree(path, template)
    tracker.keyframe_data = state["keyframe_data"]
    tracker.keyframe_pose = state["keyframe_pose"]
    tracker.current_pose = state["current_pose"]
    # without the carry the velocity restarts at zero (prev == current)
    tracker.prev_pose = state.get("prev_pose", tracker.current_pose)
    tracker.keyframe_depth_timestamp = meta["keyframe_depth_timestamp"]
    tracker.keyframe_img_timestamp = meta["keyframe_img_timestamp"]
    tracker.current_depth_timestamp = meta["current_depth_timestamp"]
    tracker.current_img_timestamp = meta["current_img_timestamp"]
    tracker.keyframe_switches = meta["keyframe_switches"]
    _reset_reloc_ring(tracker)


def sequence_matches(saved_ts, associations) -> bool:
    """True iff ``saved_ts`` (the depth timestamps of the frames a checkpoint
    consumed) is a prefix of ``associations``' depth timestamps, to 1e-6 s
    absolute: TUM timestamps are ~1.3e9 s, where a relative tolerance would
    accept every sequence of a recording session."""
    saved = np.asarray(saved_ts, np.float64)
    if len(associations) < len(saved):
        return False
    live = np.array([a.depth_timestamp for a in associations[: len(saved)]], np.float64)
    return bool(np.allclose(live, saved, rtol=0.0, atol=1e-6))


def _reset_reloc_ring(tracker) -> None:
    """Restart the relocalization ring after a restore.  The ring is a
    bounded cache and is not saved: it restarts from the restored keyframe
    when keyframes are unbucketed (so that they stack), else it refills on
    the next switches."""
    if tracker.config.relocalize_window <= 0:
        return
    tracker._reloc_history = []
    if not tracker.config.bucket_candidates:
        tracker._reloc_history.append((
            tracker.keyframe_data, tracker.keyframe_pose,
            tracker.keyframe_depth_timestamp, tracker.keyframe_img_timestamp,
        ))


# ---------------------------------------------------------------------------
# The batched state of vors_batch
# ---------------------------------------------------------------------------


def batch_fingerprint(config, intrinsics, switch_cadence: int) -> str:
    """Stable hash of the configuration, the intrinsics and the switch
    cadence (which decides on which frames lanes switch keyframes)."""
    return _hash({
        "config": _config_payload(config),
        "intrinsics": _intrinsics_list(intrinsics),
        "switch_cadence": int(switch_cadence),
    })


def _lanes_layout(kf, lead):
    """A keyframe with the intrinsics of each level repeated over ``lead``,
    the JAX package's batched layout."""
    from ..core.camera import Intrinsics

    return type(kf)(levels=tuple(
        obs._replace(intrinsics=Intrinsics(*(v.expand(lead) for v in obs.intrinsics))) for obs in kf.levels
    ))


def save_batch(
    path: str, state, pending, ring, frames_done: int,
    config, intrinsics, switch_cadence: int, lane_timestamps,
    prev_pose=None,
) -> None:
    """Checkpoint ``vors_batch``'s state between clips: the batched
    ``TrackState``, the (B,) pending-switch mask, the ``RelocRing`` or None,
    ``frames_done`` (the global index of the next frame: the cadence phase),
    per lane the depth timestamps of the frames consumed so far (frame 0
    included; ``sequence_matches`` checks them on resume) and, with the
    constant-velocity warm start, the previous poses."""
    lanes = tuple(state.current_pose.q.shape[:1])
    tree = {"state": state._replace(kf=_lanes_layout(state.kf, lanes)), "pending": pending}
    if ring is not None:
        tree["ring"] = ring._replace(kf=_lanes_layout(ring.kf, tuple(ring.pose_q.shape[:2])))
    if prev_pose is not None:
        tree["prev"] = prev_pose
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "batch",
        "config_fingerprint": batch_fingerprint(config, intrinsics, switch_cadence),
        "frames_done": int(frames_done),
        "has_ring": ring is not None,
        "has_prev": prev_pose is not None,
        "lane_timestamps": [[float(t) for t in ts] for ts in lane_timestamps],
    }
    save_pytree(path, tree, meta)


def load_batch(path: str, state_template, ring_template, config, intrinsics, switch_cadence: int):
    """Restore a ``save_batch`` checkpoint onto the device of
    ``state_template`` (a live batched state; ``ring_template`` a live ring,
    or None when relocalization is off).  Returns ``(state, pending, ring or
    None, frames_done, lane_timestamps, prev_pose or None)``.  Raises
    ``CheckpointMismatchError`` for another format, configuration,
    intrinsics, cadence or lane count, or when the ring's or the warm-start
    carry's presence differs from the live configuration's."""
    from .. import interop

    meta = _peek_meta(path)
    _check_meta(meta, path, "batch", batch_fingerprint(config, intrinsics, switch_cadence), "batch configuration")
    if meta.get("has_ring") != (ring_template is not None):
        raise CheckpointMismatchError(
            f"checkpoint relocalization-ring presence ({meta.get('has_ring')}) does not match the live "
            f"--relocalize setting ({ring_template is not None}) ({path})"
        )
    expect_prev = config.warm_start == "constant_velocity"
    if bool(meta.get("has_prev", False)) != expect_prev:
        raise CheckpointMismatchError(
            f"checkpoint warm-start carry presence ({meta.get('has_prev')}) does not match the live "
            f"warm_start setting ({path})"
        )
    template = {"state": _structure(state_template), "pending": 0.0}
    if expect_prev:
        template["prev"] = _structure(state_template.current_pose)
    if ring_template is not None:
        template["ring"] = _structure(ring_template)
    tree, _ = load_pytree(path, template)
    lanes_live = state_template.keyframe_pose.q.shape[0]
    lanes_saved = tree["state"].keyframe_pose.q.shape[0]
    if lanes_saved != lanes_live:
        raise CheckpointMismatchError(
            f"checkpoint batch size {lanes_saved} != live batch size {lanes_live} ({path})"
        )
    device = state_template.current_pose.q.device
    return (
        interop.track_state_from_numpy(tree["state"], device),
        torch.as_tensor(np.asarray(tree["pending"], bool), device=device),
        interop.reloc_ring_from_numpy(tree["ring"], device) if ring_template is not None else None,
        meta["frames_done"],
        [list(ts) for ts in meta["lane_timestamps"]],
        interop.pose_from_numpy(tree["prev"], device) if expect_prev else None,
    )
