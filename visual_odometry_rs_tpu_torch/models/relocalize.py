"""Relocalization: recover a lost track against a ring of recent keyframes.

The port of ``visual_odometry_rs_tpu/models/relocalize.py``.  The reference
has no recovery path: a frame whose solve fails keeps its previous pose
(inverse_compositional.rs:195-199).  When the host ``Tracker`` finds a frame
lost, it tracks the frame again against its last K keyframes, from identity
(after a kidnap the current pose is exactly what cannot be trusted), and
adopts the best keyframe that verifies photometrically.

On a GPU the K keyframes are K lanes of one lane-axis ``track_frame``: six
``lm_solve_level`` launches, every lane reading the one current frame
through the kernel's image index, and the finest launch also writing each
lane's plain energy and inside and valid counts (the detector).  The
ranking is a few tensor operations on the device; the caller reads the
outcome once.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..math import pose as pose_mod
from ..math.pose import Pose
from . import tracker as tracker_mod


class RelocalizeResult(NamedTuple):
    pose: Pose  # recovered camera-to-world pose (valid iff ``ok``)
    best: torch.Tensor  # 0-d int32: index of the chosen keyframe in the history
    energy: torch.Tensor  # 0-d f32: its final finest-level mean squared residual
    ok: torch.Tensor  # 0-d bool: some keyframe verified under the thresholds


def rank(failed, energies, inside, valid, energy_accept: float, min_inside_frac: float, empty=None):
    """The choice among candidate solves along the last axis: a solve that
    failed, has a non-finite energy, sees less than ``min_inside_frac`` of
    its valid candidates inside the image (or is ``empty``) scores +inf,
    the others their energy; ``best`` is the first minimum and ``ok`` says
    whether its score is at most ``energy_accept``.  Returns (best, ok)."""
    fracs = inside / torch.clamp(valid, min=1.0)
    bad = failed | ~torch.isfinite(energies) | (fracs < min_inside_frac)
    if empty is not None:
        bad = bad | empty
    score = torch.where(bad, torch.full_like(energies, float("inf")), energies)
    best = torch.argmin(score, dim=-1)  # the first minimum
    ok = torch.gather(score, -1, best[..., None])[..., 0] <= energy_accept
    return best, ok


def attempt(
    config,
    kfs,  # stacked KeyframeData, leading axis K
    kf_q: torch.Tensor,  # (K, 4) keyframe camera-to-world quaternions
    kf_t: torch.Tensor,  # (K, 3) keyframe camera-to-world translations
    pyr: List[torch.Tensor],  # current-frame pyramid, shared by all K
    energy_accept: float,
    min_inside_frac: float,
) -> RelocalizeResult:
    """One lane-axis solve of the current frame against K keyframes, from
    identity; nothing is read on the host."""
    device = pyr[0].device
    nb = kf_q.shape[0]
    init = tracker_mod.identity_lanes(nb, device)
    shared = [p[None] for p in pyr]  # one image, read by every lane
    image_index = torch.zeros(nb, dtype=torch.int32, device=device)
    result = tracker_mod.track_frame(config, kfs, shared, init, detector=True, image_index=image_index)
    energies, inside, valid = result.detector.unbind(-1)
    best, ok = rank(result.failed, energies, inside, valid, energy_accept, min_inside_frac)
    # the model maps keyframe pixels into the current frame, so the
    # recovered camera-to-world pose is T_kf ∘ model⁻¹
    kf_pose = Pose(kf_q.to(device)[best], kf_t.to(device)[best])
    pose = pose_mod.compose(kf_pose, pose_mod.inverse(Pose(result.model.q[best], result.model.t[best])))
    return RelocalizeResult(pose=pose, best=best.to(torch.int32), energy=energies[best], ok=ok)


def stack_history(history: List[Tuple]):
    """Stack a list of (KeyframeData, Pose, …) into lane-axis keyframes and
    (K, 4), (K, 3) poses.  The entries must be unbucketed precompute
    outputs (equal shapes); the host ``Tracker`` records them so."""
    kfs = tracker_mod.map_keyframe(lambda *leaves: torch.stack(leaves), *[entry[0] for entry in history])
    kf_q = torch.stack([entry[1].q for entry in history])
    kf_t = torch.stack([entry[1].t for entry in history])
    return kfs, kf_q, kf_t
