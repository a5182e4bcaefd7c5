"""Loop closure: propose and photometrically verify loop edges.

The port of ``visual_odometry_rs_tpu/models/loop_closure.py``:

1. **Proposal** (``propose_candidates``, host numpy): pairs (i, j) whose
   estimated poses are close in position and orientation but far apart in
   time, found through a spatial hash grid, closest first, at most
   ``max_candidates``.  The same pairs in the same order as the JAX
   package, and the same note on stderr when the cap drops some.
2. **Verification** (``detect_loops``): keyframe i's candidates aligned to
   frame j's image by the tracker's own coarse-to-fine solve, from the
   odometry estimate.  On a GPU every pair is a lane of one lane-axis
   ``track_frame``: six ``lm_solve_level`` launches for all pairs, the
   unique i keyframes precomputed once and gathered per lane, the unique j
   pyramids stacked once and read through the kernel's image index, and
   the finest launch also writing each lane's plain energy and inside and
   valid counts at the final pose (the JAX package's ``_eval_energy``).
   The caller reads the outcome once.
3. **Emission**: verified edges ``(i, j, Z_ij, energy)`` with
   ``Z_ij = T_i⁻¹ T_j``, ready for ``parallel.pose_graph.odometry_graph``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math.pose import Pose
from ..ops import pyramid as pyramid_ops
from ..utils.types import Float, depth_tensor, image_tensor, resolve_device
from . import tracker as tracker_mod


@dataclass(frozen=True)
class LoopClosureConfig:
    """Gates for proposal and photometric verification."""

    # proposal: position / orientation proximity of the estimated poses
    radius: float = 0.5  # meters
    max_angle: float = 0.6  # radians
    min_gap: int = 10  # frames of temporal separation
    max_candidates: int = 16  # closest-first cap on verification work
    # verification: photometric acceptance
    energy_accept: float = 300.0  # mean squared intensity over inside points
    min_inside_frac: float = 0.3  # fraction of keyframe candidates in view


def _host_poses(poses: Sequence[Pose]) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 3) translations and (N, 4) quaternions as float64 numpy."""
    t = np.stack([np.asarray(torch.as_tensor(p.t).detach().cpu(), np.float64) for p in poses])
    q = np.stack([np.asarray(torch.as_tensor(p.q).detach().cpu(), np.float64) for p in poses])
    return t, q


def _pair_gates(t, q, ids, i, j, lc: LoopClosureConfig):
    """(passes, dist) for the ordered pair (i later, j earlier)."""
    if ids[i] - ids[j] <= lc.min_gap:
        return False, 0.0
    d = float(np.linalg.norm(t[i] - t[j]))
    if d >= lc.radius:
        return False, d
    # relative rotation angle from |<q_i, q_j>|: angle = 2 acos(|dot|)
    dot = abs(float(np.dot(q[i], q[j])))
    ang = 2.0 * np.arccos(min(max(dot, -1.0), 1.0))
    return ang < lc.max_angle, d


def propose_candidates(poses: Sequence[Pose], lc: LoopClosureConfig, node_ids=None) -> List[Tuple[int, int]]:
    """Candidate loop pairs (i, j), ``ids[i] - ids[j] > min_gap``, by pose
    proximity, closest first, at most ``max_candidates``.  ``node_ids`` maps
    each pose to its temporal identity (a frame index when the poses are
    keyframes); the gap gate uses them, list positions by default.  A
    spatial hash grid of cell ``radius`` (27 neighbour cells a node) gives
    exactly the all-pairs result (``_propose_bruteforce``)."""
    if lc.min_gap < 0:
        # with a negative gap both temporal orderings of a pair can pass,
        # where the grid emits one ordered pair and the all-pairs
        # formulation emits two
        raise ValueError(f"min_gap must be >= 0, got {lc.min_gap}")
    t, q = _host_poses(poses)
    n = t.shape[0]
    ids = np.asarray(node_ids if node_ids is not None else np.arange(n))

    cell = max(float(lc.radius), 1e-9)
    grid: dict = {}
    pairs: List[Tuple[int, int]] = []
    dists: dict = {}
    cells_of = np.floor(t / cell).astype(np.int64)
    for i in range(n):
        ci = tuple(cells_of[i])
        # every unordered pair is examined once, at the later list index's
        # insertion, in both temporal orderings
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for j in grid.get((ci[0] + dx, ci[1] + dy, ci[2] + dz), ()):
                        ok, d = _pair_gates(t, q, ids, i, j, lc)
                        if ok:
                            pairs.append((i, j))
                            dists[(i, j)] = d
                        else:
                            ok, d = _pair_gates(t, q, ids, j, i, lc)
                            if ok:
                                pairs.append((j, i))
                                dists[(j, i)] = d
        grid.setdefault(ci, []).append(i)

    pairs.sort(key=lambda p: (dists[p], p))
    if len(pairs) > lc.max_candidates:
        print(
            f"loop_closure: {len(pairs)} proposals, verifying closest "
            f"{lc.max_candidates}, dropping {len(pairs) - lc.max_candidates} "
            f"(raise max_candidates to verify more)",
            file=sys.stderr,
        )
    return pairs[: lc.max_candidates]


def _propose_bruteforce(poses: Sequence[Pose], lc: LoopClosureConfig, node_ids=None) -> List[Tuple[int, int]]:
    """All-pairs proposal, the oracle of the grid version (O(N²) memory)."""
    t, q = _host_poses(poses)
    n = t.shape[0]
    ids = np.asarray(node_ids if node_ids is not None else np.arange(n))
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    gap_ok = ids[ii] - ids[jj] > lc.min_gap
    dist = np.linalg.norm(t[ii] - t[jj], axis=-1)
    dots = np.abs(np.sum(q[ii] * q[jj], axis=-1))
    ang = 2.0 * np.arccos(np.clip(dots, -1.0, 1.0))
    ok = gap_ok & (dist < lc.radius) & (ang < lc.max_angle)
    pairs = [(int(i), int(j)) for i, j in zip(ii[ok], jj[ok])]
    pairs.sort(key=lambda p: (dist[p[0], p[1]], p))
    return pairs[: lc.max_candidates]


class Verification(NamedTuple):
    """Per pair, on the device: the refined keyframe→frame model, the
    solve's failed flag, the finest level's plain energy at the model and
    the fraction of the keyframe's valid candidates inside the image."""

    model: Pose  # (K, 4), (K, 3)
    failed: torch.Tensor  # (K,) bool
    energy: torch.Tensor  # (K,) f32
    inside_frac: torch.Tensor  # (K,) f32


def _stacked(frames, ids, device, convert) -> torch.Tensor:
    return convert(np.stack([np.asarray(frames[k]) for k in ids]), device)


def verify_pairs(
    config: tracker_mod.TrackerConfig,
    intrinsics: Intrinsics,
    poses: Sequence[Pose],
    depths: Sequence,
    grays: Sequence,
    pairs: Sequence[Tuple[int, int]],
    device="cuda",
) -> Verification:
    """Align keyframe i to frame j for every pair, all pairs as lanes of one
    lane-axis ``track_frame`` from ``T_j⁻¹ ∘ T_i`` (the tracker's model
    convention, inverse_compositional.rs:177).  Nothing is read on the
    host."""
    dev = resolve_device(device)
    uniq_i = sorted({i for i, _ in pairs})
    uniq_j = sorted({j for _, j in pairs})
    idx_i = torch.tensor([uniq_i.index(i) for i, _ in pairs], dtype=torch.int64, device=dev)
    idx_j = torch.tensor([uniq_j.index(j) for _, j in pairs], dtype=torch.int32, device=dev)
    intr = intrinsics.to(dev)
    pyr_i = pyramid_ops.mean_pyramid(config.nb_levels, _stacked(grays, uniq_i, dev, image_tensor))
    kfs = tracker_mod.precompute_keyframe(config, intr, _stacked(depths, uniq_i, dev, depth_tensor), pyr_i)
    kfs_sel = tracker_mod.map_keyframe(lambda x: x[idx_i], kfs)
    pyr_j = pyramid_ops.mean_pyramid(config.nb_levels, _stacked(grays, uniq_j, dev, image_tensor))
    pose_i = Pose(torch.stack([poses[i].q for i, _ in pairs]), torch.stack([poses[i].t for i, _ in pairs]))
    pose_j = Pose(torch.stack([poses[j].q for _, j in pairs]), torch.stack([poses[j].t for _, j in pairs]))
    init = pose_mod.compose(pose_mod.inverse(pose_j.to(dev)), pose_i.to(dev))
    result = tracker_mod.track_frame(config, kfs_sel, pyr_j, init, detector=True, image_index=idx_j)
    energy, inside, valid = result.detector.unbind(-1)
    return Verification(result.model, result.failed, energy, inside / torch.clamp(valid, min=1.0))


def detect_loops(
    config: tracker_mod.TrackerConfig,
    intrinsics: Intrinsics,
    poses: Sequence[Pose],
    depths: Sequence,
    grays: Sequence,
    lc: LoopClosureConfig = LoopClosureConfig(),
    node_ids=None,
    device="cuda",
):
    """Propose and verify loop closures over a trajectory.

    ``poses`` are the (drifting) camera-to-world estimates, ``depths`` and
    ``grays`` the frames' u16 depth and u8 images (anything indexable).
    Returns ``(i, j, Z_ij, energy)`` for every verified pair, ``Z_ij = T_i⁻¹
    T_j`` a Pose of CPU tensors.  Verification runs on ``device``, the GPU
    unless the caller names another, in one lane-axis solve
    (``verify_pairs``); its outcome comes to the host in one read."""
    pairs = propose_candidates(poses, lc, node_ids=node_ids)
    if not pairs:
        return []
    ver = verify_pairs(config, intrinsics, poses, depths, grays, pairs, device)
    host = torch.cat([torch.stack([ver.failed.to(Float), ver.energy, ver.inside_frac], dim=-1),
                      ver.model.q, ver.model.t], dim=-1).cpu()
    edges = []
    for k, (i, j) in enumerate(pairs):
        failed, e, frac = host[k, 0] != 0.0, float(host[k, 1]), float(host[k, 2])
        if not failed and np.isfinite(e) and e <= lc.energy_accept and frac >= lc.min_inside_frac:
            # Z_ij = T_i⁻¹ T_j = model⁻¹
            edges.append((i, j, pose_mod.inverse(Pose(host[k, 3:7], host[k, 7:10])), e))
    return edges
