"""Sparse 3D map export: keyframe candidates → world-frame point cloud.

The port of ``visual_odometry_rs_tpu/utils/pointcloud.py``: every
keyframe's level-0 candidate points back-projected through its
(loop-closure-optimized) camera-to-world pose into one world-frame cloud,
written as ASCII PLY (MeshLab, CloudCompare, Open3D read it).

``keyframe_clouds`` runs on the device it is given, 16 keyframes at a time
as one lane axis: one batched mean pyramid, candidate selection, inverse
depth and back-projection; the ``valid`` mask (selected and known depth) is
applied on the host.  ``voxel_downsample``, ``write_ply`` and ``read_ply``
are numpy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core import camera as camera_mod
from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math.pose import Pose
from ..ops import pyramid as pyramid_ops
from .types import depth_tensor, image_tensor, resolve_device, to_numpy

CHUNK = 16  # keyframes a batch: bounds the device memory of the precompute


def keyframe_clouds(
    config,
    intrinsics: Intrinsics,
    depths: Sequence[np.ndarray],
    grays: Sequence[np.ndarray],
    poses: Sequence[Pose],
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Back-project the level-0 candidates of ``K`` keyframes to world space.

    ``depths``/``grays``: raw u16 depth and u8 gray keyframe images;
    ``poses``: camera-to-world pose per keyframe (the optimized poses after
    pose-graph refinement).  Returns ``(points, intensities)``, (M, 3) f32
    world coordinates (meters) and (M,) u8 template intensities, without
    padding, unknown-depth and non-positive-depth candidates.  Runs on
    ``device``, the GPU unless the caller names another; each chunk comes
    to the host in one read."""
    from ..models import tracker as tracker_mod

    K = len(depths)
    assert K == len(grays) == len(poses)
    dev = resolve_device(device)
    intr = intrinsics.to(dev)
    pts_parts, int_parts = [], []
    for s in range(0, K, CHUNK):
        e = min(s + CHUNK, K)
        gray = image_tensor(np.stack([np.asarray(g) for g in grays[s:e]]), dev)
        depth = depth_tensor(np.stack([np.asarray(d) for d in depths[s:e]]), dev)
        c2w = Pose(torch.stack([p.q for p in poses[s:e]]).to(dev), torch.stack([p.t for p in poses[s:e]]).to(dev))
        pyr = pyramid_ops.mean_pyramid(config.nb_levels, gray)
        obs = tracker_mod.precompute_keyframe(config, intr, depth, pyr).levels[0]
        ok = obs.valid & (obs.idepth > 0.0)
        # idepth = depth_scale / raw_u16 and raw / depth_scale is meters, so
        # 1 / idepth is metric depth (inverse_depth.rs:24-29); a tensor
        # divided by a tensor: torch's scalar / tensor rounds twice
        one = torch.ones_like(obs.idepth)
        z = one / torch.where(ok, obs.idepth, one)
        cam = camera_mod.back_project(obs.intrinsics, torch.stack([obs.xs, obs.ys], dim=-1), z)
        world = pose_mod.apply(Pose(c2w.q[:, None], c2w.t[:, None]), cam)
        host = to_numpy(torch.cat([world, obs.tmpl_vals[..., None], ok[..., None].to(world.dtype)], dim=-1))
        mask = host[..., 4].reshape(-1) != 0.0
        pts_parts.append(host[..., :3].reshape(-1, 3)[mask].astype(np.float32))
        int_parts.append(np.clip(host[..., 3].reshape(-1)[mask], 0, 255).astype(np.uint8))
    return np.concatenate(pts_parts), np.concatenate(int_parts)


def voxel_downsample(points: np.ndarray, intensities: np.ndarray, voxel_size: float) -> Tuple[np.ndarray, np.ndarray]:
    """Keep one representative point per ``voxel_size``-meter cube: the
    centroid of each voxel's points and their mean intensity, rounded (one
    lexsort and a reduceat)."""
    if voxel_size <= 0.0 or len(points) == 0:
        return points, intensities
    cells = np.floor(points / voxel_size).astype(np.int64)
    order = np.lexsort((cells[:, 2], cells[:, 1], cells[:, 0]))
    cells = cells[order]
    new_cell = np.ones(len(cells), bool)
    new_cell[1:] = (cells[1:] != cells[:-1]).any(axis=1)
    starts = np.flatnonzero(new_cell)
    counts = np.diff(np.append(starts, len(cells)))[:, None].astype(np.float64)
    pts_sorted = points[order].astype(np.float64)
    int_sorted = intensities[order].astype(np.float64)
    pts_out = np.add.reduceat(pts_sorted, starts, axis=0) / counts
    int_out = np.add.reduceat(int_sorted, starts) / counts[:, 0]
    return pts_out.astype(np.float32), np.clip(np.rint(int_out), 0, 255).astype(np.uint8)


def write_ply(path: str, points: np.ndarray, intensities: np.ndarray) -> None:
    """Serialize a gray-colored point cloud as ASCII PLY."""
    points = np.asarray(points, np.float32)
    intensities = np.asarray(intensities, np.uint8)
    assert points.ndim == 2 and points.shape[1] == 3
    assert intensities.shape == (points.shape[0],)
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {len(points)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    cols = np.concatenate([points, np.repeat(intensities[:, None], 3, axis=1)], axis=1)
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, cols, fmt=("%.6f", "%.6f", "%.6f", "%d", "%d", "%d"))


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read back an ASCII PLY written by ``write_ply``."""
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "ply"
    n = next(int(line.split()[-1]) for line in lines if line.startswith("element vertex"))
    start = lines.index("end_header") + 1
    rows = [line.split() for line in lines[start : start + n]]
    pts = np.array([[float(v) for v in r[:3]] for r in rows], np.float32).reshape(-1, 3)
    inten = np.array([int(r[3]) for r in rows], np.uint8)
    return pts, inten
