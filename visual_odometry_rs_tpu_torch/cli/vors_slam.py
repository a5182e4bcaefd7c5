"""CLI: the SLAM pipeline: track, detect loop closures, optimize the graph.

    python -m visual_odometry_rs_tpu_torch.cli.vors_slam [fr1|fr2|fr3|icl] associations_file > traj.txt

The port of ``visual_odometry_rs_tpu/cli/vors_slam.py``:

1. **Track** every frame with the streaming ``Tracker`` (as ``vors_track``,
   without bucketing), recording which frames became keyframes.
2. **Detect loops** between keyframes (``models.loop_closure``): pose
   proximity proposes pairs, and one lane-axis solve verifies them all.
3. **Optimize** a pose graph over the keyframes (the tracked chain plus the
   verified loop edges, ``parallel.pose_graph``: the dense solve up to 64
   keyframes, the sparse one above), then give every frame its preceding
   keyframe's correction.

The optimized TUM trajectory goes to stdout; diagnostics (per-frame flow,
the loop edges, the graph's energy) to stderr.  With no verified loop the
output is the tracked trajectory.  It runs on CUDA unless ``--cpu`` is
given, and fails if CUDA is absent.  ``--export-cloud`` writes the sparse
map (``utils.pointcloud``); ``--save-state``/``--resume`` checkpoint the
tracking phase in the JAX CLI's format; ``--kf-store disk`` (the default)
keeps only the keyframes' frame ids and decodes their images again when
loop closure or the export needs them.  ``--refine-window W`` runs the
photometric sliding window (``models.sliding_window``) beside tracking:
every member of the window takes its refined pose, so loop closure sees
the refined trajectory; ``--save-state`` writes its state to
``PATH.window`` and ``--resume`` reads it back.
"""

from __future__ import annotations

import argparse
import sys

from . import _common
from ._common import add_option_flags, option_fields

USAGE = "Usage: vors_slam [fr1|fr2|fr3|icl] associations_file"


class _KeyframeStore:
    """Keyframe image retention (``--kf-store``).

    ``memory``: every keyframe's (depth, gray) stays resident, O(keyframes
    x image) host memory (about 0.9 MB a keyframe at 640x480).  ``disk``:
    only the frame id is kept; images are decoded again from the dataset
    on demand through a small LRU (verification touches at most the
    proposal endpoints, the export streams in chunks), so the front end's
    memory stays O(1) in the trajectory's length."""

    def __init__(self, mode: str, associations, lru: int = 32):
        self.mode = mode
        self._assocs = associations
        self._mem = {}
        self._lru: "dict[int, tuple]" = {}
        # verification fetches the depths and the grays of the unique
        # proposal endpoints in separate passes, so the LRU must hold all of
        # them at once or every endpoint is decoded twice
        self._LRU = max(32, lru)

    def put(self, fid: int, depth, gray) -> None:
        if self.mode == "memory":
            self._mem[fid] = (depth, gray)

    def get(self, fid: int):
        if self.mode == "memory":
            return self._mem[fid]
        if fid in self._lru:
            self._lru[fid] = self._lru.pop(fid)  # refresh recency
            return self._lru[fid]
        from ..dataset import tum_rgbd

        frame = tum_rgbd.read_images(self._assocs[fid])
        self._lru[fid] = frame
        while len(self._lru) > self._LRU:
            self._lru.pop(next(iter(self._lru)))
        return frame

    def images_for_checkpoint(self):
        """The images for ``checkpoint.save_slam``: None in the disk mode
        (the checkpoint stays the tracker's size; a resume decodes again)."""
        return self._mem if self.mode == "memory" else None


class _LazyFrames:
    """List-like view of the keyframes' depths (``part=0``) or grays
    (``part=1``) that decodes through a ``_KeyframeStore`` on access: what
    ``loop_closure.detect_loops`` (int indexing) and
    ``pointcloud.keyframe_clouds`` (len and slices) read."""

    def __init__(self, store: _KeyframeStore, fids, part: int):
        self._store = store
        self._fids = list(fids)
        self._part = part

    def __len__(self) -> int:
        return len(self._fids)

    def __getitem__(self, k):
        if isinstance(k, slice):
            return [self._store.get(f)[self._part] for f in self._fids[k]]
        return self._store.get(self._fids[k])[self._part]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=USAGE)
    parser.add_argument("camera_id", choices=["fr1", "fr2", "fr3", "icl"])
    parser.add_argument("associations_file")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    parser.add_argument("--nb-levels", type=int, default=6)
    parser.add_argument("--diff-threshold", type=int, default=7)
    parser.add_argument("--candidate-cap", type=int, default=8192)
    # loop-closure gates (models/loop_closure.py's defaults are conservative)
    parser.add_argument("--loop-radius", type=float, default=0.5,
                        help="max estimated distance between loop endpoints (m)")
    parser.add_argument("--loop-max-angle", type=float, default=0.6, help="max estimated relative rotation (rad)")
    parser.add_argument("--loop-min-gap", type=int, default=10, help="min temporal separation in FRAMES")
    parser.add_argument("--loop-max-candidates", type=int, default=16)
    parser.add_argument("--loop-energy-accept", type=float, default=300.0,
                        help="max mean squared intensity for a verified edge")
    parser.add_argument("--save-state", metavar="PATH",
                        help="checkpoint the tracking phase (tracker + trajectory + keyframe store) to PATH "
                        "every --save-every frames and at its end")
    parser.add_argument("--save-every", type=int, default=100, metavar="N")
    parser.add_argument("--resume", metavar="PATH",
                        help="resume tracking from a --save-state checkpoint (refuses on config mismatch); "
                        "loop closure + PGO run at the end as usual")
    parser.add_argument("--export-cloud", metavar="PATH",
                        help="write the sparse 3D map (keyframe candidate points back-projected through the "
                        "optimized poses) as an ASCII PLY file")
    parser.add_argument("--cloud-voxel", type=float, default=0.0, metavar="METERS",
                        help="voxel-grid downsample the exported cloud (one centroid per cube); 0 = every point")
    parser.add_argument("--refine-window", type=int, default=0, metavar="W",
                        help="sliding-window photometric BA over a window of W frames (marginalization and "
                        "prior transfer, models.sliding_window) alongside tracking; loop closure then sees "
                        "the refined poses.  0 = off")
    parser.add_argument("--refine-energy-tol", type=float, default=1.0,
                        help="per-pair d_energy stop for the window solves (with --refine-window)")
    add_option_flags(parser, selectors=("coarse_to_fine", "dso", "dso_fixed"))
    parser.add_argument("--warm-start", choices=["constant_position", "constant_velocity"],
                        default="constant_position", help="per-frame LM init (see vors_track --warm-start)")
    parser.add_argument("--level-iterations", metavar="N0,N1,...", default=None,
                        help="per-level LM iteration caps, finest first (see vors_track --level-iterations)")
    parser.add_argument("--kf-store", choices=["disk", "memory"], default="disk",
                        help="keyframe image retention for loop closure and the export: 'disk' (default) "
                        "decodes keyframe frames again on demand, O(1) memory in the trajectory's length; "
                        "'memory' keeps every keyframe's depth+gray resident")
    return parser


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    import torch

    from ..dataset import tum_rgbd
    from ..math import pose as pose_mod
    from ..math.pose import Pose
    from ..models import loop_closure
    from ..models import tracker as tracker_mod
    from ..parallel import pose_graph
    from ..utils import checkpoint as ckpt_mod
    from ..utils.types import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    try:
        associations = tum_rgbd.load_associations(args.associations_file)
    except OSError as e:
        print(USAGE, file=sys.stderr)
        print(f"Cannot read associations: {e}", file=sys.stderr)
        return 1
    if not associations:
        print("Empty associations file", file=sys.stderr)
        return 1

    depth0, gray0 = tum_rgbd.read_images(associations[0])
    h, w = gray0.shape
    intrinsics = tum_rgbd.scaled_intrinsics(args.camera_id, h, w)
    if (h, w) != (tum_rgbd.NATIVE_HEIGHT, tum_rgbd.NATIVE_WIDTH):
        print(f"note: {args.camera_id} intrinsics rescaled to {w}x{h} inputs", file=sys.stderr)
    config = tracker_mod.TrackerConfig(
        height=h, width=w,
        nb_levels=args.nb_levels,
        candidates_diff_threshold=args.diff_threshold,
        depth_scale=tum_rgbd.DEPTH_SCALE,
        idepth_variance=tum_rgbd.VARIANCE_TUM,
        candidate_cap=args.candidate_cap,
        warm_start=args.warm_start,
        level_max_iterations=_common.parse_level_iterations(args.level_iterations, args.nb_levels),
        **option_fields(args),
    )

    # --- 1. track ---------------------------------------------------------
    store = _KeyframeStore(args.kf_store, associations, lru=2 * args.loop_max_candidates)
    trk = tracker_mod.init_tracker(
        config, intrinsics,
        associations[0].depth_timestamp, depth0,
        associations[0].color_timestamp, gray0,
        device=device,
    )
    if args.resume:
        try:
            trajectory, timestamps, keyframe_ids, kf_images, frames_done = ckpt_mod.load_slam(args.resume, trk)
        except (ckpt_mod.CheckpointMismatchError, OSError, KeyError, ValueError) as e:
            print(f"Cannot resume: {e}", file=sys.stderr)
            return 1
        # the fingerprint alone would accept a checkpoint of another
        # recording with the same camera: bind to the sequence through the
        # tracked timestamps
        if len(timestamps) != frames_done + 1 or not ckpt_mod.sequence_matches(timestamps, associations):
            print("Cannot resume: checkpoint was written for a different input sequence (tracked "
                  "timestamps do not match the associations file)", file=sys.stderr)
            return 1
        if kf_images is not None:
            for fid, (d, g) in kf_images.items():
                store.put(fid, d, g)
        elif store.mode == "memory":
            # an image-free checkpoint resumed with --kf-store memory: decode
            # the keyframes consumed so far again
            for fid in keyframe_ids:
                store.put(fid, *tum_rgbd.read_images(associations[fid]))
        print(f"resumed from {args.resume}: {frames_done} frames tracked, {len(keyframe_ids)} keyframes",
              file=sys.stderr)
    else:
        trajectory = [pose_mod.identity()]
        timestamps = [associations[0].depth_timestamp]
        keyframe_ids = [0]
        store.put(0, depth0, gray0)
        frames_done = 0

    sw = None
    if args.refine_window > 0:
        from ..models import sliding_window

        sw = sliding_window.SlidingWindow(config, intrinsics, window_size=max(2, args.refine_window),
                                          energy_tol=args.refine_energy_tol, device=device)
        if args.resume:
            # the window's state rides in a file beside the slam checkpoint
            try:
                ckpt_mod.load_sliding_window(args.resume + ".window", sw)
            except (ckpt_mod.CheckpointMismatchError, OSError, KeyError, ValueError) as e:
                print(f"Cannot resume window state ({args.resume}.window): {e}", file=sys.stderr)
                return 1
            if sw._next_id != frames_done + 1:
                print(f"Cannot resume: window checkpoint has consumed {sw._next_id} frames but the slam "
                      f"checkpoint tracked {frames_done}: the two files are out of sync", file=sys.stderr)
                return 1
        else:
            sw.start(depth0, gray0, trajectory[0])
        print(f"sliding-window refinement on: window {sw.window_size}, loop closure will see refined poses",
              file=sys.stderr)

    def save_all(done: int) -> None:
        ckpt_mod.save_slam(args.save_state, trk, trajectory, timestamps, keyframe_ids,
                           store.images_for_checkpoint(), done)
        if sw is not None:
            ckpt_mod.save_sliding_window(args.save_state + ".window", sw)
        print(f"checkpointed slam state to {args.save_state}", file=sys.stderr)

    todo = associations[1 + frames_done:]
    for idx, (assoc, (depth, gray)) in enumerate(zip(todo, tum_rgbd.frame_loader(todo)), start=1 + frames_done):
        before = trk.keyframe_switches
        trk.track(assoc.depth_timestamp, depth, assoc.color_timestamp, gray)
        print(f"Optical_flow: {trk.last_flow}", file=sys.stderr)
        ts, pose = trk.current_frame()
        trajectory.append(pose)
        timestamps.append(ts)
        if sw is not None:
            # every member of the window takes its jointly refined pose
            ids, refined = sw.add_frame(depth, gray, pose)
            for fid, p in zip(ids, refined):
                trajectory[fid] = p
        if trk.keyframe_switches > before:
            keyframe_ids.append(idx)
            store.put(idx, depth, gray)
        if args.save_state and (idx - frames_done) % max(1, args.save_every) == 0:
            save_all(idx)
    if args.save_state:
        # the final save: a run shorter than --save-every leaves one too
        save_all(len(associations) - 1)

    # --- 2. loop closure over the keyframes -------------------------------
    lc = loop_closure.LoopClosureConfig(
        radius=args.loop_radius,
        max_angle=args.loop_max_angle,
        min_gap=args.loop_min_gap,  # in frames: node_ids carries frame ids
        max_candidates=args.loop_max_candidates,
        energy_accept=args.loop_energy_accept,
    )
    kf_poses = [trajectory[i] for i in keyframe_ids]
    kf_depths = _LazyFrames(store, keyframe_ids, 0)
    kf_grays = _LazyFrames(store, keyframe_ids, 1)
    edges = loop_closure.detect_loops(config, intrinsics, kf_poses, kf_depths, kf_grays, lc,
                                      node_ids=keyframe_ids, device=device)
    print(f"{len(keyframe_ids)} keyframes, {len(edges)} verified loop edges", file=sys.stderr)
    for (i, j, _z, energy) in edges:
        print(f"loop edge: frames {keyframe_ids[i]} <-> {keyframe_ids[j]} (energy {energy:.1f})", file=sys.stderr)

    optimized = list(trajectory)
    if edges:
        # --- 3. pose graph over the keyframes, then every frame -----------
        nodes = Pose(torch.stack([p.q for p in kf_poses]).to(device), torch.stack([p.t for p in kf_poses]).to(device))
        graph = pose_graph.odometry_graph(nodes, loop_edges=edges)
        # small graphs: dense Cholesky; larger: PCG with the chain's
        # block-tridiagonal preconditioner
        if len(keyframe_ids) <= 64:
            result = pose_graph.solve(graph, max_iterations=30)
        else:
            result = pose_graph.solve_sparse(graph, max_iterations=30)
        opt_q, opt_t = result.nodes.q.cpu(), result.nodes.t.cpu()
        print(f"pose graph: energy {float(result.energy):.3e} after {int(result.nb_iter)} iterations",
              file=sys.stderr)
        # keyframe k's correction C_k = T_k_opt ∘ T_k_est⁻¹; the frames after
        # it take that correction
        corrections = {
            fid: pose_mod.compose(Pose(opt_q[n], opt_t[n]), pose_mod.inverse(trajectory[fid]))
            for n, fid in enumerate(keyframe_ids)
        }
        current = pose_mod.identity()
        for f in range(len(trajectory)):
            current = corrections.get(f, current)
            optimized[f] = pose_mod.compose(current, trajectory[f])

    for ts, pose in zip(timestamps[1:], optimized[1:]):
        print(tum_rgbd.Frame(timestamp=ts, pose=pose).to_string())

    if args.export_cloud:
        from ..utils import pointcloud

        pts, inten = pointcloud.keyframe_clouds(config, intrinsics, kf_depths, kf_grays,
                                                [optimized[i] for i in keyframe_ids], device=device)
        pts, inten = pointcloud.voxel_downsample(pts, inten, args.cloud_voxel)
        pointcloud.write_ply(args.export_cloud, pts, inten)
        print(f"exported {len(pts)} map points from {len(keyframe_ids)} keyframes to {args.export_cloud}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
