"""CLI: offline windowed photometric refinement of a tracked trajectory.

    python -m visual_odometry_rs_tpu_torch.cli.vors_refine fr1 associations.txt \\
        trajectory.txt [--window 6] > refined.txt

The port of ``visual_odometry_rs_tpu/cli/vors_refine.py``: post-processes a
TUM trajectory of ``vors_track`` (one line per association after the first)
with the photometric window.

- ``--mode sliding`` (default): the keyframe-anchored sliding window
  (``models.sliding_window``), one frame at a time, departed frames
  marginalized into a pose prior, keyframes switched on the tracker's flow
  criterion.  ``--batch`` refines several (associations, trajectory) pairs
  in lockstep, one batched solve a step, one output file a pair; with
  several GPUs whose number divides the pair count, the solves' lanes are
  spread over them.
- ``--mode chunked``: disjoint ``--window``-frame chunks that overlap by one
  frame, one solve a chunk, no marginalization.

The refined trajectory goes to stdout in TUM format, diagnostics to stderr.
It runs on CUDA unless ``--cpu`` is given, and fails if CUDA is absent.
Every flag of the JAX CLI is here except ``--interp`` (the port indexes
directly) and ``--compilation-cache`` (JAX's).
"""

from __future__ import annotations

import argparse
import os
import sys

from . import _common

USAGE = "Usage: vors_refine [fr1|fr2|fr3|icl] associations_file trajectory_file"


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=USAGE)
    parser.add_argument("camera_id", choices=["fr1", "fr2", "fr3", "icl"])
    parser.add_argument("associations_file")
    parser.add_argument("trajectory_file")
    parser.add_argument("extra_pairs", nargs="*", metavar="ASSOC TRAJ",
                        help="--batch mode: further associations/trajectory file pairs (one pair a lane)")
    parser.add_argument("--batch", action="store_true",
                        help="refine all given (associations, trajectory) pairs in lockstep, one batched "
                        "marginalized-window solve a step (models.sliding_window.BatchedSlidingWindow); "
                        "needs --out-dir and writes one refined trajectory a pair")
    parser.add_argument("--out-dir", metavar="DIR",
                        help="--batch mode: directory of the refined trajectories (named after each "
                        "association file's parent directory)")
    parser.add_argument("--max-frames", type=int, default=0, metavar="N",
                        help="--batch mode: stop after the first N global frames (0 = all); with "
                        "--save-state/--resume a long run goes in restartable pieces")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    parser.add_argument("--window", type=int, default=6)
    parser.add_argument("--mode", choices=["sliding", "chunked"], default="sliding",
                        help="'sliding' (default): the keyframe-anchored window that advances one frame at "
                        "a time, marginalizing departed frames into a pose prior and switching keyframes on "
                        "the tracker's flow criterion; 'chunked': disjoint --window-frame chunks overlapping "
                        "by one frame, one solve a chunk")
    parser.add_argument("--no-marginalization", action="store_true",
                        help="sliding mode: drop departed frames instead of marginalizing them")
    parser.add_argument("--coarse-level", type=int, default=1,
                        help="sliding mode: pyramid level of the pose-only pre-solve that widens the "
                        "convergence basin (0 disables)")
    parser.add_argument("--nb-levels", type=int, default=6, help="pyramid depth for candidate selection")
    parser.add_argument("--candidate-cap", type=int, default=2048)
    parser.add_argument("--max-iterations", type=int, default=15)
    parser.add_argument("--robust-delta", type=float, default=0.0,
                        help="Huber robust weighting threshold in intensity units (0 = L2)")
    parser.add_argument("--brightness-model", action="store_true",
                        help="estimate a per-frame affine brightness (gain, bias) in each window")
    parser.add_argument("--idepth-prior-weight", type=float, default=1e4)
    parser.add_argument("--save-state", metavar="PATH",
                        help="sliding mode: checkpoint the window state to PATH every --save-every frames "
                        "(and at the end)")
    parser.add_argument("--save-every", type=int, default=50, metavar="N")
    parser.add_argument("--resume", metavar="PATH",
                        help="sliding mode: resume from a --save-state checkpoint (refuses on a "
                        "configuration or window mismatch); the frames it consumed are skipped")
    parser.add_argument("--export-cloud", metavar="PATH",
                        help="sliding mode: write the refined sparse map (each retiring keyframe's "
                        "candidates at their window-refined inverse depths, through the refined poses) as "
                        "an ASCII PLY file")
    parser.add_argument("--cloud-voxel", type=float, default=0.0, metavar="METERS",
                        help="voxel-grid downsample the exported cloud (one centroid a cube); 0 = every point")
    parser.add_argument("--energy-tol", type=float, default=1.0,
                        help="per-pair d_energy stop (intensity^2).  The default matches the reference "
                        "tracker's coarse stop: refinement corrects gross error but does not descend into "
                        "the ~0.2 px photometric bias floor of quantized images.  Lower it for noisy "
                        "sensors where the photometric signal dominates.")
    return parser


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.mode != "sliding" and (args.save_state or args.resume):
        # a chunked run taking --save-state would exit 0 without a checkpoint
        parser.error("--save-state/--resume require --mode sliding")
    if args.mode != "sliding" and args.export_cloud:
        parser.error("--export-cloud requires --mode sliding")
    if args.extra_pairs and not args.batch:
        parser.error("extra associations/trajectory pairs require --batch")
    if args.batch:
        if len(args.extra_pairs) % 2 != 0:
            parser.error("--batch needs an even number of extra positionals (ASSOC TRAJ pairs)")
        if not args.out_dir:
            parser.error("--batch requires --out-dir")
        if args.mode != "sliding":
            parser.error("--batch supports --mode sliding only")
        if args.export_cloud:
            parser.error("--export-cloud is not available in --batch mode (use per-sequence vors_refine "
                         "runs for map export)")

    from ..utils.types import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.batch:
        pairs = [(args.associations_file, args.trajectory_file)] + [
            (args.extra_pairs[i], args.extra_pairs[i + 1]) for i in range(0, len(args.extra_pairs), 2)
        ]
        return _run_batched(args, pairs, device)
    return _run_single(args, device)


def _inputs(assoc_path, traj_path):
    """(associations, camera-to-world per association) or an error text."""
    from ..dataset import tum_rgbd
    from ..math import pose as pose_mod

    try:
        associations = tum_rgbd.load_associations(assoc_path)
        with open(traj_path) as f:
            trajectory = tum_rgbd.parse_trajectory(f.read())
    except OSError as e:
        return None, None, f"Cannot read inputs: {e}"
    if not associations:
        return None, None, f"Empty associations file: {assoc_path}"
    # vors_track writes one line per association after the first; frame 0
    # is the identity
    if len(trajectory) != len(associations) - 1:
        return None, None, (f"{traj_path}: trajectory has {len(trajectory)} lines; expected "
                            f"{len(associations) - 1} (one per association after the first)")
    return associations, [pose_mod.identity()] + [f.pose for f in trajectory], None


def _config(args, h, w):
    from ..dataset import tum_rgbd
    from ..models import tracker as tracker_mod

    intrinsics = tum_rgbd.scaled_intrinsics(args.camera_id, h, w)
    if (h, w) != (tum_rgbd.NATIVE_HEIGHT, tum_rgbd.NATIVE_WIDTH):
        print(f"note: {args.camera_id} intrinsics rescaled to {w}x{h} inputs", file=sys.stderr)
    config = tracker_mod.TrackerConfig(
        height=h, width=w, nb_levels=args.nb_levels, candidate_cap=args.candidate_cap,
        depth_scale=tum_rgbd.DEPTH_SCALE,
    )
    return config, intrinsics


def _window_options(args) -> dict:
    return dict(
        window_size=max(2, args.window), marginalize=not args.no_marginalization,
        coarse_level=args.coarse_level, max_iterations=args.max_iterations,
        idepth_prior_weight=args.idepth_prior_weight, energy_tol=args.energy_tol,
        robust_delta=args.robust_delta, brightness=args.brightness_model,
    )


def _run_single(args, device) -> int:
    from ..dataset import tum_rgbd

    associations, c2w, error = _inputs(args.associations_file, args.trajectory_file)
    if error:
        if error.startswith("Cannot read"):
            print(USAGE, file=sys.stderr)
        print(error, file=sys.stderr)
        return 1
    depth0, gray0 = tum_rgbd.read_images(associations[0])
    config, intrinsics = _config(args, *gray0.shape)
    if args.mode == "sliding":
        return _run_sliding(args, device, associations, c2w, config, intrinsics)
    return _run_chunked(args, device, associations, c2w, config, intrinsics)


def _print_trajectory(associations, refined, c2w) -> None:
    from ..dataset import tum_rgbd

    for i, assoc in enumerate(associations[1:], start=1):
        pose = refined[i] if refined[i] is not None else c2w[i]
        print(tum_rgbd.Frame(timestamp=assoc.depth_timestamp, pose=pose).to_string())


def _run_sliding(args, device, associations, c2w, config, intrinsics) -> int:
    import numpy as np
    import torch

    from ..dataset import tum_rgbd
    from ..math.pose import Pose
    from ..models import sliding_window
    from ..utils import checkpoint as ckpt_mod

    sw = sliding_window.SlidingWindow(
        config, intrinsics, collect_clouds=bool(args.export_cloud), device=device, **_window_options(args),
    )
    refined = [None] * len(associations)

    def refined_extra():
        # the refined-so-far trajectory rides in the checkpoint, so that a
        # resume keeps the refinement of frames that already left the window;
        # the consumed frames' timestamps bind it to this input sequence
        q = np.stack([np.asarray(p.q) if p is not None else np.zeros(4, np.float32) for p in refined])
        t = np.stack([np.asarray(p.t) if p is not None else np.zeros(3, np.float32) for p in refined])
        extra = {
            "refined_q": q, "refined_t": t, "refined_mask": np.array([p is not None for p in refined]),
            "consumed_ts": np.array([a.depth_timestamp for a in associations[: sw._next_id]], np.float64),
        }
        if args.export_cloud:
            # the retired refined clouds ride along, so that a resumed export
            # still holds the keyframes before the checkpoint
            pts = [p for p, _ in sw.retired_clouds]
            ints = [i for _, i in sw.retired_clouds]
            extra["cloud_pts"] = np.concatenate(pts) if pts else np.zeros((0, 3), np.float32)
            extra["cloud_int"] = np.concatenate(ints) if ints else np.zeros((0,), np.uint8)
        return extra

    start_at = 1
    if args.resume:
        try:
            extra = ckpt_mod.load_sliding_window(args.resume, sw)
        except (ckpt_mod.CheckpointMismatchError, OSError, KeyError, ValueError) as e:
            print(f"Cannot resume: {e}", file=sys.stderr)
            return 1
        start_at = sw._next_id
        saved_ts = extra.get("consumed_ts")
        if saved_ts is not None and not ckpt_mod.sequence_matches(saved_ts, associations):
            print("Cannot resume: checkpoint was written for a different input sequence (consumed-frame "
                  "timestamps do not match the associations file)", file=sys.stderr)
            return 1
        print(f"resumed from {args.resume}: {start_at} frames already processed, "
              f"{sw.keyframe_switches} keyframe switches", file=sys.stderr)
        if "refined_mask" in extra:
            for fid in range(min(len(associations), len(extra["refined_mask"]))):
                if extra["refined_mask"][fid]:
                    refined[fid] = Pose(torch.from_numpy(np.array(extra["refined_q"][fid], np.float32)),
                                        torch.from_numpy(np.array(extra["refined_t"][fid], np.float32)))
        if args.export_cloud:
            if "cloud_pts" in extra:
                sw.retired_clouds.append((np.asarray(extra["cloud_pts"], np.float32),
                                          np.asarray(extra["cloud_int"], np.uint8)))
            elif sw.keyframe_switches > 0:
                print("warning: checkpoint was saved without --export-cloud; the exported map will only "
                      "cover keyframes from this resumed run", file=sys.stderr)
        # the consumed frames are skipped without decoding them
        loader = iter(tum_rgbd.frame_loader(associations[start_at:]))
    else:
        loader = iter(tum_rgbd.frame_loader(associations))
        depth0, gray0 = next(loader)
        sw.start(depth0, gray0, c2w[0])
        refined[0] = c2w[0]
    for i, (depth_i, gray_i) in enumerate(loader, start=start_at):
        ids, poses = sw.add_frame(depth_i, gray_i, c2w[i])
        for fid, p in zip(ids, poses):
            refined[fid] = p  # the latest estimate wins (windows overlap)
        print(f"frame {i}: window {ids[0]}..{ids[-1]}, keyframe switches {sw.keyframe_switches}", file=sys.stderr)
        if args.save_state and ((i - start_at + 1) % max(1, args.save_every) == 0 or i == len(associations) - 1):
            ckpt_mod.save_sliding_window(args.save_state, sw, refined_extra())
            print(f"checkpointed window state to {args.save_state}", file=sys.stderr)
    _print_trajectory(associations, refined, c2w)
    if args.export_cloud:
        from ..utils import pointcloud

        clouds = list(sw.retired_clouds) + [sw.keyframe_cloud()]
        pts = np.concatenate([p for p, _ in clouds])
        inten = np.concatenate([i for _, i in clouds])
        pts, inten = pointcloud.voxel_downsample(pts, inten, args.cloud_voxel)
        pointcloud.write_ply(args.export_cloud, pts, inten)
        print(f"exported {len(pts)} refined map points to {args.export_cloud}", file=sys.stderr)
    return 0


def _run_chunked(args, device, associations, c2w, config, intrinsics) -> int:
    import numpy as np
    import torch

    from ..dataset import tum_rgbd
    from ..math import pose as pose_mod
    from ..math.pose import Pose
    from ..models import photometric_ba
    from ..models import tracker as tracker_mod
    from ..ops import pyramid as pyramid_ops
    from ..utils.types import depth_tensor, image_tensor

    intrinsics_dev = intrinsics.to(device)
    # a rolling buffer: only the live window's frames are resident
    loader = iter(tum_rgbd.frame_loader(associations))
    W = max(2, args.window)
    refined: list = [None] * len(associations)
    refined[0] = c2w[0]

    def refill(buf):
        while len(buf) < W:
            nxt = next(loader, None)
            if nxt is None:
                break
            buf.append(nxt)
        return buf

    buf = refill([])
    k0 = 0
    while len(buf) >= 2:
        k_end = k0 + len(buf)
        idxs = list(range(k0, k_end))
        depth_kf, gray_kf = buf[0]
        pyr = pyramid_ops.mean_pyramid(config.nb_levels, image_tensor(gray_kf, device))
        kf = tracker_mod.precompute_keyframe(config, intrinsics_dev, depth_tensor(depth_kf, device), pyr)
        images = torch.from_numpy(np.stack([g for _, g in buf]).astype(np.float32)).to(device)
        kf_pose = refined[k0] if refined[k0] is not None else c2w[k0]
        rel = [pose_mod.compose(pose_mod.inverse(c2w[i]), c2w[k0]) for i in idxs]
        init = Pose(torch.stack([p.q for p in rel]).to(device), torch.stack([p.t for p in rel]).to(device))
        win = photometric_ba.window_from_tracking(config, intrinsics_dev, kf.levels, images, init)
        result = photometric_ba.solve_window(
            win, max_iterations=args.max_iterations, idepth_prior_weight=args.idepth_prior_weight,
            energy_tol=args.energy_tol, robust_delta=args.robust_delta, brightness=args.brightness_model,
        )
        host = torch.cat([result.poses.q, result.poses.t, result.energy.reshape(1, 1).expand(len(idxs), 1),
                          result.nb_iter.to(result.energy.dtype).reshape(1, 1).expand(len(idxs), 1)], dim=1).cpu()
        print(f"window {k0}..{k_end - 1}: {int(host[0, 8])} iterations, energy {float(host[0, 7]):.1f}",
              file=sys.stderr)
        for j, i in enumerate(idxs):
            # cam_i = kf_pose ∘ model_i⁻¹, anchored at the refined keyframe
            refined[i] = pose_mod.compose(kf_pose, pose_mod.inverse(Pose(host[j, :4], host[j, 4:7])))
        # slide: the last frame of this window is the next one's keyframe
        k0 = k_end - 1
        buf = refill([buf[-1]])
        if len(buf) < 2:
            break
    _print_trajectory(associations, refined, c2w)
    return 0


def _run_batched(args, pairs, device) -> int:
    """B (associations, trajectory) pairs in lockstep: one
    ``BatchedSlidingWindow.add_frame`` a global frame, each one batched
    coarse and full solve for all lanes.  A lane that has ended keeps
    receiving its last frame (flow about 0, prior intact) and writes no
    more lines, as in ``vors_batch``."""
    import numpy as np
    import torch

    from ..dataset import tum_rgbd
    from ..math.pose import Pose
    from ..models import sliding_window
    from ..utils import checkpoint as ckpt_mod
    from .vors_batch import _unique_names

    B = len(pairs)
    all_assocs, all_c2w = [], []
    for ap, tp in pairs:
        assocs, c2w, error = _inputs(ap, tp)
        if error:
            print(error, file=sys.stderr)
            return 1
        all_assocs.append(assocs)
        all_c2w.append(c2w)
    first = [tum_rgbd.read_images(a[0]) for a in all_assocs]
    shapes = {g.shape for _, g in first}
    if len(shapes) != 1:
        print(f"All lanes must share one image shape, got {shapes}", file=sys.stderr)
        return 1
    config, intrinsics = _config(args, *next(iter(shapes)))
    mesh = _common.lane_mesh(B, device, "sharding {lanes} lanes over {devices} devices")
    bsw = sliding_window.BatchedSlidingWindow(config, intrinsics, device=device, mesh=mesh,
                                              **_window_options(args))

    lengths = [len(a) - 1 for a in all_assocs]
    max_len = max(lengths)
    stop_at = min(max_len, args.max_frames) if args.max_frames > 0 else max_len
    T = max_len + 1
    refined = [[None] * (lengths[b] + 1) for b in range(B)]
    loaders = [iter(tum_rgbd.frame_loader(a)) for a in all_assocs]
    last = [None] * B

    def extra():
        q = np.zeros((B, T, 4), np.float32)
        t = np.zeros((B, T, 3), np.float32)
        mask = np.zeros((B, T), bool)
        ts = np.full((B, T), np.nan, np.float64)
        for b in range(B):
            for fid, p in enumerate(refined[b]):
                if p is not None:
                    q[b, fid], t[b, fid], mask[b, fid] = np.asarray(p.q), np.asarray(p.t), True
            k = min(bsw._next_id, lengths[b] + 1)
            ts[b, :k] = [a.depth_timestamp for a in all_assocs[b][:k]]
        return {"refined_q": q, "refined_t": t, "refined_mask": mask, "consumed_ts": ts}

    start_at = 1
    if args.resume:
        try:
            saved = ckpt_mod.load_batched_window(args.resume, bsw)
        except (ckpt_mod.CheckpointMismatchError, OSError, KeyError, ValueError) as e:
            print(f"Cannot resume: {e}", file=sys.stderr)
            return 1
        start_at = bsw._next_id
        saved_ts = saved.get("consumed_ts")
        if saved_ts is not None:
            if saved_ts.shape[0] != B:
                print(f"Cannot resume: checkpoint has {saved_ts.shape[0]} lanes, {B} pairs given", file=sys.stderr)
                return 1
            for b in range(B):
                if not ckpt_mod.sequence_matches(saved_ts[b][~np.isnan(saved_ts[b])], all_assocs[b]):
                    print(f"Cannot resume: lane {b} ({pairs[b][0]}) does not match the checkpoint's consumed "
                          "frames: resume with the same pairs in the same order", file=sys.stderr)
                    return 1
        if "refined_mask" in saved:
            for b in range(B):
                for fid in range(min(T, saved["refined_mask"].shape[1])):
                    if fid <= lengths[b] and saved["refined_mask"][b, fid]:
                        refined[b][fid] = Pose(torch.from_numpy(np.array(saved["refined_q"][b, fid], np.float32)),
                                               torch.from_numpy(np.array(saved["refined_t"][b, fid], np.float32)))
        for b in range(B):
            for _ in range(min(start_at, lengths[b] + 1)):
                last[b] = next(loaders[b])
        print(f"resumed {B} lanes at global frame {start_at}", file=sys.stderr)
    else:
        for b in range(B):
            last[b] = next(loaders[b])  # frame 0
        c2w0 = Pose(torch.stack([c[0].q for c in all_c2w]), torch.stack([c[0].t for c in all_c2w]))
        bsw.start(np.stack([d for d, _ in last]), np.stack([g for _, g in last]), c2w0)
        for b in range(B):
            refined[b][0] = all_c2w[b][0]

    for i in range(start_at, stop_at + 1):
        for b in range(B):
            if i <= lengths[b]:
                last[b] = next(loaders[b])
        inits = [all_c2w[b][min(i, lengths[b])] for b in range(B)]
        c2w_i = Pose(torch.stack([p.q for p in inits]), torch.stack([p.t for p in inits]))
        ids, poses = bsw.add_frame(np.stack([d for d, _ in last]), np.stack([g for _, g in last]), c2w_i)
        for b in range(B):
            for slot in range(ids.shape[0]):
                fid = int(ids[slot, b])
                if fid <= lengths[b]:
                    refined[b][fid] = Pose(poses.q[b, slot], poses.t[b, slot])
        print(f"frame {i}: window {int(ids[:, 0].min())}..{int(ids[:, 0].max())}, keyframe switches "
              f"{list(map(int, bsw.keyframe_switches))}", file=sys.stderr)
        if args.save_state and ((i - start_at + 1) % max(1, args.save_every) == 0 or i == stop_at):
            ckpt_mod.save_batched_window(args.save_state, bsw, extra())
            print(f"checkpointed batched window state to {args.save_state}", file=sys.stderr)

    os.makedirs(args.out_dir, exist_ok=True)
    for b, name in enumerate(_unique_names([ap for ap, _ in pairs])):
        with open(os.path.join(args.out_dir, name), "w") as fh:
            for fid, assoc in enumerate(all_assocs[b][1:], start=1):
                pose = refined[b][fid] if refined[b][fid] is not None else all_c2w[b][fid]
                fh.write(tum_rgbd.Frame(timestamp=assoc.depth_timestamp, pose=pose).to_string() + "\n")
    print(f"wrote {B} refined trajectories to {args.out_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
