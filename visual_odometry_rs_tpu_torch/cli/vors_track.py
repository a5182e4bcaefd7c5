"""CLI: track a TUM RGB-D sequence and print the trajectory to stdout.

    python -m visual_odometry_rs_tpu_torch.cli.vors_track [fr1|fr2|fr3|icl] associations_file

The port of ``visual_odometry_rs_tpu/cli/vors_track.py`` (reference
``src/bin/vors_track.rs``): one TUM pose line per tracked frame
(``timestamp tx ty tz qx qy qz qw``) on stdout, diagnostics on stderr.
It runs on CUDA unless ``--cpu`` is given, and fails if CUDA is absent.
The tracker's options (``--robust-delta``, ``--brightness-model``,
``--candidate-selector``/``--dso-*``, ``--relocalize``) take the JAX CLI's
defaults and choices; on CUDA every one of them runs in the solver kernel.
Frames are decoded by the port's native PNG library, a few frames ahead on
threads (``dataset.tum_rgbd.frame_loader``), or by PIL where the library
cannot be built.

- ``--metrics``: a JSON line per frame (flow, switch, failure, the host time
  of the frame) and a session summary on stderr.
- ``--save-state PATH`` checkpoints the tracker at the end and ``--resume
  PATH`` restores it before tracking every association after the first of
  the file given (``utils.checkpoint``; a checkpoint of the JAX package's
  CLI resumes here and the other way round).
- ``--chunk N``: clips of N frames through ``parallel.batch.track_sequence``
  (one lane, the keyframe switch inside the clip, one host read per clip),
  with the warm-start carry across clips; the batched tracker keeps static
  candidate caps, so bucketing does not apply.  It refuses ``dso``,
  checkpoints and relocalization, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import sys

from ..utils import metrics as metrics_mod
from . import _common
from ._common import add_option_flags, option_fields

USAGE = "Usage: vors_track [fr1|fr2|fr3|icl] associations_file"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(usage=USAGE)
    parser.add_argument("camera_id", choices=["fr1", "fr2", "fr3", "icl"])
    parser.add_argument("associations_file")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    parser.add_argument("--nb-levels", type=int, default=6)
    parser.add_argument("--diff-threshold", type=int, default=7)
    parser.add_argument("--candidate-cap", type=int, default=8192)
    add_option_flags(parser, selectors=("coarse_to_fine", "dso", "dso_fixed"))
    parser.add_argument(
        "--warm-start", choices=["constant_position", "constant_velocity"],
        default="constant_position",
        help="per-frame LM init: constant_position is reference-exact "
        "(inverse_compositional.rs:177); constant_velocity extrapolates the "
        "previous inter-frame motion",
    )
    parser.add_argument(
        "--level-iterations", metavar="N0,N1,...", default=None,
        help="comma-separated per-level LM iteration caps (finest first, "
        "one per pyramid level); default: 20 at every level",
    )
    parser.add_argument(
        "--no-bucket", action="store_true",
        help="disable candidate-cap bucketing (exact worst-case shapes)",
    )
    parser.add_argument(
        "--metrics", action="store_true",
        help="print per-frame JSON metrics and a session summary to stderr",
    )
    parser.add_argument(
        "--chunk", type=int, default=0, metavar="N",
        help="track clips of N frames with the batched tracker (the keyframe switch inside the "
        "clip, one host read per clip); trajectory lines print once per clip",
    )
    parser.add_argument("--save-state", metavar="PATH", help="checkpoint the tracker state here at the end")
    parser.add_argument("--resume", metavar="PATH",
                        help="restore the tracker state from a checkpoint and track the frames after the "
                        "first association")
    args = parser.parse_args(argv)

    from ..dataset import tum_rgbd
    from ..models import tracker as tracker_mod
    from ..utils import checkpoint as checkpoint_mod
    from ..utils.types import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    try:
        associations = tum_rgbd.load_associations(args.associations_file)
    except OSError as e:
        print(USAGE, file=sys.stderr)
        print(f"The association file does not exist or is not reachable: {e}", file=sys.stderr)
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
        height=h,
        width=w,
        nb_levels=args.nb_levels,
        candidates_diff_threshold=args.diff_threshold,
        depth_scale=tum_rgbd.DEPTH_SCALE,
        idepth_variance=tum_rgbd.VARIANCE_TUM,
        candidate_cap=args.candidate_cap,
        bucket_candidates=not args.no_bucket,
        warm_start=args.warm_start,
        level_max_iterations=_common.parse_level_iterations(args.level_iterations, args.nb_levels),
        **option_fields(args),
    )
    if args.chunk > 0:
        refusal = _chunk_refusal(args)
        if refusal:
            print(refusal, file=sys.stderr)
            return 1
        return _run_chunked(args, config, intrinsics, associations, depth0, gray0, device)

    trk = tracker_mod.init_tracker(
        config, intrinsics,
        associations[0].depth_timestamp, depth0,
        associations[0].color_timestamp, gray0,
        device=device,
    )
    if args.resume:
        try:
            checkpoint_mod.load_tracker(args.resume, trk)
        except checkpoint_mod.CheckpointMismatchError as e:
            print(f"Cannot resume: {e}", file=sys.stderr)
            return 1
        except (OSError, KeyError, ValueError) as e:
            print(f"Cannot read checkpoint {args.resume}: {e}", file=sys.stderr)
            return 1
        # every association after the first is tracked: a file that starts
        # at or before the checkpoint's last frame tracks frames twice
        if len(associations) > 1 and associations[1].depth_timestamp <= trk.current_depth_timestamp + 1e-9:
            print(
                f"warning: the first frame to track ({associations[1].depth_timestamp:.6f}) is not after "
                f"the checkpoint's last tracked frame ({trk.current_depth_timestamp:.6f}): frames will be "
                "tracked twice; pass only the remaining associations when resuming",
                file=sys.stderr,
            )

    session = metrics_mod.SessionMetrics()
    relocalizations = trk.relocalizations
    frames = tum_rgbd.frame_loader(associations[1:])
    for idx, (assoc, (depth, gray)) in enumerate(zip(associations[1:], frames), start=1):
        switches = trk.keyframe_switches
        with metrics_mod.Timer() as timer:  # track() ends in its one device read
            trk.track(assoc.depth_timestamp, depth, assoc.color_timestamp, gray)
        print(f"Optical_flow: {trk.last_flow}", file=sys.stderr)
        if trk.last_failed:
            print("Error at Cholesky decomposition of hessian", file=sys.stderr)
        if trk.relocalizations > relocalizations:
            relocalizations = trk.relocalizations
            print(f"Relocalized against keyframe ring (energy {trk.last_energy:.1f})", file=sys.stderr)
        timestamp, pose = trk.current_frame()
        print(tum_rgbd.Frame(timestamp=timestamp, pose=pose).to_string(), flush=True)
        if args.metrics:
            _record(session, idx, timestamp, trk.last_flow, trk.keyframe_switches > switches,
                    trk.last_failed, timer.seconds)
    if args.metrics:
        session.print_summary()
    if args.save_state:
        checkpoint_mod.save_tracker(args.save_state, trk)
    return 0


def _record(session, idx, timestamp, flow, switched, failed, seconds) -> None:
    m = metrics_mod.FrameMetrics(
        frame_index=idx, timestamp=timestamp, optical_flow=float(flow),
        keyframe_switched=bool(switched), failed=bool(failed), track_seconds=seconds,
    )
    session.record(m)
    print(m.to_json(), file=sys.stderr)


def _chunk_refusal(args) -> str:
    """Why the clip mode cannot run with these flags (the JAX CLI's three
    refusals), or an empty string."""
    if args.candidate_selector == "dso":
        return ("--candidate-selector dso needs the host recursion on the block size per keyframe "
                "and is not supported with --chunk; run without --chunk")
    if args.resume or args.save_state:
        return ("--chunk keeps the tracker state in the batched tracker and does not support "
                "--resume/--save-state; run without --chunk to checkpoint")
    if args.relocalize > 0:
        return ("--relocalize is the streaming tracker's recovery (its host keyframe ring) and is "
                "not supported with --chunk; run without --chunk")
    return ""


def _run_chunked(args, config, intrinsics, associations, depth0, gray0, device) -> int:
    """Clips of ``args.chunk`` frames through ``parallel.batch.track_sequence``:
    the state stays on the device between clips, with the warm-start carry,
    and each clip's poses and diagnostics come back in one read."""
    import numpy as np

    from ..dataset import tum_rgbd
    from ..math.pose import Pose
    from ..parallel import batch as batch_mod

    session = metrics_mod.SessionMetrics()
    state = batch_mod.init_state(config, intrinsics, depth0, gray0, device=device)
    prev = state.current_pose  # zero velocity at the start
    frame_index = 0
    buf_d, buf_g, buf_assoc = [], [], []

    def flush():
        nonlocal state, prev, frame_index
        with metrics_mod.Timer() as timer:
            state, (poses, diags), prev = batch_mod.track_sequence(
                config, intrinsics, state, np.stack(buf_d), np.stack(buf_g), prev_pose0=prev, return_prev=True
            )
            q, t, host = batch_mod.outputs_to_numpy(poses, diags)  # the clip's one read
        for i, a in enumerate(buf_assoc):
            print(f"Optical_flow: {host.flow[i]}", file=sys.stderr)
            if host.failed[i]:
                print("Error at Cholesky decomposition of hessian", file=sys.stderr)
            print(tum_rgbd.Frame(timestamp=a.depth_timestamp, pose=Pose(q=q[i], t=t[i])).to_string())
            frame_index += 1
            if args.metrics:
                _record(session, frame_index, a.depth_timestamp, host.flow[i], host.switched[i],
                        host.failed[i], timer.seconds / len(buf_assoc))
        sys.stdout.flush()
        buf_d.clear()
        buf_g.clear()
        buf_assoc.clear()

    for assoc, (depth, gray) in zip(associations[1:], tum_rgbd.frame_loader(associations[1:])):
        buf_d.append(depth)
        buf_g.append(gray)
        buf_assoc.append(assoc)
        if len(buf_d) == args.chunk:
            flush()
    if buf_d:
        flush()
    if args.metrics:
        session.print_summary()
    return 0
