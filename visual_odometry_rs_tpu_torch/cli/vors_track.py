"""CLI: track a TUM RGB-D sequence and print the trajectory to stdout.

    python -m visual_odometry_rs_tpu_torch.cli.vors_track [fr1|fr2|fr3|icl] associations_file

The port of the streaming mode of ``visual_odometry_rs_tpu/cli/vors_track.py``
(reference ``src/bin/vors_track.rs``): one TUM pose line per tracked frame
(``timestamp tx ty tz qx qy qz qw``) on stdout, diagnostics on stderr.
It runs on CUDA unless ``--cpu`` is given, and fails if CUDA is absent.
The tracker's options (``--robust-delta``, ``--brightness-model``,
``--candidate-selector``/``--dso-*``, ``--relocalize``) take the JAX CLI's
defaults and choices; on CUDA every one of them runs in the solver kernel.
Image decoding goes through PIL.
"""

from __future__ import annotations

import argparse
import sys

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
    args = parser.parse_args(argv)

    from ..dataset import tum_rgbd
    from ..models import tracker as tracker_mod
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
    trk = tracker_mod.init_tracker(
        config, intrinsics,
        associations[0].depth_timestamp, depth0,
        associations[0].color_timestamp, gray0,
        device=device,
    )
    relocalizations = 0
    for assoc in associations[1:]:
        depth, gray = tum_rgbd.read_images(assoc)
        trk.track(assoc.depth_timestamp, depth, assoc.color_timestamp, gray)
        print(f"Optical_flow: {trk.last_flow}", file=sys.stderr)
        if trk.last_failed:
            print("Error at Cholesky decomposition of hessian", file=sys.stderr)
        if trk.relocalizations > relocalizations:
            relocalizations = trk.relocalizations
            print("Relocalized against keyframe ring", file=sys.stderr)
        timestamp, pose = trk.current_frame()
        print(tum_rgbd.Frame(timestamp=timestamp, pose=pose).to_string(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
