"""CLI: track many TUM RGB-D sequences at once, one lane per sequence.

    python -m visual_odometry_rs_tpu_torch.cli.vors_batch fr1 \\
        seqA/associations.txt seqB/associations.txt --out-dir trajs/

The port of ``visual_odometry_rs_tpu/cli/vors_batch.py``.  All sequences are
tracked together through ``parallel.batch.batched_track_sequence``, in clips
of ``--chunk`` frames; on a GPU each pyramid level of a frame is one solver
launch for all sequences, and each clip's poses come back in one device→host
read.  Each input gets its own TUM trajectory file in ``--out-dir``, named
after the association file's parent directory (else its stem), with ``.1``,
``.2``, ... added to a name already taken.  Sequences may differ in length:
a finished sequence keeps receiving its last frame and stops emitting lines.
Pending keyframe switches, the global frame index, the warm-start carry and,
with ``--relocalize K``, each lane's ring of K keyframes (on the device)
cross the clip boundaries.  The tracker's options take the JAX CLI's
defaults; ``--candidate-selector`` takes ``coarse_to_fine`` and
``dso_fixed`` (``dso`` needs a host recursion per keyframe).  It runs on CUDA unless ``--cpu`` is given, and
fails if CUDA is absent.  Images are decoded with PIL, one at a time.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import _common
from ._common import add_option_flags, option_fields

USAGE = "Usage: vors_batch [fr1|fr2|fr3|icl] associations_file... --out-dir DIR"

# flags of later slices, accepted only at their defaults: the ROADMAP item
# that ports each
_LATER = {"save_state": "A10", "resume": "A10"}


def _out_name(assoc_path: str) -> str:
    parent = os.path.basename(os.path.dirname(os.path.abspath(assoc_path)))
    if parent and parent not in (".", os.sep):
        return parent + ".txt"
    return os.path.splitext(os.path.basename(assoc_path))[0] + ".txt"


def _unique_names(paths):
    """Output names, made unique: two inputs that map to one name would
    otherwise overwrite each other's trajectory."""
    names, seen = [], {}
    for p in paths:
        name = _out_name(p)
        if name in seen:
            seen[name] += 1
            stem, ext = os.path.splitext(name)
            name = f"{stem}.{seen[name]}{ext}"
        else:
            seen[name] = 0
        names.append(name)
    return names


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(usage=USAGE)
    parser.add_argument("camera_id", choices=["fr1", "fr2", "fr3", "icl"])
    parser.add_argument("associations_files", nargs="+")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    parser.add_argument("--nb-levels", type=int, default=6)
    parser.add_argument("--diff-threshold", type=int, default=7)
    parser.add_argument("--candidate-cap", type=int, default=8192)
    parser.add_argument(
        "--switch-cadence", type=int, default=1, metavar="K",
        help="batch keyframe switches onto every K-th frame (pending lanes "
        "switch together); K=1 is the reference's per-frame switching",
    )
    parser.add_argument(
        "--switch-subbatch", type=int, default=0, metavar="K",
        help="accepted for the JAX CLI's interface and changes nothing: only "
        "the switching lanes are precomputed whatever it says",
    )
    parser.add_argument("--chunk", type=int, default=8, metavar="N",
                        help="frames per clip (one host read of poses per clip)")
    parser.add_argument(
        "--warm-start", choices=["constant_position", "constant_velocity"],
        default="constant_position",
        help="per-frame LM init: constant_position is the reference's "
        "(inverse_compositional.rs:177); constant_velocity extrapolates the "
        "previous inter-frame motion",
    )
    parser.add_argument(
        "--level-iterations", metavar="N0,N1,...", default=None,
        help="comma-separated per-level LM iteration caps (finest first, "
        "one per pyramid level); default: 20 at every level",
    )
    parser.add_argument("--max-frames", type=int, default=0, metavar="N",
                        help="stop after the first N frames per sequence (0 = all)")
    add_option_flags(parser, selectors=("coarse_to_fine", "dso_fixed"))
    # the flags of _LATER
    parser.add_argument("--save-state", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--resume", default=None, help=argparse.SUPPRESS)
    return parser


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    for name, item in _LATER.items():
        if getattr(args, name) != parser.get_default(name):
            flag = "--" + name.replace("_", "-")
            print(f"{flag} is not ported to the PyTorch package yet (ROADMAP {item})", file=sys.stderr)
            return 1
    if args.chunk < 1:
        print("--chunk must be >= 1", file=sys.stderr)
        return 1

    import numpy as np

    from ..dataset import tum_rgbd
    from ..math.pose import Pose
    from ..models import tracker as tracker_mod
    from ..parallel import batch as batch_mod
    from ..utils.types import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    level_iterations = _common.parse_level_iterations(args.level_iterations, args.nb_levels)
    try:
        all_assocs = [tum_rgbd.load_associations(p) for p in args.associations_files]
    except OSError as e:
        print(USAGE, file=sys.stderr)
        print(f"Cannot read associations: {e}", file=sys.stderr)
        return 1
    if any(not a for a in all_assocs):
        print("Empty associations file", file=sys.stderr)
        return 1

    first = [tum_rgbd.read_images(a[0]) for a in all_assocs]
    shapes = {g.shape for _, g in first}
    if len(shapes) != 1:
        print(f"All sequences must share one image shape, got {shapes}", file=sys.stderr)
        return 1
    h, w = next(iter(shapes))
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
        warm_start=args.warm_start,
        level_max_iterations=level_iterations,
        **option_fields(args),
    )
    nb_lanes = len(all_assocs)
    state = batch_mod.batched_init_state(
        config, intrinsics, np.stack([d for d, _ in first]), np.stack([g for _, g in first]),
        device=device,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    names = _unique_names(args.associations_files)
    loaders = [tum_rgbd.frame_loader(a[1:]) for a in all_assocs]
    lengths = [len(a) - 1 for a in all_assocs]
    max_len = max(lengths)
    if args.max_frames > 0:
        max_len = min(max_len, args.max_frames)
    last = list(first)  # (depth, gray) a finished lane keeps receiving

    ring = batch_mod.batched_init_ring(config, state) if config.relocalize_window > 0 else None
    frame_idx, pending, prev = 0, None, None
    outs = [open(os.path.join(args.out_dir, n), "w") for n in names]
    try:
        while frame_idx < max_len:
            n = min(args.chunk, max_len - frame_idx)
            clip_d = np.empty((n, nb_lanes, h, w), np.uint16)
            clip_g = np.empty((n, nb_lanes, h, w), np.uint8)
            for f in range(n):
                for b in range(nb_lanes):
                    if frame_idx + f < lengths[b]:
                        last[b] = next(loaders[b])
                    clip_d[f, b], clip_g[f, b] = last[b]
            state, (poses, diags), pending, prev, *rest = batch_mod.batched_track_sequence(
                config, intrinsics, state, clip_d, clip_g,
                switch_cadence=args.switch_cadence, switch_subbatch=args.switch_subbatch,
                pending0=pending, frame_offset=frame_idx, return_pending=True,
                reloc_ring=ring, prev_pose0=prev, return_prev=True,
            )
            if ring is not None:
                ring = rest[0]
            q, t, host = batch_mod.outputs_to_numpy(poses, diags)  # the clip's one read
            for f in range(n):
                for b in range(nb_lanes):
                    fi = frame_idx + f
                    if fi >= lengths[b]:
                        continue
                    print(f"[{b}] Optical_flow: {host.flow[f, b]}", file=sys.stderr)
                    if host.failed[f, b]:
                        print(f"[{b}] Error at Cholesky decomposition of hessian", file=sys.stderr)
                    if host.relocalized[f, b]:
                        print(f"[{b}] Relocalized against keyframe ring", file=sys.stderr)
                    line = tum_rgbd.Frame(
                        timestamp=all_assocs[b][fi + 1].depth_timestamp, pose=Pose(q=q[f, b], t=t[f, b])
                    ).to_string()
                    outs[b].write(line + "\n")
            frame_idx += n
    finally:
        for fh in outs:
            fh.close()
    print(f"wrote {nb_lanes} trajectories to {args.out_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
