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
``dso_fixed`` (``dso`` needs a host recursion per keyframe).  It runs on
CUDA unless ``--cpu`` is given, and fails if CUDA is absent.  Each sequence
is decoded by its own ``dataset.tum_rgbd.frame_loader`` (the port's native
PNG library on threads, or PIL where it cannot be built).

``--save-state PATH`` checkpoints the whole batched state after every clip
(``utils.checkpoint.save_batch``: the keyframes and poses of every lane, the
pending switches, the global frame index, the warm-start carry and the
ring); ``--resume PATH`` continues a run on the same association files in
the same order: the consumed frames are skipped, the trajectory files are
appended to (cut back first to the checkpoint's frames), and a checkpoint of
another configuration, cadence, lane count or sequence is refused.  A
checkpoint of the JAX package's CLI resumes here and the other way round.
``--max-frames`` cuts a run into such pieces.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import _common
from ._common import add_option_flags, option_fields

USAGE = "Usage: vors_batch [fr1|fr2|fr3|icl] associations_file... --out-dir DIR"

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
                        help="stop after the first N frames per sequence (0 = all); with "
                        "--save-state/--resume a long run goes in restartable pieces")
    add_option_flags(parser, selectors=("coarse_to_fine", "dso_fixed"))
    parser.add_argument(
        "--save-state", metavar="PATH",
        help="checkpoint the batched state (keyframes, poses, pending switches, frame index, "
        "warm-start carry, ring) to PATH after every clip; resume with --resume on the same "
        "association files",
    )
    parser.add_argument(
        "--resume", metavar="PATH",
        help="continue from a --save-state checkpoint: consumed frames are skipped, trajectory "
        "files are appended to, and a checkpoint of another configuration, cadence or sequence "
        "is refused",
    )
    return parser


def _resume(args, all_assocs, names, lengths, state, ring, config, intrinsics):
    """Loads ``args.resume`` for the live batch.  Returns ``(state, pending,
    ring, frame_idx, prev)`` or an error message."""
    from ..utils import checkpoint as checkpoint_mod

    try:
        state, pending, ring, frame_idx, lane_ts, prev = checkpoint_mod.load_batch(
            args.resume, state, ring, config, intrinsics, args.switch_cadence
        )
    except checkpoint_mod.CheckpointMismatchError as e:
        return f"Cannot resume: {e}"
    except (OSError, KeyError, ValueError) as e:
        return f"Cannot read checkpoint {args.resume}: {e}"
    if len(lane_ts) != len(all_assocs):
        return f"Cannot resume: checkpoint has {len(lane_ts)} lanes, {len(all_assocs)} association files given"
    for b, ts in enumerate(lane_ts):
        if not checkpoint_mod.sequence_matches(ts, all_assocs[b]):
            return (f"Cannot resume: lane {b} ({args.associations_files[b]}) does not match the "
                    "checkpoint's consumed frames; resume with the same association files in the same order")
    # cut each trajectory file back to the checkpoint's frames: a crash
    # between a clip's lines and its checkpoint leaves lines past it
    for b, name in enumerate(names):
        path = os.path.join(args.out_dir, name)
        k = min(frame_idx, lengths[b])
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            lines = fh.readlines()
        if len(lines) > k:
            print(f"[{b}] trimmed output lines past the checkpoint in {path}", file=sys.stderr)
            kept = lines[:k]
        elif len(lines) == k and lines and not lines[-1].endswith("\n"):
            print(f"[{b}] dropped a truncated final line in {path}", file=sys.stderr)
            kept = lines[:-1]  # a line cut short by a crash: that frame's line is lost
        else:
            if len(lines) < k:
                print(f"[{b}] warning: {path} has {len(lines)} lines but the checkpoint consumed {k} "
                      "frames; earlier output is missing (another --out-dir?)", file=sys.stderr)
            continue
        with open(path, "w") as fh:
            fh.writelines(kept)
    print(f"resumed {len(all_assocs)} lanes at global frame {frame_idx}", file=sys.stderr)
    return state, pending, ring, frame_idx, prev


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.chunk < 1:
        print("--chunk must be >= 1", file=sys.stderr)
        return 1

    import numpy as np
    import torch

    from ..dataset import tum_rgbd
    from ..math.pose import Pose
    from ..models import tracker as tracker_mod
    from ..parallel import batch as batch_mod
    from ..utils import checkpoint as checkpoint_mod
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
    vel_on = config.warm_start == "constant_velocity"
    frame_idx = 0
    pending = torch.zeros(nb_lanes, dtype=torch.bool, device=device)
    prev = state.current_pose  # zero velocity at the start
    out_mode = "w"
    if args.resume:
        resumed = _resume(args, all_assocs, names, lengths, state, ring, config, intrinsics)
        if isinstance(resumed, str):
            print(resumed, file=sys.stderr)
            return 1
        state, pending, ring, frame_idx, prev_r = resumed
        if prev_r is not None:
            prev = prev_r
        # skip the consumed frames, keeping each lane's last one
        for b in range(nb_lanes):
            for _ in range(min(frame_idx, lengths[b])):
                last[b] = next(loaders[b])
        out_mode = "a"

    outs = [open(os.path.join(args.out_dir, n), out_mode) for n in names]
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
            if args.save_state:
                for fh in outs:
                    fh.flush()
                lane_ts = [[a.depth_timestamp for a in all_assocs[b][: min(frame_idx, lengths[b]) + 1]]
                           for b in range(nb_lanes)]
                checkpoint_mod.save_batch(
                    args.save_state, state, pending, ring, frame_idx, config, intrinsics,
                    args.switch_cadence, lane_ts, prev_pose=prev if vel_on else None,
                )
    finally:
        for fh in outs:
            fh.close()
    print(f"wrote {nb_lanes} trajectories to {args.out_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
