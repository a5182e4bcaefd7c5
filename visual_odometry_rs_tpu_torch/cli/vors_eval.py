"""CLI: evaluate a TUM trajectory against ground truth (ATE and RPE).

    python -m visual_odometry_rs_tpu_torch.cli.vors_eval groundtruth.txt trajectory.txt

The port of ``visual_odometry_rs_tpu/cli/vors_eval.py`` (the in-repo analog
of ``mpizenberg/rgbd-tracking-evaluation``, reference README.md:18-19): the
absolute trajectory error after Umeyama alignment and the relative pose
error over ``--delta``-frame intervals, as one JSON line on stdout with the
JAX CLI's keys.  Timestamps are matched within ``--max-dt`` seconds, best
first (the TUM benchmark's ``associate.py`` rule), so the estimate need not
cover every ground-truth frame.  It runs on the CPU: the work is a few
thousand poses.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys

USAGE = "Usage: vors_eval groundtruth_file trajectory_file"


def associate(gt, est, max_dt: float):
    """Best-first timestamp matching: every (|dt|, gt, est) pair within
    ``max_dt``, sorted by |dt|, accepted when both frames are still free.
    Returns (gt index, est index) pairs in ground-truth order."""
    gt_ts = [g.timestamp for g in gt]
    candidates = []
    for i, f in enumerate(est):
        lo = bisect.bisect_left(gt_ts, f.timestamp - max_dt)
        hi = bisect.bisect_right(gt_ts, f.timestamp + max_dt)
        for j in range(lo, hi):
            dt = abs(f.timestamp - gt_ts[j])
            if dt <= max_dt:
                candidates.append((dt, j, i))
    candidates.sort()
    used_gt, used_est, pairs = set(), set(), []
    for _, j, i in candidates:
        if j not in used_gt and i not in used_est:
            used_gt.add(j)
            used_est.add(i)
            pairs.append((j, i))
    pairs.sort()
    return pairs


def evaluate(gt, est, pairs, delta: int = 1, with_scale: bool = False) -> dict:
    """The metrics of matched frames, unrounded: ``ate_rmse_m``, and the RPE
    (``None`` when ``delta`` leaves no pair)."""
    from ..eval import ate as ate_mod

    gt_m = [gt[j].pose for j, _ in pairs]
    est_m = [est[i].pose for _, i in pairs]
    rpe_t = rpe_r = None
    if delta < len(pairs):
        rpe_t, rpe_r = ate_mod.rpe_rmse(est_m, gt_m, delta=delta)
    return {
        "matched_frames": len(pairs),
        "ate_rmse_m": ate_mod.ate_rmse(est_m, gt_m, with_scale=with_scale),
        "rpe_trans_rmse_m": rpe_t,
        "rpe_rot_rmse_rad": rpe_r,
        "delta": delta,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(usage=USAGE)
    parser.add_argument("groundtruth_file")
    parser.add_argument("trajectory_file")
    parser.add_argument("--delta", type=int, default=1, help="RPE frame interval")
    parser.add_argument("--max-dt", type=float, default=0.02,
                        help="max timestamp difference for matching (s)")
    parser.add_argument("--scale", action="store_true",
                        help="also estimate a similarity scale in the alignment")
    args = parser.parse_args(argv)

    from ..dataset import tum_rgbd

    try:
        with open(args.groundtruth_file) as f:
            gt = tum_rgbd.parse_trajectory(f.read())
        with open(args.trajectory_file) as f:
            est = tum_rgbd.parse_trajectory(f.read())
    except OSError as e:
        print(USAGE, file=sys.stderr)
        print(f"Cannot read inputs: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"Malformed trajectory line: {e}", file=sys.stderr)
        return 1

    pairs = associate(gt, est, args.max_dt)
    if len(pairs) < 2:
        print(f"only {len(pairs)} matched frames (max_dt={args.max_dt})", file=sys.stderr)
        return 1
    result = evaluate(gt, est, pairs, args.delta, args.scale)
    # six decimals, and null for an RPE without pairs (NaN is not JSON)
    for key in ("ate_rmse_m", "rpe_trans_rmse_m", "rpe_rot_rmse_rad"):
        if result[key] is not None:
            result[key] = round(result[key], 6)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
