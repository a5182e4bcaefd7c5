"""Relocalization: the kidnapped-robot scenario.

The port of ``examples/relocalization.py``.  The reference tracker has no
recovery: a frame whose solve fails keeps its previous pose, and tracking
degrades from there (inverse_compositional.rs:195-199).  This program drives
the camera away from its start, teleports it back ("kidnap"), and compares
that behavior with ``TrackerConfig.relocalize_window`` = 4: the lost frame
is tracked again against the ring of recent keyframes in one lane-axis
solve, and the best verified match becomes the anchor.

    python -m visual_odometry_rs_tpu_torch.examples.relocalization [--cpu]
"""

from __future__ import annotations

import numpy as np

from ..dataset import synthetic, tum_rgbd
from ..models import tracker as tracker_mod
from ..utils.types import to_numpy
from ._common import device_of, parser

KIDNAP_AT = 5


def sequence():
    step = [0.03, 0.004, 0.002, 0.0, 0.02, 0.0]
    total = -4.0 * np.asarray(step)
    small = [0.008, 0.002, 0.001, 0.0, 0.004, 0.0]
    twists = np.asarray([step] * 4 + [list(total)] + [small, small], np.float32)
    return synthetic.generate_sequence(
        nb_frames=len(twists) + 1, height=120, width=160, seed=23, twist_per_frame=twists,
    )


def run(seq, window: int, device):
    """Track the sequence; returns the tracker and each frame's position error."""
    config = tracker_mod.TrackerConfig(
        height=120, width=160, nb_levels=3, candidate_cap=1024,
        depth_scale=tum_rgbd.DEPTH_SCALE, relocalize_window=window,
    )
    trk = tracker_mod.init_tracker(config, seq.intrinsics, 0.0, seq.depths[0], 0.0, seq.grays[0], device=device)
    errs = []
    for i in range(1, len(seq.grays)):
        trk.track(float(i), seq.depths[i], float(i), seq.grays[i])
        errs.append(float(np.linalg.norm(to_numpy(trk.current_pose.t) - to_numpy(seq.poses[i].t))))
    return trk, errs


def main(argv=None):
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = device_of(args)
    seq = sequence()
    trk_off, errs_off = run(seq, 0, device)
    trk_on, errs_on = run(seq, 4, device)

    print(f"frames: {len(seq.grays)}, kidnap at frame {KIDNAP_AT}")
    print(f"{'frame':>5} {'err (no recovery)':>18} {'err (relocalize=4)':>19}")
    for i, (a, b) in enumerate(zip(errs_off, errs_on), start=1):
        marker = "  <- kidnap" if i == KIDNAP_AT else ""
        print(f"{i:>5} {a:>18.4f} {b:>19.4f}{marker}")
    print(f"relocalizations fired: {trk_on.relocalizations}")
    assert trk_on.relocalizations >= 1
    assert errs_on[-1] < 0.05 < errs_off[-1]
    print(f"recovered: post-kidnap error {errs_off[-1] / max(errs_on[-1], 1e-9):.0f}x smaller with recovery")
    return errs_off, errs_on, trk_on.relocalizations


if __name__ == "__main__":
    main()
