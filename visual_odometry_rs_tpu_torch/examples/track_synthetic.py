"""End-to-end tracking of a synthetic RGB-D sequence, with its ATE.

The port of ``examples/track_synthetic.py``: renders a sequence whose ground
truth is exact (8 frames at 320x240), tracks it with 5 levels and 4096
candidates, prints the TUM trajectory on stdout and the ATE and the
session's metrics on stderr.

    python -m visual_odometry_rs_tpu_torch.examples.track_synthetic [--cpu]
"""

from __future__ import annotations

import sys

from ..dataset import synthetic, tum_rgbd
from ..eval import ate
from ..math import pose as pose_mod
from ..models import tracker as tracker_mod
from ..utils import metrics
from ._common import device_of, parser


def main(argv=None):
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = device_of(args)
    seq = synthetic.generate_sequence(nb_frames=8, height=240, width=320, seed=0)
    config = tracker_mod.TrackerConfig(height=240, width=320, nb_levels=5, candidate_cap=4096)
    trk = tracker_mod.init_tracker(
        config, seq.intrinsics, float(seq.timestamps[0]), seq.depths[0], float(seq.timestamps[0]), seq.grays[0],
        device=device,
    )
    session = metrics.SessionMetrics()
    estimated = [pose_mod.identity()]
    for f in range(1, len(seq.grays)):
        with metrics.Timer() as t:
            trk.track(float(seq.timestamps[f]), seq.depths[f], float(seq.timestamps[f]), seq.grays[f])
        ts, pose = trk.current_frame()
        estimated.append(pose)
        print(tum_rgbd.Frame(timestamp=ts, pose=pose).to_string())
        session.record(metrics.FrameMetrics(
            frame_index=f, timestamp=ts, optical_flow=trk.last_flow,
            keyframe_switched=False, failed=trk.last_failed, track_seconds=t.seconds,
        ))
    err = ate.ate_rmse(estimated, seq.poses)
    print(f"ATE RMSE: {err * 1000:.3f} mm over {len(estimated)} frames", file=sys.stderr)
    session.print_summary()
    return err


if __name__ == "__main__":
    main()
