"""Loop closure and pose-graph optimization on a synthetic loop trajectory.

The port of ``examples/slam_loop_closure.py``:

1. render an out-and-back camera path over the synthetic textured plane;
2. corrupt its ground truth with a systematic drift a frame;
3. propose loop candidates by pose proximity and verify them
   photometrically with the tracker's own solver (``models.loop_closure``,
   one lane-axis solve for all pairs);
4. optimize the pose graph (odometry chain + verified loop edges,
   ``parallel.pose_graph``) and print the ATE before and after.

    python -m visual_odometry_rs_tpu_torch.examples.slam_loop_closure [--cpu]

(The whole pipeline, tracking included, is ``cli.vors_slam``.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..dataset import synthetic
from ..eval import ate
from ..math import pose as pose_mod
from ..math import se3
from ..math.pose import Pose
from ..models import loop_closure
from ..models import tracker as tracker_mod
from ..parallel import pose_graph
from ._common import device_of, parser


def main(argv=None) -> float:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = device_of(args)
    # out-and-back: 7 frames out, 7 frames back; the end revisits the start
    out = [[0.04, 0.004, 0.002, 0.002, -0.001, 0.001]] * 7
    back = [[-0.04, -0.004, -0.002, -0.002, 0.001, -0.001]] * 7
    twists = np.asarray(out + back, np.float32)
    seq = synthetic.generate_sequence(
        nb_frames=len(twists) + 1, height=120, width=160, seed=41, twist_per_frame=twists,
    )
    config = tracker_mod.TrackerConfig(height=120, width=160, nb_levels=3, candidate_cap=1024)

    # a systematic odometry drift (the calibration or scale bias real VO
    # accumulates: what loop closure corrects)
    rng = np.random.default_rng(8)
    bias = np.asarray([0.004, -0.002, 0.001, 0.0008, 0.0005, -0.0004], np.float32)
    drift = [pose_mod.identity()]
    for _ in range(1, len(seq.poses)):
        step = se3.exp(torch.from_numpy((bias + rng.normal(size=6) * 0.001).astype(np.float32)))
        drift.append(pose_mod.compose(drift[-1], step))
    drifted = [pose_mod.compose(p, d) for p, d in zip(seq.poses, drift)]
    ate_before = ate.ate_rmse(drifted, seq.poses)

    lc = loop_closure.LoopClosureConfig(radius=0.25, min_gap=8, max_candidates=6)
    edges = loop_closure.detect_loops(config, seq.intrinsics, drifted, seq.depths, seq.grays, lc, device=device)
    print(f"verified loop edges: {[(i, j) for i, j, _, _ in edges]}")

    nodes = Pose(torch.stack([p.q for p in drifted]).to(device), torch.stack([p.t for p in drifted]).to(device))
    graph = pose_graph.odometry_graph(nodes, loop_edges=[(i, j, z) for i, j, z, _ in edges])
    result = pose_graph.solve(graph, max_iterations=30)
    optimized = [Pose(result.nodes.q[k], result.nodes.t[k]) for k in range(len(drifted))]
    ate_after = ate.ate_rmse(optimized, seq.poses)
    print(f"ATE before loop closure: {ate_before * 100:.2f} cm")
    print(f"ATE after  loop closure: {ate_after * 100:.2f} cm")
    ratio = ate_after / ate_before
    print(f"improvement: {1 / ratio:.1f}x")
    return ratio


if __name__ == "__main__":
    main()
