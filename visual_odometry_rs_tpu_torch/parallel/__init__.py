"""Scaling layer of the port.

- ``batch``: batched multi-sequence tracking, the port of
  ``visual_odometry_rs_tpu/parallel/batch.py``: a lane per sequence, one
  ``lm_solve_level`` launch per pyramid level for all lanes.
- ``pose_graph``: pose-graph optimization (dense and PCG solves), the port
  of ``visual_odometry_rs_tpu/parallel/pose_graph.py``.
- ``ba``: the geometric window bundle adjustment with Schur reduction, the
  port of ``visual_odometry_rs_tpu/parallel/ba.py``.

Their sharded variants belong to the multi-GPU work (ROADMAP A12) and raise.
"""

from . import ba, batch, pose_graph  # noqa: F401
