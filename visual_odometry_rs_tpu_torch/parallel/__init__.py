"""Scaling layer of the port.

- ``batch``: batched multi-sequence tracking, the port of
  ``visual_odometry_rs_tpu/parallel/batch.py``: a lane per sequence, one
  ``lm_solve_level`` launch per pyramid level for all lanes.
- ``pose_graph``: pose-graph optimization (dense and PCG solves), the port
  of ``visual_odometry_rs_tpu/parallel/pose_graph.py``.
"""

from . import batch  # noqa: F401
