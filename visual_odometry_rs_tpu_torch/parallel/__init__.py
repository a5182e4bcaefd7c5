"""Scaling layer of the port.

- ``mesh``: device meshes, lanes split over local devices, and the process
  group of a mesh axis that spans ranks (``torch.distributed``).
- ``collectives``: the fixed-order cross-rank sum and the ring
  reduce-scatter, all-gather and all-reduce of the JAX package.
- ``batch``: batched multi-sequence tracking, the port of
  ``visual_odometry_rs_tpu/parallel/batch.py``: a lane per sequence, one
  ``lm_solve_level`` launch per pyramid level for all lanes, the lanes
  spread over a mesh's devices with ``mesh=``.
- ``sharded``: the LM solve of one level with its candidates sharded over
  ranks, each rank's evaluation the ``residual_reduce`` kernel.
- ``pose_graph``: pose-graph optimization (dense and PCG solves, the PCG
  solve with its edges sharded over ranks), the port of
  ``visual_odometry_rs_tpu/parallel/pose_graph.py``.
- ``ba``: the geometric window bundle adjustment with Schur reduction, with
  its points sharded over ranks, the port of
  ``visual_odometry_rs_tpu/parallel/ba.py``.
"""

from . import ba, batch, collectives, mesh, pose_graph, sharded  # noqa: F401
