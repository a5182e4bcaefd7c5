"""visual_odometry_rs_tpu_torch — the PyTorch/CUDA port of visual_odometry_rs_tpu.

Direct RGB-D visual odometry: candidate points on a keyframe, aligned to each
new frame by a coarse-to-fine Levenberg-Marquardt solve over an se(3) warp.
The layout mirrors the JAX package, so each module has a counterpart there:

- ``utils``   : dtype policy and device resolution, checkpoints, metrics,
                tracing and profiling, the point-cloud export
- ``math``    : pose algebra, so3/se3, the LM optimizer harness
- ``ops``     : mean pyramid, gradients, bilinear sampling, the fused LM
                evaluation (``ops.residual``) and the per-level LM solver
                (``ops.lm_solve``): CUDA kernels and their plain versions;
                ``ops.build`` compiles the native sources of ``csrc/``
- ``core``    : camera model, inverse depth, candidate selectors
- ``models``  : the streaming tracker, relocalization, loop closure
- ``parallel``: the batched multi-sequence tracker, the pose graph
- ``native``  : the PNG reader and prefetching frame loader (host C++)
- ``dataset`` : TUM RGB-D parsing and IO, synthetic sequences
- ``eval``    : ATE and RPE
- ``cli``     : ``vors_track``, ``vors_batch``, ``vors_eval``, ``vors_slam``

It imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
