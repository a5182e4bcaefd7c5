"""visual_odometry_rs_tpu_torch — the PyTorch/CUDA port of visual_odometry_rs_tpu.

Direct RGB-D visual odometry: candidate points on a keyframe, aligned to each
new frame by a coarse-to-fine Levenberg-Marquardt solve over an se(3) warp.
The layout mirrors the JAX package, so each module has a counterpart there:

- ``utils``   : dtype policy and device resolution
- ``math``    : pose algebra, so3/se3, the LM optimizer harness
- ``ops``     : mean pyramid, gradients, bilinear sampling, and the fused LM
                evaluation (``ops.residual``: a CUDA kernel and its torch twin)
- ``core``    : camera model, inverse depth, coarse-to-fine candidates
- ``models``  : the streaming tracker
- ``dataset`` : TUM RGB-D parsing and IO, synthetic sequences
- ``eval``    : ATE
- ``cli``     : ``vors_track`` (streaming mode)

It imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
