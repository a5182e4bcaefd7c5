"""The reference's example programs on the port, one module each.

The ports of the JAX package's ``examples/*.py`` (themselves the reference's
``examples/*.rs``): the same seeds and sizes, and the same printed lines.
Each module has ``main(argv=None)`` and runs with

    python -m visual_odometry_rs_tpu_torch.examples.<name> [--cpu] [...]

on the GPU unless ``--cpu`` is given (without a GPU it raises).  Nothing
runs at import time.

- ``optim_rosenbrock``, ``optim_regression_1d``: the LM harness of
  ``math.optimizer``;
- ``optim_affine2d``: pyramidal affine alignment (``models.affine2d``);
- ``candidates_coarse_to_fine``, ``candidates_dso``: the candidate
  selectors, with overlay PNGs;
- ``dataset_tum_read_associations``, ``dataset_tum_read_trajectory``: the
  TUM parsers;
- ``track_synthetic``, ``relocalization``, ``slam_loop_closure``,
  ``photometric_window``: the tracker, its recovery, loop closure with the
  pose graph, and the photometric window.
"""
