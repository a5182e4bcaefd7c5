"""Pyramidal inverse-compositional affine alignment.

The port of ``examples/optim_affine2d.py`` (reference
``examples/optim_affine-2d.rs``): extract a random affine template from an
image (seeded, where the reference uses ``thread_rng``), align it back, and
print the ground truth and the computed warp.  Without an image a synthetic
smooth 320x240 image is used.

    python -m visual_odometry_rs_tpu_torch.examples.optim_affine2d [--cpu] [image.png]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..models import affine2d
from ..utils.types import to_numpy
from ._common import device_of, parser


def make_image() -> np.ndarray:
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:240, 0:320].astype(np.float64)
    img = np.zeros((240, 320))
    for _ in range(8):
        fx, fy = rng.uniform(0.5, 3.0, 2)
        img += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * (fx * xx / 320 + fy * yy / 240) + rng.uniform(0, 6.28))
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def main(argv=None):
    p = parser(__doc__.splitlines()[0])
    p.add_argument("image", nargs="?", help="an 8-bit PNG (default: a synthetic image)")
    args = p.parse_args(argv)
    device = device_of(args)
    if args.image:
        from ..dataset.tum_rgbd import read_gray

        img = read_gray(args.image)
    else:
        img = make_image()
    template, affine_gt = affine2d.random_template(img, seed=0)
    nb_levels = affine2d.default_nb_levels(*img.shape)
    print(f"nb_levels = {nb_levels}")
    params, failed = affine2d.align(torch.from_numpy(template).to(device), torch.from_numpy(img).to(device), nb_levels)
    computed = to_numpy(affine2d.warp_matrix(params))[:2, :]
    print("Ground truth:")
    print(affine_gt)
    print("Computed:")
    print(computed)
    if failed:
        print("warning: a level failed its Cholesky step", file=sys.stderr)
    return affine_gt, computed, failed


if __name__ == "__main__":
    main()
