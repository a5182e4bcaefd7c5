"""Coarse-to-fine candidate selection.

The port of ``examples/candidates_coarse_to_fine.py`` (reference
``examples/candidates_coarse-to-fine.rs``): a 6-level mean pyramid, the
integer gradients' squared norms, threshold 7; prints the candidates of
each level and writes an overlay PNG a level into ``--out-dir``.

    python -m visual_odometry_rs_tpu_torch.examples.candidates_coarse_to_fine [--cpu] [image.png]
"""

from __future__ import annotations

import os

import numpy as np

from ..core.candidates import coarse_to_fine
from ..ops import gradient, pyramid
from ..utils import view
from ._common import device_of, image_or, parser, shown


def make_image() -> np.ndarray:
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (60, 80), np.uint8)
    return np.kron(base, np.ones((8, 8), np.uint8))


def main(argv=None):
    p = parser(__doc__.splitlines()[0])
    p.add_argument("image", nargs="?", help="an 8-bit PNG (default: a random blocky image)")
    p.add_argument("--out-dir", default="out", help="where the overlays go (default: ./out)")
    args = p.parse_args(argv)
    img = image_or(args.image, make_image, device_of(args))
    pyr = pyramid.mean_pyramid(6, img)
    grads = [gradient.centered(pyr[0])]
    grads.extend(gradient.gradients_xy(pyr))
    sqn = [gradient.squared_norm(gx, gy) for gx, gy in grads]
    masks = coarse_to_fine.select(7, sqn)

    os.makedirs(args.out_dir, exist_ok=True)
    counts = []
    # masks come coarse -> fine; reversed pairs them with levels 0 (finest) up
    for lvl, mask in enumerate(reversed(masks)):
        counts.append(int(mask.sum()))
        print(f"level {lvl}: {counts[-1]} candidates")
        view.save_png(os.path.join(args.out_dir, f"candidates_level_{lvl}.png"), view.candidates_on_image(pyr[lvl], mask))
    print(f"overlays saved to {shown(args.out_dir)}/")
    return counts


if __name__ == "__main__":
    main()
