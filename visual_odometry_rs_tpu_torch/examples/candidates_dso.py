"""DSO candidate selection toward 2000 points.

The port of ``examples/candidates_dso.py`` (reference
``examples/candidates_dso.rs``): the gradient norm as input, two recursions
of the block size left; prints the point count and writes an overlay PNG
into ``--out-dir``.

    python -m visual_odometry_rs_tpu_torch.examples.candidates_dso [--cpu] [image.png]
"""

from __future__ import annotations

import os

from ..core.candidates import dso
from ..ops import gradient
from ..utils import view
from ._common import device_of, image_or, parser, shown
from .candidates_coarse_to_fine import make_image


def main(argv=None):
    p = parser(__doc__.splitlines()[0])
    p.add_argument("image", nargs="?", help="an 8-bit PNG (default: a random blocky image)")
    p.add_argument("--out-dir", default="out", help="where the overlay goes (default: ./out)")
    args = p.parse_args(argv)
    img = image_or(args.image, make_image, device_of(args))
    mask = dso.select(
        gradient.norm_direct(img), 2000,
        recursive_config=dso.RecursiveConfig(nb_iterations_left=2, low_thresh=0.8, high_thresh=4.0, random_thresh=1.1),
    )
    count = int(mask.sum())
    print(f"Number of candidate points: {count}")
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "candidates_dso.png")
    view.save_png(path, view.candidates_on_image(img, mask))
    print(f"overlay saved to {shown(path)}")
    return count


if __name__ == "__main__":
    main()
