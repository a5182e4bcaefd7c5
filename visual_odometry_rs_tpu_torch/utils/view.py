"""Debug views (reference ``src/misc/view.rs``).

The port of ``visual_odometry_rs_tpu/utils/view.py``, host numpy:

- ``candidates_on_image``: a candidate mask in red over a gray image
  (view.rs:16-27);
- ``idepth_image``: an inverse-depth map through viridis, Unknown black and
  Discarded red (view.rs:31-37, 76-90);
- ``save_png``: an (H, W, 3) u8 array as an RGB PNG.  The JAX package
  writes through PIL; the port writes with its own standard-library writer
  (``dataset.tum_rgbd.write_png``), since PIL may be absent.  The pixels
  are the same.

Tensors are accepted wherever arrays are (read to the host).
"""

from __future__ import annotations

import numpy as np

from ..core import inverse_depth as idepth_mod
from ..dataset.tum_rgbd import write_png
from . import colormap
from .types import to_numpy


def gray_to_rgb(img) -> np.ndarray:
    img = to_numpy(img).astype(np.uint8)
    return np.stack([img, img, img], axis=-1)


def candidates_on_image(img, mask) -> np.ndarray:
    """Red overlay of selected candidates on the gray image (view.rs:16-27)."""
    out = gray_to_rgb(img)
    out[to_numpy(mask).astype(bool)] = np.array([255, 0, 0], np.uint8)
    return out


def idepth_image(m: idepth_mod.InverseDepthMap) -> np.ndarray:
    """Inverse-depth map → RGB: viridis over the known range, Unknown black,
    Discarded red (view.rs:31-90)."""
    idepth = to_numpy(m.idepth).astype(np.float64)
    state = to_numpy(m.state)
    known = state == idepth_mod.WITH_VARIANCE
    if known.any():
        vmin = float(idepth[known].min())
        vmax = float(idepth[known].max())
    else:
        vmin, vmax = 0.0, 1.0
    rgb = colormap.viridis_float(idepth, vmin, vmax)
    rgb[~known] = 0
    rgb[state == idepth_mod.DISCARDED] = np.array([255, 0, 0], np.uint8)
    return rgb


def save_png(path: str, rgb) -> None:
    """Write an (H, W, 3) u8 array as an RGB PNG."""
    write_png(path, to_numpy(rgb).astype(np.uint8))
