"""Masked bilinear sampling by direct indexing.

The port of ``bilinear_gather`` in ``visual_odometry_rs_tpu/ops/interp.py``
(lm_optimizer.rs:227-251).  With ``u = floor(x)``, ``v = floor(y)``, a point
is inside iff ``0 <= u < width-2`` and ``0 <= v < height-2`` (W-2, not W-1:
the reference's domain).  Outside points return 0 with mask False.  The JAX
package's one-hot matmul samplers are a TPU mechanism and are not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.types import Float


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample ``img`` (H, W) at column coords ``x`` and row coords
    ``y``.  Returns ``(values, inside)``."""
    height, width = img.shape[-2:]
    u = torch.floor(x)
    v = torch.floor(y)
    mask = (u >= 0.0) & (u < width - 2) & (v >= 0.0) & (v < height - 2)
    # outside points (NaN and inf included) read pixel (0, 0); masked below
    zero = torch.zeros_like(u)
    u0 = torch.where(mask, u, zero).to(torch.int64)
    v0 = torch.where(mask, v, zero).to(torch.int64)
    flat = img.reshape(-1).to(Float)
    i00 = v0 * width + u0
    vu00 = flat[i00]
    vu10 = flat[i00 + width]
    vu01 = flat[i00 + 1]
    vu11 = flat[i00 + width + 1]
    a = x - u
    b = y - v
    val = (1.0 - b) * (1.0 - a) * vu00 + b * (1.0 - a) * vu10 + (1.0 - b) * a * vu01 + b * a * vu11
    return torch.where(mask, val, zero), mask
