"""Masked bilinear sampling by direct indexing.

The port of ``bilinear_gather`` in ``visual_odometry_rs_tpu/ops/interp.py``
(lm_optimizer.rs:227-251).  With ``u = floor(x)``, ``v = floor(y)``, a point
is inside iff ``0 <= u < width-2`` and ``0 <= v < height-2`` (W-2, not W-1:
the reference's domain).  Outside points return 0 with mask False.  The JAX
package's one-hot matmul samplers are a TPU mechanism and are not ported.

``bilinear_grad`` also samples a stack of images, each at its own points
(the photometric window: one image a frame), and returns the partial
derivatives of the interpolant in x and y: what ``jax.jacfwd`` through
``bilinear_gather`` gives (zero through ``floor`` and the mask), not an
image gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.types import Float


def _corners(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """The mask, the four corner values and the fractions ``(a, b)`` of the
    points.  A 2-D ``img`` is sampled at points of any shape; an ``img``
    (…, H, W) with leading axes at points (…, N) of the same leading axes,
    each image at its own points."""
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
    if img.dim() > 2:
        lead = img.shape[:-2]
        base = torch.arange(flat.numel() // (height * width), device=img.device) * (height * width)
        i00 = i00 + base.reshape(*lead, 1)
    corners = (flat[i00], flat[i00 + width], flat[i00 + 1], flat[i00 + width + 1])
    return mask, corners, x - u, y - v


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample ``img`` (H, W) at column coords ``x`` and row coords
    ``y`` (or a stack (…, H, W), each image at its own points (…, N)).
    Returns ``(values, inside)``."""
    mask, (vu00, vu10, vu01, vu11), a, b = _corners(img, x, y)
    val = (1.0 - b) * (1.0 - a) * vu00 + b * (1.0 - a) * vu10 + (1.0 - b) * a * vu01 + b * a * vu11
    return torch.where(mask, val, torch.zeros_like(val)), mask


def bilinear_grad(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """``bilinear`` and the interpolant's partial derivatives: ``(values,
    inside, d/dx, d/dy)``, all zero outside.  ``img`` (…, H, W) is sampled
    at points (…, N) of the same leading axes (or, 2-D, at any points)."""
    mask, (vu00, vu10, vu01, vu11), a, b = _corners(img, x, y)
    val = (1.0 - b) * (1.0 - a) * vu00 + b * (1.0 - a) * vu10 + (1.0 - b) * a * vu01 + b * a * vu11
    dx = (1.0 - b) * (vu01 - vu00) + b * (vu11 - vu10)
    dy = (1.0 - a) * (vu10 - vu00) + a * (vu11 - vu01)
    zero = torch.zeros_like(val)
    return torch.where(mask, val, zero), mask, torch.where(mask, dx, zero), torch.where(mask, dy, zero)
