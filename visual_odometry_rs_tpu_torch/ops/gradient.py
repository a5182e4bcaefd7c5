"""Image gradients on f32 carriers, the tracker's path, and the DSO
selector's gradient norm.

The port of the f32 functions of ``visual_odometry_rs_tpu/ops/gradient.py``
(``centered_f32``, ``gradients_xy_f32``, ``squared_norm_f32``).  Every value
is an integer below 2^24, so f32 is exact.  Rust's integer division
truncates toward zero, hence ``rounding_mode="trunc"`` and never floor.
``squared_norm_direct`` and ``norm_direct`` keep the reference's integer
arithmetic (gradient.rs:49-65) on int32 tensors: torch's uint16 is partial,
and every value here is below 2^16 anyway.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..utils.types import Float
from .pyramid import block_2x2


def _half_trunc(x: torch.Tensor) -> torch.Tensor:
    """Rust ``/2`` of an integer-valued f32 tensor."""
    return torch.div(x, 2.0, rounding_mode="trunc")


def centered_f32(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centered gradients ``(I(i,j+1)-I(i,j-1))/2``, ``(I(i+1,j)-I(i-1,j))/2``,
    zero on the 1-pixel border (gradient.rs:15-33)."""
    im = img.to(Float)
    h, w = img.shape[-2:]
    gx = torch.zeros(img.shape, dtype=Float, device=img.device)
    gy = torch.zeros(img.shape, dtype=Float, device=img.device)
    gx[..., 1 : h - 1, 1 : w - 1] = _half_trunc(im[..., 1 : h - 1, 2:w] - im[..., 1 : h - 1, 0 : w - 2])
    gy[..., 1 : h - 1, 1 : w - 1] = _half_trunc(im[..., 2:h, 1 : w - 1] - im[..., 0 : h - 2, 1 : w - 1])
    return gx, gy


def gradients_xy_f32(img_pyramid: List[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """2x2-block (gx, gy) at levels 1..n-1 from the image one level finer
    (gradient.rs:74-93, multires.rs:96-126)."""
    out = []
    for img in img_pyramid[:-1]:
        a, b, c, d = (x.to(Float) for x in block_2x2(img))
        out.append((_half_trunc(c + d - a - b), _half_trunc(b - a + d - c)))
    return out


def squared_norm_f32(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """``gx² + gy²``; below 2^16 for these gradients, so the reference's
    ``as u16`` cast never wraps (see the JAX module's proof)."""
    return gx * gx + gy * gy


def squared_norm_direct(img: torch.Tensor) -> torch.Tensor:
    """Squared gradient norm straight from the image, ``((2gx)^2 + (2gy)^2)
    / 4`` of the unhalved differences, zero on the 1-pixel border
    (gradient.rs:49-65), as int32.  The sum is at most 2 * 255^2, so the
    division is exact truncation and the reference's ``as u16`` never
    wraps."""
    im = img.to(torch.int32)
    h, w = img.shape[-2:]
    dx = im[..., 1 : h - 1, 2:w] - im[..., 1 : h - 1, 0 : w - 2]
    dy = im[..., 2:h, 1 : w - 1] - im[..., 0 : h - 2, 1 : w - 1]
    out = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    out[..., 1 : h - 1, 1 : w - 1] = torch.div(dx * dx + dy * dy, 4, rounding_mode="trunc")
    return out


def norm_direct(img: torch.Tensor) -> torch.Tensor:
    """Gradient norm ``sqrt(squared_norm_direct)`` in f32, truncated to an
    integer (int32 here, u16 in the reference): the DSO selector's input
    (examples/candidates_dso.rs:42)."""
    return torch.sqrt(squared_norm_direct(img).to(Float)).to(torch.int32)
