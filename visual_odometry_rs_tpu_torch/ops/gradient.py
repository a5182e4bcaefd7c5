"""Image gradients: the reference's integer functions, the tracker's f32
path, and the DSO selector's gradient norm.

The port of ``visual_odometry_rs_tpu/ops/gradient.py``.  Rust's integer
division truncates toward zero, hence ``rounding_mode="trunc"`` and never
floor.

- The public integer functions keep the reference's dtypes: ``centered``,
  ``bloc_x`` and ``bloc_y`` are int16 (gradient.rs:15-33, 74-93);
  ``squared_norm``, ``bloc_squared_norm`` and ``gradients_squared_norm``
  are uint16 (gradient.rs:38-44, 102-111), computed in int32 and cast at
  the end (torch's uint16 has few operations; the cast wraps as Rust's
  ``as u16`` does).
- The f32 functions (``centered_f32``, ``gradients_xy_f32``,
  ``squared_norm_f32``) carry the same integer values, every one below
  2^24, so f32 is exact; the tracker uses them.
- ``squared_norm_direct`` and ``norm_direct`` keep the reference's integer
  arithmetic (gradient.rs:49-65) on int32 tensors: every value here is
  below 2^16 anyway.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..utils.types import Float
from .pyramid import block_2x2


def _trunc_div(x: torch.Tensor, d: int) -> torch.Tensor:
    """Division truncating toward zero (Rust's integer ``/``), in ``x``'s
    dtype: exact on integer tensors and on integer-valued f32 ones."""
    return torch.div(x, d, rounding_mode="trunc")


def centered(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centered gradients of a u8 image as int16, zero on the 1-pixel border
    (gradient.rs:15-33)."""
    im = img.to(torch.int16)
    h, w = img.shape[-2:]
    gx = torch.zeros(img.shape, dtype=torch.int16, device=img.device)
    gy = torch.zeros(img.shape, dtype=torch.int16, device=img.device)
    gx[..., 1 : h - 1, 1 : w - 1] = _trunc_div(im[..., 1 : h - 1, 2:w] - im[..., 1 : h - 1, 0 : w - 2], 2)
    gy[..., 1 : h - 1, 1 : w - 1] = _trunc_div(im[..., 2:h, 1 : w - 1] - im[..., 0 : h - 2, 1 : w - 1], 2)
    return gx, gy


def squared_norm(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """``gx^2 + gy^2`` in int32, cast to uint16 (gradient.rs:38-44)."""
    gx, gy = gx.to(torch.int32), gy.to(torch.int32)
    return (gx * gx + gy * gy).to(torch.uint16)


def bloc_x(a, b, c, d) -> torch.Tensor:
    """Horizontal gradient of 2x2 blocks [[a,c],[b,d]], int16 (gradient.rs:74-80)."""
    a, b, c, d = (x.to(torch.int16) for x in (a, b, c, d))
    return _trunc_div(c + d - a - b, 2)


def bloc_y(a, b, c, d) -> torch.Tensor:
    """Vertical gradient of 2x2 blocks [[a,c],[b,d]], int16 (gradient.rs:87-93)."""
    a, b, c, d = (x.to(torch.int16) for x in (a, b, c, d))
    return _trunc_div(b - a + d - c, 2)


def bloc_squared_norm(a, b, c, d) -> torch.Tensor:
    """Squared gradient norm of 2x2 blocks, uint16 (gradient.rs:102-111)."""
    a, b, c, d = (x.to(torch.int32) for x in (a, b, c, d))
    dx = c + d - a - b
    dy = b - a + d - c
    return _trunc_div(dx * dx + dy * dy, 4).to(torch.uint16)


def gradients_xy(img_pyramid: List[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """int16 (gx, gy) at levels 1..n-1 from the image one level finer
    (multires.rs:96-126)."""
    out = []
    for img in img_pyramid[:-1]:
        corners = block_2x2(img)
        out.append((bloc_x(*corners), bloc_y(*corners)))
    return out


def gradients_squared_norm(img_pyramid: List[torch.Tensor]) -> List[torch.Tensor]:
    """uint16 squared-norm gradients at levels 1..n-1 (multires.rs:96-106)."""
    return [bloc_squared_norm(*block_2x2(img)) for img in img_pyramid[:-1]]


def centered_f32(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centered gradients ``(I(i,j+1)-I(i,j-1))/2``, ``(I(i+1,j)-I(i-1,j))/2``,
    zero on the 1-pixel border (gradient.rs:15-33)."""
    im = img.to(Float)
    h, w = img.shape[-2:]
    gx = torch.zeros(img.shape, dtype=Float, device=img.device)
    gy = torch.zeros(img.shape, dtype=Float, device=img.device)
    gx[..., 1 : h - 1, 1 : w - 1] = _trunc_div(im[..., 1 : h - 1, 2:w] - im[..., 1 : h - 1, 0 : w - 2], 2)
    gy[..., 1 : h - 1, 1 : w - 1] = _trunc_div(im[..., 2:h, 1 : w - 1] - im[..., 0 : h - 2, 1 : w - 1], 2)
    return gx, gy


def gradients_xy_f32(img_pyramid: List[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """2x2-block (gx, gy) at levels 1..n-1 from the image one level finer
    (gradient.rs:74-93, multires.rs:96-126)."""
    out = []
    for img in img_pyramid[:-1]:
        a, b, c, d = (x.to(Float) for x in block_2x2(img))
        out.append((_trunc_div(c + d - a - b, 2), _trunc_div(b - a + d - c, 2)))
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
