"""u8 mean pyramid with the reference's integer semantics.

The port of ``visual_odometry_rs_tpu/ops/pyramid.py``: each level is the
truncating integer mean ``(a+b+c+d)/4`` of the 2x2 blocks of the level
below (multires.rs:21-31); an odd last row or column is dropped.  The
generic combinators ``halve``, ``sequence`` and ``limited_sequence``
(multires.rs:38-88) build other pyramids, as the gradient ones of
``ops.gradient``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch


def block_2x2(mat: torch.Tensor):
    """The 2x2 block corners ``(a, b, c, d)`` of a matrix (multires.rs:79-84):
    a=(2i,2j) top-left, b=(2i+1,2j) bottom-left, c=(2i,2j+1) top-right,
    d=(2i+1,2j+1) bottom-right.  Odd trailing rows/cols are dropped."""
    h2 = mat.shape[-2] // 2
    w2 = mat.shape[-1] // 2
    m = mat[..., : 2 * h2, : 2 * w2]
    return m[..., 0::2, 0::2], m[..., 1::2, 0::2], m[..., 0::2, 1::2], m[..., 1::2, 1::2]


def halve(mat: torch.Tensor, f: Callable) -> Optional[torch.Tensor]:
    """``f(a, b, c, d)`` of every 2x2 block (multires.rs:67-88); None below
    2 pixels in either dimension."""
    if mat.shape[-2] // 2 == 0 or mat.shape[-1] // 2 == 0:
        return None
    return f(*block_2x2(mat))


def sequence(data, f: Callable) -> List:
    """``data``, ``f(data)``, … until ``f`` returns None (multires.rs:53-60)."""
    out = [data]
    while True:
        nxt = f(out[-1])
        if nxt is None:
            return out
        out.append(nxt)


def limited_sequence(max_length: int, data, f: Callable) -> List:
    """``sequence`` capped at ``max_length`` elements (multires.rs:38-49)."""
    out = [data]
    while len(out) < max_length:
        nxt = f(out[-1])
        if nxt is None:
            return out
        out.append(nxt)
    return out


def mean_2x2_u8(a, b, c, d) -> torch.Tensor:
    """Truncating integer mean of the four u8 corners of 2x2 blocks."""
    s = a.to(torch.int32) + b.to(torch.int32) + c.to(torch.int32) + d.to(torch.int32)
    return torch.div(s, 4, rounding_mode="trunc").to(torch.uint8)


def halve_u8(mat: torch.Tensor) -> torch.Tensor:
    """Integer mean of the 2x2 blocks of a u8 matrix, truncating like the
    reference (multires.rs:21-31); an odd last row or column is dropped.
    The four corners are summed as one reduction over a (h/2, 2, w/2, 2)
    view, so a level costs four tensor operations (kernel launches on a GPU)."""
    h2 = mat.shape[-2] // 2
    w2 = mat.shape[-1] // 2
    blocks = mat[..., : 2 * h2, : 2 * w2].reshape(*mat.shape[:-2], h2, 2, w2, 2)
    s = blocks.to(torch.int32).sum(dim=(-3, -1), dtype=torch.int32)
    return torch.div(s, 4, rounding_mode="trunc").to(torch.uint8)


def mean_pyramid(max_levels: int, img: torch.Tensor) -> List[torch.Tensor]:
    """Up to ``max_levels`` levels, finest first; stops below 2 pixels."""
    out = [img]
    while len(out) < max_levels:
        h, w = out[-1].shape[-2:]
        if h // 2 == 0 or w // 2 == 0:
            break
        out.append(halve_u8(out[-1]))
    return out


def num_levels(height: int, width: int, max_levels: int) -> int:
    """Number of levels ``mean_pyramid`` makes for this shape."""
    n = 1
    h, w = height, width
    while n < max_levels and h // 2 > 0 and w // 2 > 0:
        h, w = h // 2, w // 2
        n += 1
    return n


def level_shapes(height: int, width: int, nb_levels: int):
    """Static shapes of each pyramid level."""
    shapes = [(height, width)]
    for _ in range(1, nb_levels):
        h, w = shapes[-1]
        shapes.append((h // 2, w // 2))
    return shapes
