"""Inverse-depth maps with validity states, and the DSO-mean 2x2 fusion.

The port of ``from_depth``, ``masked``, ``fuse_dso_mean`` and
``pyramid(strategy="dso_mean")`` of
``visual_odometry_rs_tpu/core/inverse_depth.py`` (inverse_depth.rs:24-98).
The reference's enum {Unknown, Discarded, WithVariance(ρ, σ²)} is three
dense channels: ``idepth`` (f32), ``variance`` (f32) and a u8 ``state``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.pyramid import block_2x2
from ..utils.types import Float

UNKNOWN = 0
DISCARDED = 1
WITH_VARIANCE = 2


class InverseDepthMap(NamedTuple):
    idepth: torch.Tensor  # f32
    variance: torch.Tensor  # f32
    state: torch.Tensor  # uint8: UNKNOWN / DISCARDED / WITH_VARIANCE

    @property
    def known(self) -> torch.Tensor:
        return self.state == WITH_VARIANCE


def _state(known: torch.Tensor) -> torch.Tensor:
    return torch.where(known, WITH_VARIANCE, UNKNOWN).to(torch.uint8)


def from_depth(scale: float, depth: torch.Tensor, variance: float) -> InverseDepthMap:
    """Integer depth map → inverse depth (inverse_depth.rs:24-29): a raw 0
    is unknown, otherwise ``idepth = scale / depth``."""
    known = depth > 0
    depth_f = depth.to(Float)
    zero = torch.zeros_like(depth_f)
    # a tensor numerator: ``scalar / tensor`` multiplies by a reciprocal in torch
    idepth = torch.where(known, torch.full_like(depth_f, scale) / torch.clamp(depth_f, min=1.0), zero)
    var = torch.where(known, torch.full_like(depth_f, variance), zero)
    return InverseDepthMap(idepth, var, _state(known))


def masked(m: InverseDepthMap, mask: torch.Tensor) -> InverseDepthMap:
    """Keep values only where ``mask``; Unknown elsewhere."""
    keep = mask & m.known
    zero = torch.zeros_like(m.idepth)
    return InverseDepthMap(
        torch.where(keep, m.idepth, zero), torch.where(keep, m.variance, zero), _state(keep)
    )


def fuse_dso_mean(m: InverseDepthMap) -> InverseDepthMap:
    """Halve the resolution with the DSO mean (inverse_depth.rs:81-98):
    ``new_d = Σ d_i v_i / Σ v_i``, ``new_v = Σ v_i`` over the known values of
    each block; Unknown if none is known.  Sums run in corner order a,b,c,d."""
    ds = block_2x2(m.idepth)
    vs = block_2x2(m.variance)
    valids = [(s == WITH_VARIANCE).to(Float) for s in block_2x2(m.state)]
    vsum = vs[0] * valids[0] + vs[1] * valids[1] + vs[2] * valids[2] + vs[3] * valids[3]
    dsum = (
        ds[0] * vs[0] * valids[0]
        + ds[1] * vs[1] * valids[1]
        + ds[2] * vs[2] * valids[2]
        + ds[3] * vs[3] * valids[3]
    )
    count = valids[0] + valids[1] + valids[2] + valids[3]
    known = count > 0
    zero = torch.zeros_like(vsum)
    new_d = torch.where(known, dsum / torch.where(known, vsum, torch.ones_like(vsum)), zero)
    new_v = torch.where(known, vsum, zero)
    return InverseDepthMap(new_d, new_v, _state(known))


def pyramid(m: InverseDepthMap, nb_levels: int):
    """Multi-resolution inverse-depth pyramid fused with the DSO mean
    (inverse_compositional.rs:135-138; the JAX ``strategy="dso_mean"``)."""
    levels = [m]
    for _ in range(1, nb_levels):
        h, w = levels[-1].idepth.shape[-2:]
        if h // 2 == 0 or w // 2 == 0:
            break
        levels.append(fuse_dso_mean(levels[-1]))
    return levels
