"""Inverse-depth maps with validity states, and the two 2x2 fusions.

The port of ``from_depth``, ``to_depth``, ``masked``, ``fuse_dso_mean``,
``fuse_statistically_similar`` and ``pyramid`` of
``visual_odometry_rs_tpu/core/inverse_depth.py`` (inverse_depth.rs:24-152).
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


def to_depth(scale: float, m: InverseDepthMap) -> torch.Tensor:
    """Inverse depth → uint16 depth, ``round(scale / idepth)`` half to even;
    Unknown and Discarded encode as 0 (inverse_depth.rs:37-42).  Values
    past the u16 range saturate, as XLA's conversion does."""
    known = m.known
    idepth = torch.where(known, m.idepth, torch.ones_like(m.idepth))
    depth = torch.round(torch.full_like(idepth, scale) / idepth)
    depth = torch.where(known, depth, torch.zeros_like(depth))
    return torch.clamp(depth, 0.0, 65535.0).to(torch.int32).to(torch.uint16)


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


def fuse_statistically_similar(m: InverseDepthMap) -> InverseDepthMap:
    """Halve the resolution with the statistical-compatibility strategy
    (inverse_depth.rs:105-152).  Over the k known values of each block:
    ``new_d`` is the inverse-variance weighted mean (through products of the
    other variances, like the reference), ``new_v = (2/k) mean(v)``, and the
    block is Discarded unless every input has ``(d_i - new_d)^2 < new_v``.
    k = 0 is Unknown; k = 1 is WithVariance(d, 2 v), with no gate."""
    d = torch.stack(block_2x2(m.idepth))
    v = torch.stack(block_2x2(m.variance))
    valid = torch.stack(block_2x2(m.state)) == WITH_VARIANCE
    validf = valid.to(Float)
    count = validf.sum(dim=0)
    one = torch.ones_like(v)

    # the product of the other valid variances: invalid slots count as 1
    v_or_1 = torch.where(valid, v, one)
    prod_all = torch.prod(v_or_1, dim=0)
    prod_others = torch.where(valid, prod_all / torch.clamp(v_or_1, min=1e-38), torch.zeros_like(v))

    denom = prod_others.sum(dim=0)
    new_d = (d * prod_others).sum(dim=0) / torch.where(denom > 0, denom, torch.ones_like(denom))
    count_1 = torch.clamp(count, min=1.0)
    mean_v = (v * validf).sum(dim=0) / count_1
    new_v = torch.where(count > 0, (torch.full_like(count_1, 2.0) / count_1) * mean_v, torch.zeros_like(mean_v))

    all_ok = torch.where(valid, (d - new_d) ** 2 < new_v, torch.ones_like(valid)).all(dim=0)
    compatible = (count <= 1) | all_ok
    known = count > 0
    state = torch.where(
        known, torch.where(compatible, WITH_VARIANCE, DISCARDED), UNKNOWN
    ).to(torch.uint8)
    keep = state == WITH_VARIANCE
    zero = torch.zeros_like(new_d)
    return InverseDepthMap(torch.where(keep, new_d, zero), torch.where(keep, new_v, zero), state)


def pyramid(m: InverseDepthMap, nb_levels: int, strategy: str = "dso_mean"):
    """Multi-resolution inverse-depth pyramid (inverse_compositional.rs:
    135-138), fused with the DSO mean (``"dso_mean"``, the tracker's) or the
    statistical-compatibility strategy (any other value, as in the JAX
    module)."""
    fuse = fuse_dso_mean if strategy == "dso_mean" else fuse_statistically_similar
    levels = [m]
    for _ in range(1, nb_levels):
        h, w = levels[-1].idepth.shape[-2:]
        if h // 2 == 0 or w // 2 == 0:
            break
        levels.append(fuse(levels[-1]))
    return levels
