"""Coarse-to-fine candidate selection, corner formulation.

The port of ``select(..., impl="corner")`` in
``visual_odometry_rs_tpu/core/candidates/coarse_to_fine.py``: the coarsest
gradient level is all-true; each finer level keeps, inside every 2x2 block
under a selected coarse pixel, the largest gradient, plus the second if
``second > third + diff_threshold`` (coarse_to_fine.rs:64-89).  Ties break
in corner order a < b < c < d.  Odd trailing rows/cols are never selected.
"""

from __future__ import annotations

from typing import List

import torch

from ...ops.pyramid import block_2x2


def _prune_block(thresh, a, b, c, d):
    """Per-corner keep masks of ``prune_with_thresh`` (coarse_to_fine.rs:73-89)."""
    if not a.is_floating_point():
        a, b, c, d = (x.to(torch.int32) for x in (a, b, c, d))
    ab, ac, ad = a >= b, a >= c, a >= d
    bc, bd, cd = b >= c, b >= d, c >= d

    def i(x):
        return x.to(torch.int32)

    # rank = number of corners that beat this one (0 = largest)
    r_a = i(~ab) + i(~ac) + i(~ad)
    r_b = i(ab) + i(~bc) + i(~bd)
    r_c = i(ac) + i(bc) + i(~cd)
    r_d = i(ad) + i(bd) + i(cd)

    # second and third values by a 4-element min/max sorting network
    s1, t1 = torch.maximum(a, b), torch.minimum(a, b)
    s2, t2 = torch.maximum(c, d), torch.minimum(c, d)
    mid1, mid2 = torch.minimum(s1, s2), torch.maximum(t1, t2)
    second_val = torch.maximum(mid1, mid2)
    third_val = torch.minimum(mid1, mid2)
    keep_second = second_val > third_val + thresh

    def keep(r):
        return (r == 0) | ((r == 1) & keep_second)

    return keep(r_a), keep(r_b), keep(r_c), keep(r_d)


def select(diff_threshold, gradient_sq_levels: List[torch.Tensor]) -> List[torch.Tensor]:
    """Candidate masks per level (coarse_to_fine.rs:15-32).

    ``gradient_sq_levels`` is ordered fine→coarse; the masks come back
    coarse→fine, the finest last.
    """
    coarsest = gradient_sq_levels[-1]
    masks = [torch.ones(coarsest.shape, dtype=torch.bool, device=coarsest.device)]
    for grad in reversed(gradient_sq_levels[:-1]):
        h, w = grad.shape[-2:]
        h2, w2 = h // 2, w // 2
        pre = masks[-1][..., :h2, :w2]
        ka, kb, kc, kd = _prune_block(diff_threshold, *block_2x2(grad))
        # zero padding: an odd last row/col stays unselected
        full = torch.zeros(grad.shape, dtype=torch.bool, device=grad.device)
        full[..., 0 : 2 * h2 : 2, 0 : 2 * w2 : 2] = ka & pre
        full[..., 1 : 2 * h2 : 2, 0 : 2 * w2 : 2] = kb & pre
        full[..., 0 : 2 * h2 : 2, 1 : 2 * w2 : 2] = kc & pre
        full[..., 1 : 2 * h2 : 2, 1 : 2 * w2 : 2] = kd & pre
        masks.append(full)
    return masks
