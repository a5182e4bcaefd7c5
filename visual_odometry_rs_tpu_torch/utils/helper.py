"""Small helpers (reference ``src/misc/helper.rs``).

The port of ``visual_odometry_rs_tpu/utils/helper.py``: ``zip_mask_map``
and ``div_rem``.  ``read_png_16bits`` lives in ``dataset.tum_rgbd``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def zip_mask_map(mat: torch.Tensor, mask: torch.Tensor, default, f: Callable) -> torch.Tensor:
    """``f(mat)`` where ``mask`` holds, ``default`` elsewhere (helper.rs:40-47);
    ``f`` maps tensors to tensors."""
    out = f(mat)
    return torch.where(mask, out, torch.as_tensor(default, dtype=out.dtype, device=out.device))


def div_rem(a: int, b: int) -> Tuple[int, int]:
    """Quotient and remainder (helper.rs:50-55)."""
    return a // b, a % b
