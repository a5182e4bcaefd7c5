"""Dtype policy and device resolution.

Every floating point value is f32, like the JAX package
(``visual_odometry_rs_tpu/utils/types.py``).  Images are u8.  Depth maps are
u16 on disk; torch's uint16 arithmetic is partial, so the port carries depth
as int32 from the input boundary on.
"""

from __future__ import annotations

import numpy as np
import torch

Float = torch.float32
Pixel = torch.uint8
Depth = torch.int32


def resolve_device(device) -> torch.device:
    """``"cpu"``, ``"cuda"``, ``"cuda:N"`` or a ``torch.device`` → device.

    Asking for CUDA where no CUDA device exists raises: the port never falls
    back to the CPU silently.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def depth_tensor(depth, device) -> torch.Tensor:
    """u16 depth map (numpy or tensor) → int32 tensor on ``device``."""
    if isinstance(depth, torch.Tensor):
        return depth.to(device=device, dtype=Depth)
    return torch.from_numpy(np.asarray(depth).astype(np.int32)).to(device)


def image_tensor(img, device) -> torch.Tensor:
    """u8 image (numpy or tensor) → uint8 tensor on ``device``."""
    if isinstance(img, torch.Tensor):
        return img.to(device=device, dtype=Pixel)
    return torch.from_numpy(np.ascontiguousarray(img, dtype=np.uint8)).to(device)


def to_numpy(x) -> np.ndarray:
    """Tensor (any device) or array-like → numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
