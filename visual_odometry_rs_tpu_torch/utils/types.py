"""Dtype policy and device resolution.

Every floating point value is f32, like the JAX package
(``visual_odometry_rs_tpu/utils/types.py``).  Images are u8.  Depth maps are
u16 on disk; torch's uint16 arithmetic is partial, so the port computes with
depth as int32.  A single frame (``depth_tensor``) widens on the host before
it is copied; a clip of the batched driver (``upload_clip``) crosses to a
CUDA device as u16 through page-locked blocks and widens there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Float = torch.float32
Pixel = torch.uint8
Depth = torch.int32
_NUMPY_DTYPES = {torch.uint16: np.uint16, Pixel: np.uint8}  # a clip's dtypes as it arrives


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


def upload_clip(depths, imgs, device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """A clip's u16 depth maps and u8 images (F, B, H, W) → ``(int32 depth,
    uint8 images, bytes staged)`` on ``device``.

    On a CUDA device, host inputs of those dtypes (numpy arrays or CPU
    tensors, strided views too) cross as they are: each is copied into a
    page-locked block of torch's caching host allocator, which hands the
    same blocks out again from clip to clip once their copies have finished;
    the blocks go to the device with ``non_blocking`` copies on the current
    stream, and depth widens to int32 there.  The copies into the blocks are
    synchronous, so the caller may refill its arrays once this returns.
    Anything else (a CPU device, inputs on a device, other dtypes) goes
    through ``depth_tensor`` and ``image_tensor`` and stages 0 bytes.
    """
    device = torch.device(device)
    srcs = (_host_tensor(depths, torch.uint16), _host_tensor(imgs, Pixel))
    if device.type != "cuda" or any(src is None for src in srcs):
        return depth_tensor(depths, device), image_tensor(imgs, device), 0
    on_device = []
    for src in srcs:
        block = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        block.copy_(src)
        on_device.append(block.to(device, non_blocking=True))
    return on_device[0].to(Depth), on_device[1], sum(src.nbytes for src in srcs)


def _host_tensor(x, dtype) -> Optional[torch.Tensor]:
    """``x`` as a CPU tensor on ``x``'s memory if it is a host array of
    ``dtype`` that torch can view (no negative strides), else None."""
    if isinstance(x, torch.Tensor):
        return x if x.device.type == "cpu" and x.dtype == dtype else None
    x = np.asarray(x)
    if x.dtype != _NUMPY_DTYPES[dtype] or any(s < 0 for s in x.strides):
        return None
    return torch.from_numpy(x)


def to_numpy(x) -> np.ndarray:
    """Tensor (any device) or array-like → numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
