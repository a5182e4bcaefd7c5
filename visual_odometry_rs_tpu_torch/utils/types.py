"""Dtype policy and device resolution.

Every floating point value is f32, like the JAX package
(``visual_odometry_rs_tpu/utils/types.py``).  Images are u8.  Depth maps are
u16 on disk; torch's uint16 arithmetic is partial, so the port computes with
depth as int32.  A single frame (``depth_tensor``) widens on the host before
it is copied.  A clip of the batched driver (``upload_clip``) sends its
images to a CUDA device through a page-locked block and keeps its depth
maps on the host: only the rows a check frame's keyframe precompute reads,
those of the lanes that switch, cross (``upload_lanes``) as u16 through a
page-locked block and widen on the card.
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
    """A clip's u16 depth maps and u8 images (F, B, H, W) → ``(depth maps,
    uint8 images on device, bytes staged)``.

    On a CUDA device, host inputs of those dtypes (numpy arrays or CPU
    tensors, strided views too) split.  The images are copied into a
    page-locked block of torch's caching host allocator, which hands the
    same block out again from clip to clip once its copy has finished, and
    go to the device with a ``non_blocking`` copy on the current stream;
    that copy into the block is synchronous, so the caller may refill its
    images once this returns.  The depth maps stay where they are: they come
    back as a u16 CPU tensor on the caller's memory, for ``upload_lanes`` to
    send each check frame's switching lanes, and the caller leaves them
    unchanged while the clip is tracked.  Only the images' bytes are staged.
    Anything else (a CPU device, inputs on a device, other dtypes, negative
    strides) goes through ``depth_tensor`` and ``image_tensor``: the whole
    clip on ``device``, depth as int32, 0 bytes staged.
    """
    device = torch.device(device)
    src_d, src_i = _host_tensor(depths, torch.uint16), _host_tensor(imgs, Pixel)
    if device.type != "cuda" or src_d is None or src_i is None:
        return depth_tensor(depths, device), image_tensor(imgs, device), 0
    block = torch.empty(src_i.shape, dtype=Pixel, pin_memory=True)
    block.copy_(src_i)
    return src_d, block.to(device, non_blocking=True), src_i.nbytes


def upload_lanes(depth, lanes: torch.Tensor, into: torch.Tensor, block: Optional[torch.Tensor] = None) -> int:
    """Rows ``lanes`` ((K,) int64 on the CPU) of a host u16 frame ``depth``
    (B, H, W; a numpy array or CPU tensor, any strides), widened to int32,
    into the same rows of ``into`` ((B, H, W) int32); the other rows of
    ``into`` are left as they are.  Returns the bytes staged.

    Into a CUDA tensor the K rows are gathered into the first K rows of
    ``block`` (page-locked u16, at least K rows of (H, W)), cross with one
    ``non_blocking`` copy on the current stream and widen on the card; the
    caller refills ``block`` only after that copy has ended (a host read of
    the stream waits for it), and K rows of ``depth``'s bytes are staged.
    Elsewhere the rows are gathered and widened on the host, and 0 bytes are
    staged.
    """
    src = _host_tensor(depth, torch.uint16)
    if src is None:
        host = np.asarray(depth)
        if host.dtype != np.uint16:
            raise TypeError(f"depth must be u16, got {host.dtype}")
        src = torch.from_numpy(host.copy())  # negative strides, which torch cannot view
    if into.device.type != "cuda":
        into.index_copy_(0, lanes, src.index_select(0, lanes).to(Depth))
        return 0
    rows = block[: lanes.numel()]
    # as int16, the same bits: torch's host copies of uint16 are not vectorized
    torch.index_select(src.view(torch.int16), 0, lanes, out=rows.view(torch.int16))
    into.index_copy_(0, lanes.to(into.device), rows.to(into.device, non_blocking=True).to(Depth))
    return rows.nbytes


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
