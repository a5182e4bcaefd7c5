"""Dtype policy and device resolution.

Every floating point value is f32, like the JAX package
(``visual_odometry_rs_tpu/utils/types.py``).  Images are u8.  Depth maps are
u16 on disk; torch's uint16 arithmetic is partial, so the port computes with
depth as int32.  A single frame (``depth_tensor``) widens on the host before
it is copied.  A clip of the batched driver (``upload_clip``) keeps its depth
maps on the host: only the rows a check frame's keyframe precompute reads,
those of the lanes that switch, cross (``upload_lanes``) as u16 through a
page-locked block and widen on the card.  Its images go to a CUDA device
through a page-locked block frame by frame (``StagedFrames``): a helper
thread (``FrameStager``) copies frame after frame into the block while the
caller tracks, and the caller sends frame t once it is there.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import profiling

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


def upload_clip(depths, imgs, device, first_id: int = 0) -> Tuple[torch.Tensor, Union[torch.Tensor, StagedFrames], int]:
    """A clip's u16 depth maps and u8 images (F, B, H, W) → ``(depth maps,
    images, bytes staged by this call)``, ``images[t]`` being frame t on
    ``device``.

    On a CUDA device, host inputs of those dtypes (numpy arrays or CPU
    tensors, strided views too) split.  The depth maps stay where they are:
    a u16 CPU tensor on the caller's memory, for ``upload_lanes`` to send
    each check frame's switching lanes; the caller leaves them unchanged
    while the clip is tracked.  Images of two frames or more come back as
    ``StagedFrames`` (frame 0's spans have the id ``first_id``), which stages
    and sends them frame by frame and counts their bytes in spans of its
    own; the caller closes it once the clip is tracked or has failed, and
    may refill its images then.  A single frame, which has nothing to
    overlap with, is copied into a page-locked block here and sent with a
    ``non_blocking`` copy on the current stream; the copy into the block is
    synchronous, so the caller may refill its images once this returns, and
    its bytes are staged.  Either block comes from torch's caching host
    allocator, which hands it out again from clip to clip once the copies
    from it have ended.  Anything else (a CPU device, inputs on a device,
    other dtypes, negative strides) goes through ``depth_tensor`` and
    ``image_tensor``: the whole clip on ``device``, depth as int32, 0 bytes
    staged.
    """
    device = torch.device(device)
    src_d, src_i = _host_tensor(depths, torch.uint16), _host_tensor(imgs, Pixel)
    if device.type != "cuda" or src_d is None or src_i is None:
        return depth_tensor(depths, device), image_tensor(imgs, device), 0
    if src_i.shape[0] > 1:
        return src_d, StagedFrames(src_i, device, first_id), 0
    block = torch.empty(src_i.shape, dtype=Pixel, pin_memory=True)
    block.copy_(src_i)
    return src_d, block.to(device, non_blocking=True), src_i.nbytes


class FrameStager:
    """Copies frames ``src[0]``, ``src[1]``, … (a numpy array or CPU tensor,
    any strides) into the same frames of the CPU tensor ``dest`` in order, on
    a helper thread that makes no CUDA call, each in a ``vors.stage`` span
    (id ``first_id + t``, count ``bytes``) on that thread.  A single frame is
    copied here, on the caller's thread, and starts no thread.

    ``wait(t)`` returns once frame t is in ``dest``, and says whether it was
    there already; if the helper failed before frame t, it raises the
    helper's exception.  ``close()`` (also on leaving a ``with`` block) stops
    the helper after the frame it is copying and joins it: from then on
    ``src`` is never read again.
    """

    def __init__(self, src, dest: torch.Tensor, first_id: int = 0):
        self._src = src.numpy() if isinstance(src, torch.Tensor) else src
        self._dest, self._first_id = dest.numpy(), first_id
        self._ready = 0  # frames in dest
        self._error: Optional[BaseException] = None
        self._stop = False
        self._cond = threading.Condition()
        self._thread = None
        if len(self._dest) < 2:
            self._run()
        else:
            self._thread = threading.Thread(target=self._run, name="vors-stage", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        try:
            for t, frame in enumerate(self._dest):
                if self._stop:
                    return
                with profiling.span("vors.stage", id=self._first_id + t, bytes=frame.nbytes):
                    np.copyto(frame, self._src[t])  # releases the GIL while it copies
                with self._cond:
                    self._ready = t + 1
                    self._cond.notify()
        except BaseException as e:  # re-raised on the caller's thread by wait
            with self._cond:
                self._error = e
                self._cond.notify()

    def wait(self, t: int) -> bool:
        with self._cond:
            ahead = self._ready > t
            while self._ready <= t and self._error is None:
                self._cond.wait()
            if self._ready <= t:
                raise self._error
        return ahead

    def close(self) -> None:
        self._stop = True
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._src = self._dest = None  # the caller's images, and the block's view

    def __enter__(self) -> "FrameStager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StagedFrames:
    """A host clip's u8 images ``src`` (F, B, H, W) on their way to the CUDA
    ``device`` frame by frame.

    A ``FrameStager`` copies the frames into a page-locked block of torch's
    caching host allocator, one after the other, while the caller works.
    ``frames[t]`` waits until frame t is in the block, sends it (and any
    frame before it not sent yet) with a ``non_blocking`` copy on the
    current stream into frame t of a device tensor of the clip's shape, each
    frame in a ``vors.upload`` span (counts ``bytes`` and ``staged``), and
    returns that frame on the device.  ``staged_ahead`` counts the frames
    that were in the block before they were asked for.  ``close()`` (also on
    leaving a ``with`` block) joins the helper and frees the block; the
    allocator reuses it only once the copies from it have ended.  The
    caller's images are free once it returns.
    """

    def __init__(self, src: torch.Tensor, device, first_id: int = 0):
        self.shape = src.shape
        self.staged_ahead = 0
        self._block = torch.empty(src.shape, dtype=Pixel, pin_memory=True)
        self._out = torch.empty(src.shape, dtype=Pixel, device=device)
        self._frame_bytes = self._out[0].nbytes
        self._sent = 0  # frames sent to the device
        self._stager = FrameStager(src, self._block, first_id)

    def __getitem__(self, t: int) -> torch.Tensor:
        t = range(self.shape[0])[t]
        while self._sent <= t:
            f, nbytes = self._sent, self._frame_bytes
            with profiling.span("vors.upload", bytes=nbytes, staged=nbytes):
                self.staged_ahead += self._stager.wait(f)
                self._out[f].copy_(self._block[f], non_blocking=True)
            self._sent += 1
        return self._out[t]

    def close(self) -> None:
        self._stager.close()
        self._block = None

    def __enter__(self) -> "StagedFrames":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


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
