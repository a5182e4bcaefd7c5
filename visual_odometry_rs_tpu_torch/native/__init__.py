"""The port's native PNG reader and prefetching frame loader (ctypes).

Binds ``csrc/vors_io.cpp``, the port's own copy of the JAX package's native
loader (``visual_odometry_rs_tpu/native``): the reference decodes its u16
depth PNGs and turns color into luma natively (``helper.rs:13-36``, the
``image`` crate's ``to_luma`` at ``vors_track.rs:143``).  The library decodes
PNG on zlib alone, so it builds wherever zlib's header is installed.

``ops.build`` compiles it with ``g++`` at first use into the package's
git-ignored ``_build/`` directory (``chip_smoke.py`` builds it in its phase
0).  ``available()`` is False when it cannot be built or loaded, and
``dataset.tum_rgbd`` then reads through PIL, with the same arrays.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, Sequence, Tuple

import numpy as np

from ..ops import build

_C_INT_P = ctypes.POINTER(ctypes.c_int)
_U16_P = ctypes.POINTER(ctypes.c_uint16)
_U8_P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library, or None when it cannot be built or loaded."""
    try:
        lib = build.load("vors_io")
    except (RuntimeError, OSError):
        return None
    lib.vors_last_error.restype = ctypes.c_char_p
    lib.vors_last_error.argtypes = []
    lib.vors_png_dims.restype = ctypes.c_int
    lib.vors_png_dims.argtypes = [ctypes.c_char_p, _C_INT_P, _C_INT_P]
    lib.vors_read_png16.restype = ctypes.c_int
    lib.vors_read_png16.argtypes = [ctypes.c_char_p, _U16_P, ctypes.c_int, ctypes.c_int]
    lib.vors_read_gray.restype = ctypes.c_int
    lib.vors_read_gray.argtypes = [ctypes.c_char_p, _U8_P, ctypes.c_int, ctypes.c_int]
    lib.vors_loader_create.restype = ctypes.c_void_p
    lib.vors_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.vors_loader_next.restype = ctypes.c_int
    lib.vors_loader_next.argtypes = [ctypes.c_void_p, _U16_P, _U8_P]
    lib.vors_loader_destroy.restype = None
    lib.vors_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """True when the native library loads (building it if needed)."""
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native IO library could not be built or loaded")
    return lib


def _last_error(lib) -> str:
    msg = lib.vors_last_error()
    return msg.decode() if msg else "unknown native IO error"


def png_dims(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG file, from its header."""
    lib = _lib()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.vors_png_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(_last_error(lib))
    return h.value, w.value


def read_png_16bits(path: str) -> np.ndarray:
    """16-bit gray depth PNG → (H, W) uint16 (helper.rs:13-36); any other
    layout raises ``IOError``."""
    lib = _lib()
    h, w = png_dims(path)
    out = np.empty((h, w), dtype=np.uint16)
    if lib.vors_read_png16(path.encode(), out.ctypes.data_as(_U16_P), h, w) != 0:
        raise IOError(_last_error(lib))
    return out


def read_gray(path: str) -> np.ndarray:
    """Color or gray PNG → (H, W) uint8 BT.601 integer luma."""
    lib = _lib()
    h, w = png_dims(path)
    out = np.empty((h, w), dtype=np.uint8)
    if lib.vors_read_gray(path.encode(), out.ctypes.data_as(_U8_P), h, w) != 0:
        raise IOError(_last_error(lib))
    return out


class PrefetchLoader:
    """In-order (depth u16, gray u8) frames, decoded ahead by native threads.

    ``num_threads`` workers decode up to ``max_ahead`` frames ahead of the
    consumer, so PNG decode overlaps the tracking of the current frame (the
    reference decodes on the tracking thread, vors_track.rs:49-64).  A frame
    that fails to decode raises ``IOError`` when it is its turn, after every
    frame before it.  A context manager and an iterator over the pairs.
    """

    def __init__(
        self,
        depth_paths: Sequence[str],
        color_paths: Sequence[str],
        height: int,
        width: int,
        num_threads: int = 4,
        max_ahead: int = 8,
    ):
        if len(depth_paths) != len(color_paths):
            raise ValueError("the depth and color path lists differ in length")
        self._lib = _lib()
        self._shape = (height, width)
        n = len(depth_paths)
        depth = (ctypes.c_char_p * n)(*[p.encode() for p in depth_paths])
        color = (ctypes.c_char_p * n)(*[p.encode() for p in color_paths])
        self._handle = self._lib.vors_loader_create(depth, color, n, height, width, num_threads, max_ahead)
        if not self._handle:
            raise RuntimeError("the native loader could not be created")

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._handle is None:
            raise StopIteration
        depth = np.empty(self._shape, dtype=np.uint16)
        gray = np.empty(self._shape, dtype=np.uint8)
        rc = self._lib.vors_loader_next(self._handle, depth.ctypes.data_as(_U16_P), gray.ctypes.data_as(_U8_P))
        if rc == -1:
            raise StopIteration
        if rc != 0:
            raise IOError(_last_error(self._lib))
        return depth, gray

    def close(self) -> None:
        """Stops and joins the workers; idempotent."""
        if self._handle is not None:
            self._lib.vors_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self.close()
