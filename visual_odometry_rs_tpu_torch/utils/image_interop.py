"""Image ↔ matrix conversions (reference ``src/misc/interop.rs``).

The port of ``visual_odometry_rs_tpu/utils/interop.py``, under another name:
the port's top-level ``interop`` converts state between the JAX package and
the port.  Arrays are indexed (row, col) = (v, u), ``img[y, x]``, like the
reference's matrices; candidate coordinates are ``(x, y) = (col, row)``.

Difference from the JAX package: it returns and takes PIL images; the port
needs no PIL, so ``image_from_matrix`` and ``rgb_image_from_matrix`` return
u8 arrays of the image's layout ((H, W) gray, (H, W, 3) RGB), which
``dataset.tum_rgbd.write_png`` writes, and ``matrix_from_image`` takes any
array-like (a PIL image converts with ``np.asarray``), keeping the Rust
image crate's integer BT.601 luma for RGB input.
"""

from __future__ import annotations

import numpy as np


def matrix_from_image(img) -> np.ndarray:
    """Gray or RGB(A) image array → (H, W) u8 matrix (interop.rs:53-56)."""
    arr = np.asarray(img)
    if arr.ndim == 3:
        rgb = arr[..., :3].astype(np.uint32)
        arr = (299 * rgb[..., 0] + 587 * rgb[..., 1] + 114 * rgb[..., 2]) // 1000
    return arr.astype(np.uint8)


def image_from_matrix(mat) -> np.ndarray:
    """(H, W) matrix → (H, W) u8 gray image array (interop.rs:16-23)."""
    mat = np.asarray(mat, np.uint8)
    if mat.ndim != 2:
        raise ValueError(f"image_from_matrix takes an (H, W) matrix, got {mat.shape}")
    return mat


def rgb_image_from_matrix(mat) -> np.ndarray:
    """(H, W, 3) matrix → (H, W, 3) u8 RGB image array (interop.rs:30-38)."""
    mat = np.asarray(mat, np.uint8)
    if mat.ndim != 3 or mat.shape[-1] != 3:
        raise ValueError(f"rgb_image_from_matrix takes an (H, W, 3) matrix, got {mat.shape}")
    return mat
