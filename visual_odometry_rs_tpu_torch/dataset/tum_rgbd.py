"""TUM RGB-D dataset: constants, parsers, trajectory lines, image IO.

The port of ``visual_odometry_rs_tpu/dataset/tum_rgbd.py`` (reference
``src/dataset/tum_rgbd.rs``): depth scale 5000, the intrinsics presets,
association and trajectory parsing with ``#`` comments, the TUM trajectory
line ``timestamp tx ty tz qx qy qz qw`` (qw last), and PNG IO.  PNGs are
read by the port's native library (``native``, which ``frame_loader`` uses
to decode frames ahead on threads) and, where it cannot be built, by PIL,
with the same arrays.  ``write_sequence`` writes PNGs with the standard
library's ``zlib`` and needs neither.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from ..core.camera import Intrinsics
from ..math.pose import Pose
from ..utils.types import Float, to_numpy

DEPTH_SCALE = 5000.0
VARIANCE_TUM = 1e-4

# (cx, cy, fx, fy) of each preset (tum_rgbd.rs:23-51), valid at 640x480
PRESETS = {
    "fr1": (318.643040, 255.313989, 517.306408, 516.469215),
    "fr2": (325.141442, 249.701764, 520.908620, 521.007327),
    "fr3": (320.106653, 247.632132, 535.433105, 539.212524),
    "icl": (319.5, 239.5, 481.20, -480.00),
}
NATIVE_WIDTH, NATIVE_HEIGHT = 640, 480


def _preset(camera_id: str, device) -> Intrinsics:
    return Intrinsics.make(*PRESETS[camera_id], 0.0, device=device)


def intrinsics_fr1(device="cpu") -> Intrinsics:
    return _preset("fr1", device)


def intrinsics_fr2(device="cpu") -> Intrinsics:
    return _preset("fr2", device)


def intrinsics_fr3(device="cpu") -> Intrinsics:
    return _preset("fr3", device)


def intrinsics_icl_nuim(device="cpu") -> Intrinsics:
    return _preset("icl", device)


def scaled_intrinsics(camera_id: str, height: int, width: int, device="cpu") -> Intrinsics:
    """Preset intrinsics rescaled to another image size: focal lengths
    scale linearly, the principal point as ``c' = (c + 0.5) * s - 0.5``
    (the pixel-center convention).  Identity at 640x480.

    The arithmetic runs in f32 like the JAX module, whose presets are f32.
    """
    cx, cy, fx, fy = (np.float32(v) for v in PRESETS[camera_id])
    sx = width / NATIVE_WIDTH
    sy = height / NATIVE_HEIGHT
    return Intrinsics.make(
        (float(cx) + 0.5) * sx - 0.5,
        (float(cy) + 0.5) * sy - 0.5,
        float(fx) * sx,
        float(fy) * sy,
        0.0,
        device=device,
    )


@dataclass
class Association:
    """Paired depth/color timestamps and file paths (tum_rgbd.rs:62-73)."""

    depth_timestamp: float
    depth_file_path: str
    color_timestamp: float
    color_file_path: str


@dataclass
class Frame:
    """Timestamp + camera pose (tum_rgbd.rs:53-60)."""

    timestamp: float
    pose: Pose

    def to_string(self) -> str:
        """``timestamp tx ty tz qx qy qz qw`` (tum_rgbd.rs:76-86): qw LAST,
        while the pose stores [w, x, y, z]."""
        t = to_numpy(self.pose.t).astype(np.float64)
        q = to_numpy(self.pose.q).astype(np.float64)
        vals = [self.timestamp, t[0], t[1], t[2], q[1], q[2], q[3], q[0]]
        return " ".join(np.format_float_positional(v, trim="-") for v in vals)


def parse_associations(content: str) -> List[Association]:
    """Parse an associations file; ``#`` lines are comments (tum_rgbd.rs:97-99)."""
    out = []
    for line in content.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 4:
            raise ValueError(f"Parsing error: {line!r}")
        out.append(Association(float(parts[0]), parts[1], float(parts[2]), parts[3]))
    return out


def parse_trajectory(content: str) -> List[Frame]:
    """Parse a TUM trajectory or ground-truth file (tum_rgbd.rs:102-104):
    ``timestamp tx ty tz qx qy qz qw`` per line, into f32 poses."""
    import torch

    out = []
    for line in content.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 8:
            raise ValueError(f"Parsing error: {line!r}")
        ts, tx, ty, tz, qx, qy, qz, qw = (float(p) for p in parts)
        out.append(Frame(timestamp=ts, pose=Pose(
            q=torch.tensor([qw, qx, qy, qz], dtype=Float), t=torch.tensor([tx, ty, tz], dtype=Float),
        )))
    return out


def load_associations(path: str) -> List[Association]:
    """Read and parse, making image paths absolute (vors_track.rs:113-137)."""
    with open(path) as f:
        assocs = parse_associations(f.read())
    parent = os.path.dirname(os.path.abspath(path))
    for a in assocs:
        a.depth_file_path = os.path.join(parent, a.depth_file_path)
        a.color_file_path = os.path.join(parent, a.color_file_path)
    return assocs


def read_png_16bits(path: str) -> np.ndarray:
    """16-bit depth PNG → (H, W) uint16 (helper.rs:13-36)."""
    from .. import native

    if native.available():
        return native.read_png_16bits(path)
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img)
    if arr.dtype != np.uint16:
        if arr.dtype == np.int32:  # PIL mode "I"
            arr = arr.astype(np.uint16)
        else:
            raise ValueError(f"expected 16-bit depth PNG, got {arr.dtype}: {path}")
    return arr


def read_gray(path: str) -> np.ndarray:
    """Image → (H, W) uint8 luma with the integer BT.601 weights of the Rust
    ``image`` crate: (299 R + 587 G + 114 B) / 1000."""
    from .. import native

    if native.available() and path.lower().endswith(".png"):
        return native.read_gray(path)
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img)
    if arr.ndim == 2:
        return arr.astype(np.uint8)
    rgb = arr[..., :3].astype(np.uint32)
    return ((299 * rgb[..., 0] + 587 * rgb[..., 1] + 114 * rgb[..., 2]) // 1000).astype(np.uint8)


def read_images(assoc: Association) -> Tuple[np.ndarray, np.ndarray]:
    """(depth u16, gray u8) of one association (vors_track.rs:140-145)."""
    return read_png_16bits(assoc.depth_file_path), read_gray(assoc.color_file_path)


def frame_loader(
    assocs: List[Association], *, num_threads: int = 4, max_ahead: int = 8
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """In-order (depth u16, gray u8) frames of a sequence.

    With the native library, ``num_threads`` threads decode up to
    ``max_ahead`` frames ahead (``native.PrefetchLoader``), so decoding
    overlaps the tracking of the frames before; else the frames are read one
    by one on the calling thread, with the same arrays."""
    if not assocs:
        return
    from .. import native

    loader = None
    if native.available():
        try:
            h, w = native.png_dims(assocs[0].depth_file_path)
            loader = native.PrefetchLoader(
                [a.depth_file_path for a in assocs], [a.color_file_path for a in assocs],
                h, w, num_threads=num_threads, max_ahead=max_ahead,
            )
        except IOError:  # not a PNG: the PIL path reads it
            loader = None
    if loader is not None:
        with loader:
            yield from loader
        return
    for a in assocs:
        yield read_images(a)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def write_png(path: str, image: np.ndarray) -> None:
    """Write a (H, W) uint8 or uint16 array as an 8- or 16-bit grayscale PNG,
    or a (H, W, 3) uint8 array as an 8-bit RGB PNG (colour type 2); no
    interlace, filter 0 on every row, zlib's default compression, with the
    standard library only."""
    image = np.asarray(image)
    rgb = image.ndim == 3 and image.shape[-1] == 3 and image.dtype == np.uint8
    if not rgb and (image.ndim != 2 or image.dtype not in (np.uint8, np.uint16)):
        raise ValueError(
            f"write_png takes a (H, W) uint8 or uint16 or a (H, W, 3) uint8 array, got {image.dtype} {image.shape}"
        )
    h, w = image.shape[:2]
    row_bytes = w * image.itemsize * (3 if rgb else 1)
    rows = np.zeros((h, 1 + row_bytes), np.uint8)  # a filter byte (0) per row
    rows[:, 1:] = image.astype(">u2" if image.dtype == np.uint16 else np.uint8).view(np.uint8).reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8 * image.itemsize, 2 if rgb else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", header))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_png_chunk(b"IEND", b""))


def write_sequence(directory: str, grays: np.ndarray, depths: np.ndarray, timestamps: np.ndarray) -> str:
    """Write a sequence in the TUM on-disk layout (16-bit depth and 8-bit gray
    PNGs, an associations file); returns the associations file's path."""
    os.makedirs(os.path.join(directory, "depth"), exist_ok=True)
    os.makedirs(os.path.join(directory, "rgb"), exist_ok=True)
    lines = []
    for i, ts in enumerate(timestamps):
        dpath = f"depth/{ts:.6f}.png"
        cpath = f"rgb/{ts:.6f}.png"
        write_png(os.path.join(directory, dpath), np.asarray(depths[i]).astype(np.uint16))
        write_png(os.path.join(directory, cpath), np.asarray(grays[i]).astype(np.uint8))
        lines.append(f"{ts:.6f} {dpath} {ts:.6f} {cpath}")
    assoc_path = os.path.join(directory, "associations.txt")
    with open(assoc_path, "w") as f:
        f.write("# depth_ts depth_file color_ts color_file\n")
        f.write("\n".join(lines) + "\n")
    return assoc_path
