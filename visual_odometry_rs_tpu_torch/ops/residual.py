"""The fused LM evaluation of one pyramid level: CUDA kernel and plain twin.

``residual_reduce`` is the port of the Pallas TPU kernel
``visual_odometry_rs_tpu/ops/pallas/residual_kernel.py::fused_residual_reduce``.
It warps the candidates by the pose, samples the current image bilinearly,
forms residuals and reduces the masked normal equations, returning
``(m (6,7) = [H | g], sum r^2, inside count)``.

- On CUDA tensors it launches the hand-written kernel
  ``csrc/residual_reduce.cu`` (sm_90a), built with ``nvcc`` at first use into
  ``_build/`` (keyed on a hash of the source and flags) and bound with
  ctypes.  There is no fallback: a CUDA tensor launches the kernel or raises.
- On CPU tensors it runs ``residual_reduce_reference``, the same function in
  plain torch (``camera.warp``, ``interp.bilinear``, a masked product).

``params`` is the 12-float tensor ``[qw qx qy qz tx ty tz cx cy fx fy skew]``
on the tensors' device, so a launch never reads the pose on the host.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..core import camera
from ..math.pose import Pose
from ..utils.types import Float
from . import interp

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE_DIR / "csrc" / "residual_reduce.cu"
BUILD_DIR = _PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_N_SUMS = 29
_N_OUT = 44


def residuals(image, xs, ys, idepth, tmpl_vals, valid, model: Pose, k: camera.Intrinsics):
    """Warp, sample and residual pass (lm_optimizer.rs:68-87): ``(r, inside)``
    with ``r = I(warp(x)) - T`` on the inside points and 0 elsewhere."""
    u, v = camera.warp(model, xs, ys, idepth, k)
    vals, in_img = interp.bilinear(image, u, v)
    inside = in_img & valid
    return torch.where(inside, vals - tmpl_vals, torch.zeros_like(vals)), inside


def residual_reduce_reference(image, xs, ys, idepth, tmpl_vals, valid, jacobians, params):
    """Plain torch twin of the kernel: ``(m (6,7), sum r^2, count)``."""
    model = Pose(params[0:4], params[4:7])
    k = camera.Intrinsics(*params[7:12].unbind())
    r, inside = residuals(image, xs, ys, idepth, tmpl_vals, valid, model, k)
    maskf = inside.to(Float)
    jm = jacobians * maskf[:, None]
    rhs = torch.cat([jacobians, r[:, None]], dim=1)
    return jm.T @ rhs, torch.sum(r * r), torch.sum(maskf)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernel")


def build_library() -> tuple[Path, float, str]:
    """Build the kernel library if it is not built yet.

    Returns ``(path, build seconds, compiler output)``; seconds is 0 and the
    output empty when the library for this source and these flags exists.
    """
    source = SOURCE.read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"residual_reduce_{key}.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    start = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path, time.perf_counter() - start, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()[0]))
    lib.vors_residual_num_blocks.argtypes = [ctypes.c_int]
    lib.vors_residual_num_blocks.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vors_residual_reduce.argtypes = [p, i, i, p, p, p, p, p, p, i, p, p, p, p]
    lib.vors_residual_reduce.restype = ctypes.c_int
    return lib


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def residual_reduce(image, xs, ys, idepth, tmpl_vals, valid, jacobians, params):
    """One LM evaluation: ``(m (6,7) = [H | g], sum r^2, inside count)``.

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    ``residual_reduce.launches`` counts kernel launches.
    """
    device = image.device
    if device.type == "cpu":
        return residual_reduce_reference(image, xs, ys, idepth, tmpl_vals, valid, jacobians, params)
    if device.type != "cuda":
        raise ValueError(f"residual_reduce: unsupported device {device}")
    n = xs.shape[0]
    if image.dim() != 2:
        raise ValueError(f"image must be (H, W), got {tuple(image.shape)}")
    _check("image", image, device, torch.uint8, tuple(image.shape))
    for name, t in (("xs", xs), ("ys", ys), ("idepth", idepth), ("tmpl_vals", tmpl_vals)):
        _check(name, t, device, Float, (n,))
    _check("valid", valid, device, torch.bool, (n,))
    _check("jacobians", jacobians, device, Float, (n, 6))
    _check("params", params, device, Float, (12,))

    lib = _library()
    num_blocks = lib.vors_residual_num_blocks(n)
    partials = torch.empty((max(1, num_blocks), _N_SUMS), dtype=Float, device=device)
    out = torch.empty((_N_OUT,), dtype=Float, device=device)
    height, width = image.shape
    with torch.cuda.device(device):
        err = lib.vors_residual_reduce(
            image.data_ptr(), height, width, xs.data_ptr(), ys.data_ptr(),
            idepth.data_ptr(), tmpl_vals.data_ptr(), valid.data_ptr(),
            jacobians.data_ptr(), n, params.data_ptr(), partials.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"residual_reduce kernel launch failed: CUDA error {err}")
    residual_reduce.launches += 1
    return out[:42].view(6, 7), out[42], out[43]


residual_reduce.launches = 0
