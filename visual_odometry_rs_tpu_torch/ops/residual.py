"""The fused LM evaluation of one pyramid level: CUDA kernel and plain twin.

``residual_reduce`` is the port of the Pallas TPU kernel
``visual_odometry_rs_tpu/ops/pallas/residual_kernel.py::fused_residual_reduce``.
It warps the candidates by the pose, samples the current image bilinearly,
forms residuals and reduces the masked normal equations, returning
``(m (6,7) = [H | g], sum r^2, inside count)``.

- On CUDA tensors it launches the hand-written kernel
  ``csrc/residual_reduce.cu`` (sm_90a; one launch, a thread block cluster
  sums across its blocks), built by ``ops.build`` at first use and bound
  with ctypes.  There is no fallback: a CUDA tensor launches the kernel or
  raises.  Its device functions (``csrc/residual_eval.cuh``) are the ones
  the per-level LM solver ``ops.lm_solve`` runs.
- On CPU tensors it runs ``residual_reduce_reference``, the same function in
  plain torch (``camera.warp``, ``interp.bilinear``, a masked product).

``params`` is the 12-float tensor ``[qw qx qy qz tx ty tz cx cy fx fy skew]``
on the tensors' device, so a launch never reads the pose on the host.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..core import camera
from ..math.pose import Pose
from ..utils.types import Float
from . import build, interp

OUT_SIZE = 44  # [H | g] (6, 7), sum r^2, inside count
_THREADS = 256  # threads of a block (csrc/residual_eval.cuh)
_CACHED = 4  # candidates a thread keeps in registers
_MAX_CLUSTER = 8


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


def cluster_size(n: int) -> int:
    """Blocks in the cluster that works on ``n`` candidates: the smallest of
    1, 2, 4, 8 whose threads keep all candidates in registers, else 8."""
    size = 1
    while size < _MAX_CLUSTER and size * _THREADS * _CACHED < n:
        size *= 2
    return size


def check_tensor(name, t, device, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def level_pointers(image, xs, ys, idepth, tmpl_vals, valid, jacobians, *, lanes: bool = False):
    """Checks the tensors of one level (all on ``image``'s CUDA device) and
    returns the kernels' leading arguments: the image pointer, height, width,
    the six candidate pointers and the candidate count.  With ``lanes`` the
    tensors may carry a leading lane axis, image (B, H, W) and candidates
    (B, N, …), laid out lane after lane."""
    device = image.device
    if device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {device}")
    if image.dim() not in ((2, 3) if lanes else (2,)):
        raise ValueError(f"image must be {'([B,] H, W)' if lanes else '(H, W)'}, got {tuple(image.shape)}")
    lead = tuple(image.shape[:-2])
    n = xs.shape[-1]
    check_tensor("image", image, device, torch.uint8, image.shape)
    for name, t in (("xs", xs), ("ys", ys), ("idepth", idepth), ("tmpl_vals", tmpl_vals)):
        check_tensor(name, t, device, Float, (*lead, n))
    check_tensor("valid", valid, device, torch.bool, (*lead, n))
    check_tensor("jacobians", jacobians, device, Float, (*lead, n, 6))
    height, width = image.shape[-2:]
    return (
        image.data_ptr(), height, width, xs.data_ptr(), ys.data_ptr(), idepth.data_ptr(),
        tmpl_vals.data_ptr(), valid.data_ptr(), jacobians.data_ptr(), n,
    )


def on_device(device):
    """Context in which a launch goes to ``device``: entered only when it is
    not the current device already."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("residual_reduce")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vors_residual_reduce.argtypes = [p, i, i, p, p, p, p, p, p, i, p, p, i, p]
    lib.vors_residual_reduce.restype = ctypes.c_int
    return lib


def residual_reduce(image, xs, ys, idepth, tmpl_vals, valid, jacobians, params, out=None):
    """One LM evaluation: ``(m (6,7) = [H | g], sum r^2, inside count)``.

    CPU tensors take the plain twin; CUDA tensors launch the kernel, once.
    ``out`` is an optional (44,) f32 tensor on the device that receives the
    result (the returned tensors are views of it), so that a caller in a loop
    allocates nothing per call.  ``residual_reduce.launches`` counts kernel
    launches.
    """
    device = image.device
    if device.type == "cpu":
        return residual_reduce_reference(image, xs, ys, idepth, tmpl_vals, valid, jacobians, params)
    level = level_pointers(image, xs, ys, idepth, tmpl_vals, valid, jacobians)
    check_tensor("params", params, device, Float, (12,))
    if out is None:
        out = torch.empty((OUT_SIZE,), dtype=Float, device=device)
    else:
        check_tensor("out", out, device, Float, (OUT_SIZE,))
    lib = _library()
    with on_device(device):
        err = lib.vors_residual_reduce(
            *level, params.data_ptr(), out.data_ptr(), cluster_size(level[-1]),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"residual_reduce kernel launch failed: CUDA error {err}")
    residual_reduce.launches += 1
    return out[:42].view(6, 7), out[42], out[43]


residual_reduce.launches = 0
