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

Two tracker options are instantiations of the same kernel, with the same
plain twin: ``robust_delta > 0`` (Huber IRLS weights, the JAX package's
``_eval_full(robust_delta=...)``) and ``ab`` (the affine brightness model's
gain and bias, a (2,) tensor: ``_eval_full_brightness``, 8 parameters, so
``m`` is (8, 9)).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from ..core import camera
from ..math.pose import Pose
from ..utils.types import Float
from . import build, interp

OUT_SIZE = 44  # [H | g] (6, 7), sum r^2, inside count
OUT_SIZE_BRIGHTNESS = 74  # [H | g] (8, 9), sum r^2, inside count
_THREADS = 256  # threads of a block (csrc/residual_eval.cuh)
_CACHED = 4  # candidates a thread keeps in registers
_MAX_CLUSTER = 8
# the launch counts: the threads of a lane mesh (parallel.mesh) launch at once
COUNT_LOCK = threading.Lock()


def residuals(image, xs, ys, idepth, tmpl_vals, valid, model: Pose, k: camera.Intrinsics, ab=None):
    """Warp, sample and residual pass (lm_optimizer.rs:68-87): ``(r, inside)``
    with ``r = I(warp(x)) - T`` on the inside points and 0 elsewhere; with
    the brightness ``ab = (a, b)``, ``r = I(warp(x)) - (a T + b)``."""
    u, v = camera.warp(model, xs, ys, idepth, k)
    vals, in_img = interp.bilinear(image, u, v)
    inside = in_img & valid
    pred = tmpl_vals if ab is None else ab[0] * tmpl_vals + ab[1]
    return torch.where(inside, vals - pred, torch.zeros_like(vals)), inside


def huber_weights(r: torch.Tensor, robust_delta: float) -> torch.Tensor:
    """IRLS weights ``|r| <= delta ? 1 : delta / max(|r|, 1e-12)``."""
    absr = torch.abs(r)
    return torch.where(absr <= robust_delta, torch.ones_like(r),
                       torch.full_like(r, robust_delta) / torch.clamp(absr, min=1e-12))


def residual_reduce_reference(image, xs, ys, idepth, tmpl_vals, valid, jacobians, params,
                              *, robust_delta: float = 0.0, ab=None):
    """Plain torch twin of the kernel: ``(m, sum w r^2, count)``, ``m`` the
    (6, 7) ``[H | g]``, or (8, 9) with the brightness columns ``[T | 1]``
    when ``ab`` is given.  Huber weights multiply each inside candidate's
    Jacobian row first and its ``r^2`` as ``(w r) r``, the JAX package's
    order; the count stays unweighted."""
    model = Pose(params[0:4], params[4:7])
    k = camera.Intrinsics(*params[7:12].unbind())
    r, inside = residuals(image, xs, ys, idepth, tmpl_vals, valid, model, k, ab)
    maskf = inside.to(Float)
    rsq_terms = r * r
    if robust_delta > 0.0:
        w = huber_weights(r, robust_delta)
        maskf = maskf * w
        rsq_terms = w * r * r
    if ab is not None:
        jacobians = torch.cat([jacobians, tmpl_vals[:, None], torch.ones_like(tmpl_vals)[:, None]], dim=1)
    jm = jacobians * maskf[:, None]
    rhs = torch.cat([jacobians, r[:, None]], dim=1)
    return jm.T @ rhs, torch.sum(rsq_terms), torch.sum(inside.to(Float))


def variant(robust_delta: float, brightness: bool) -> str:
    """Name of the kernel instantiation for the options."""
    if brightness:
        return "huber+brightness" if robust_delta > 0.0 else "brightness"
    return "huber" if robust_delta > 0.0 else "plain"


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


def level_pointers(image, xs, ys, idepth, tmpl_vals, valid, jacobians, *, lanes: bool = False,
                   image_lanes: bool = True):
    """Checks the tensors of one level (all on ``image``'s CUDA device) and
    returns the kernels' leading arguments: the image pointer, height, width,
    the six candidate pointers and the candidate count.  With ``lanes`` the
    tensors may carry a leading lane axis, image (B, H, W) and candidates
    (B, N, …), laid out lane after lane; without ``image_lanes`` the image
    array's leading size need not be the lane count (the lanes index it)."""
    device = image.device
    if device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {device}")
    if image.dim() not in ((2, 3) if lanes else (2,)):
        raise ValueError(f"image must be {'([B,] H, W)' if lanes else '(H, W)'}, got {tuple(image.shape)}")
    lead = tuple(xs.shape[:-1]) if lanes else ()
    if image_lanes and tuple(image.shape[:-2]) != lead:
        raise ValueError(f"image lanes {tuple(image.shape[:-2])} and candidate lanes {lead} differ")
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
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vors_residual_reduce.argtypes = [p, i, i, p, p, p, p, p, p, i, p, p, f, p, i, p]
    lib.vors_residual_reduce.restype = ctypes.c_int
    lib.vors_residual_reduce_resources.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.vors_residual_reduce_resources.restype = ctypes.c_int
    return lib


def kernel_resources(lib, fn_name: str, brightness: bool, robust: bool):
    """``(registers, local bytes)`` a thread of one instantiation uses
    (``cudaFuncGetAttributes``); local bytes above 0 mean spills."""
    regs = (ctypes.c_int * 2)()
    err = getattr(lib, fn_name)(int(brightness), int(robust), regs)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    return regs[0], regs[1]


def resources(brightness: bool = False, robust: bool = False):
    """Registers and local bytes of the ``residual_reduce`` instantiation."""
    return kernel_resources(_library(), "vors_residual_reduce_resources", brightness, robust)


def residual_reduce(image, xs, ys, idepth, tmpl_vals, valid, jacobians, params, out=None,
                    *, robust_delta: float = 0.0, ab=None):
    """One LM evaluation: ``(m = [H | g], sum w r^2, inside count)``, ``m``
    (6, 7), or (8, 9) when the brightness ``ab`` (a (2,) tensor) is given.

    CPU tensors take the plain twin; CUDA tensors launch the kernel, once.
    ``out`` is an optional f32 tensor on the device of 44 floats (74 with
    ``ab``) that receives the result (the returned tensors are views of
    it), so that a caller in a loop allocates nothing per call.
    ``robust_delta > 0`` turns on the Huber weights.
    ``residual_reduce.launches`` counts kernel launches, and
    ``residual_reduce.variant_launches`` the same by instantiation.
    """
    device = image.device
    if device.type == "cpu":
        return residual_reduce_reference(
            image, xs, ys, idepth, tmpl_vals, valid, jacobians, params, robust_delta=robust_delta, ab=ab
        )
    level = level_pointers(image, xs, ys, idepth, tmpl_vals, valid, jacobians)
    check_tensor("params", params, device, Float, (12,))
    np_ = 6 if ab is None else 8
    size = OUT_SIZE if ab is None else OUT_SIZE_BRIGHTNESS
    if ab is not None:
        check_tensor("ab", ab, device, Float, (2,))
    if out is None:
        out = torch.empty((size,), dtype=Float, device=device)
    else:
        check_tensor("out", out, device, Float, (size,))
    lib = _library()
    with on_device(device):
        err = lib.vors_residual_reduce(
            *level, params.data_ptr(), None if ab is None else ab.data_ptr(), float(robust_delta),
            out.data_ptr(), cluster_size(level[-1]), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"residual_reduce kernel launch failed: CUDA error {err}")
    name = variant(robust_delta, ab is not None)
    with COUNT_LOCK:
        residual_reduce.launches += 1
        residual_reduce.variant_launches[name] = residual_reduce.variant_launches.get(name, 0) + 1
    nm = np_ * (np_ + 1)
    return out[:nm].view(np_, np_ + 1), out[nm], out[nm + 1]


residual_reduce.launches = 0
residual_reduce.variant_launches = {}
