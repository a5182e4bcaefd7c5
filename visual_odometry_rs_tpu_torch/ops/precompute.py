"""The tracker's keyframe precompute as two kernel launches.

``keyframe_levels`` launches ``csrc/precompute.cu`` (sm_90a): kernel A
computes, one thread block a 2^(L-1) x 2^(L-1) tile of level 0, the
coarse-to-fine candidate masks (or takes a given finest mask), the masked
inverse depth and its DSO-mean pyramid; kernel B, one block a (level,
lane), ranks each level's known pixels in the tracker's visit order and
writes the first ``cap`` as candidate slots with their template values and
warp Jacobians.  The JAX package computes the same with XLA operations
(``visual_odometry_rs_tpu/models/tracker.py::precompute_keyframe``).

The launcher takes CUDA tensors only.  Its plain version is
``models.tracker.precompute_keyframe_reference``;
``models.tracker.precompute_keyframe_counts`` picks between the two by the
tensors' device, with no fallback.  Every output is the plain version's bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from ..utils.types import Float
from . import build, residual

CHUNK = 128  # pixels of a chunk of a level's flat index (``tracker._EXTRACT_CHUNK``)
FIELDS = ("xs", "ys", "idepth", "valid", "tmpl_vals", "jacobians")


class _Level(ctypes.Structure):
    _fields_ = [
        ("image", ctypes.c_void_p), ("h", ctypes.c_int), ("w", ctypes.c_int), ("cap", ctypes.c_int),
        ("map_stride", ctypes.c_longlong), ("known", ctypes.c_void_p),
        ("idepth", ctypes.c_void_p), ("variance", ctypes.c_void_p), ("order", ctypes.c_void_p),
        ("xs", ctypes.c_void_p), ("ys", ctypes.c_void_p), ("z", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("tmpl", ctypes.c_void_p), ("jac", ctypes.c_void_p), ("templ", ctypes.c_void_p),
    ]


def _params_type(max_levels: int):
    class _Params(ctypes.Structure):
        _fields_ = [
            ("levels", ctypes.c_int), ("lanes", ctypes.c_int), ("depth", ctypes.c_void_p),
            ("finest_mask", ctypes.c_void_p), ("src_lane", ctypes.c_void_p), ("dst_lane", ctypes.c_void_p),
            ("scale", ctypes.c_float), ("variance", ctypes.c_float), ("threshold", ctypes.c_float),
            ("intrinsics", ctypes.c_void_p), ("counts", ctypes.c_void_p), ("lv", _Level * max_levels),
        ]

    return _Params


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("precompute")
    lib.vors_precompute_params_size.restype = ctypes.c_int
    lib.vors_precompute_max_levels.restype = ctypes.c_int
    max_levels = lib.vors_precompute_max_levels()
    params = _params_type(max_levels)
    if lib.vors_precompute_params_size() != ctypes.sizeof(params):
        raise RuntimeError("csrc/precompute.cu and ops/precompute.py disagree on the parameter layout")
    lib.vors_precompute_keyframe.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.vors_precompute_keyframe.restype = ctypes.c_int
    return lib, params, max_levels


def _check_level_shapes(images: Sequence[torch.Tensor], depth: torch.Tensor) -> None:
    """The pyramid halves level by level (``ops.pyramid.mean_pyramid``) from
    the depth map's size."""
    h, w = depth.shape[-2:]
    for lvl, img in enumerate(images):
        if tuple(img.shape[-2:]) != (h, w):
            raise ValueError(f"pyramid level {lvl} is {tuple(img.shape[-2:])}, expected {(h, w)}")
        h, w = h // 2, w // 2


def keyframe_levels(
    images: Sequence[torch.Tensor],
    depth: torch.Tensor,
    intrinsics: torch.Tensor,
    caps: Sequence[int],
    *,
    scale: float,
    variance: float,
    threshold: float,
    finest_mask: torch.Tensor | None = None,
    lanes: torch.Tensor | None = None,
    into: Sequence[Tuple[torch.Tensor, ...]] | None = None,
):
    """The per-level candidates of a keyframe precompute, in two launches.

    ``images`` are the u8 pyramid levels, (B, h, w) or (h, w), ``depth`` the
    int32 depth map (B, H, W) or (H, W), ``intrinsics`` the (L, 5) f32
    ``[cx cy fx fy skew]`` of each level, all on one CUDA device; ``caps``
    the slots of each level.  ``scale``, ``variance`` and ``threshold`` are
    the config's ``depth_scale``, ``idepth_variance`` and
    ``candidates_diff_threshold``.  ``finest_mask`` (K, H, W) bool replaces
    the coarse-to-fine selection.

    Without ``lanes`` every lane is computed and the result is a list of
    per-level tuples ``(xs, ys, idepth, valid, tmpl_vals, jacobians)`` with
    the lane axis of the inputs, and the valid slots of each level, (…, L)
    int32 on the device.  ``lanes``, a (K,) int64 device tensor, computes
    lane ``lanes[k]`` of the inputs as the k-th lane (and of
    ``finest_mask``'s k-th lane); with ``into``, per level the tuple
    ``(xs, ys, idepth, valid, tmpl_vals, jacobians, template)`` of (D, …)
    tensors, lane ``lanes[k]`` is written into row ``lanes[k]`` of each,
    the level's image included, in place, and only the counts are
    returned.  ``keyframe_levels.launches`` counts launches.
    """
    device = depth.device
    if device.type != "cuda":
        raise ValueError(f"the precompute kernels need CUDA tensors, got {device}")
    lib, params_type, max_levels = _library()
    nb_levels = len(images)
    if not 1 <= nb_levels <= max_levels:
        raise ValueError(f"the precompute kernels take 1 to {max_levels} levels, got {nb_levels}")
    batched = depth.dim() == 3
    if depth.dim() not in (2, 3):
        raise ValueError(f"depth must be ([B,] H, W), got {tuple(depth.shape)}")
    residual.check_tensor("depth", depth, device, torch.int32, depth.shape)
    _check_level_shapes(images, depth)
    nb_src = depth.shape[0] if batched else 1
    for lvl, img in enumerate(images):
        residual.check_tensor(f"pyramid level {lvl}", img, device, torch.uint8, (*depth.shape[:-2], *img.shape[-2:]))
    residual.check_tensor("intrinsics", intrinsics, device, Float, (nb_levels, 5))
    if len(caps) < nb_levels:
        raise ValueError(f"{len(caps)} level caps for {nb_levels} levels")
    if lanes is not None:
        if not batched:
            raise ValueError("lanes needs a lane axis: depth (B, H, W)")
        residual.check_tensor("lanes", lanes, device, torch.int64, (lanes.shape[0],))
        nb = lanes.shape[0]
    else:
        if into is not None:
            raise ValueError("into needs lanes")
        nb = nb_src
    lead = (nb,) if batched else ()
    if finest_mask is not None:
        residual.check_tensor("finest_mask", finest_mask, device, torch.bool, (*lead, *depth.shape[-2:]))

    p = params_type()
    p.levels, p.lanes = nb_levels, nb
    p.depth = depth.data_ptr()
    p.finest_mask = None if finest_mask is None else finest_mask.data_ptr()
    p.src_lane = None if lanes is None else lanes.data_ptr()
    p.dst_lane = None if into is None else lanes.data_ptr()  # without into, lane k is row k of the result
    p.scale, p.variance, p.threshold = scale, variance, threshold
    p.intrinsics = intrinsics.data_ptr()

    # scratch: each lane's maps padded to whole chunks, so chunk loads stay inside
    strides = [-(-img.shape[-2] * img.shape[-1] // CHUNK) * CHUNK for img in images]
    caps = [int(c) for c in caps[:nb_levels]]
    known = torch.empty(nb * sum(strides), dtype=torch.uint8, device=device)
    maps = torch.empty((2, nb * sum(strides)), dtype=Float, device=device)  # idepth, variance
    order = torch.empty(nb * sum(caps), dtype=torch.int32, device=device)
    counts = torch.empty((*lead, nb_levels), dtype=torch.int32, device=device)
    p.counts = counts.data_ptr()

    outs: List[Tuple[torch.Tensor, ...]] = []
    map_at = cap_at = 0
    for lvl, (img, stride, cap) in enumerate(zip(images, strides, caps)):
        if into is None:
            level = (
                *(torch.empty((*lead, cap), dtype=Float, device=device) for _ in range(3)),
                torch.empty((*lead, cap), dtype=torch.bool, device=device),
                torch.empty((*lead, cap), dtype=Float, device=device),
                torch.empty((*lead, cap, 6), dtype=Float, device=device),
            )
            outs.append(level)
            template = None
        else:
            *level, template = into[lvl]
            rows = template.shape[0]
            for name, t, dtype, shape in zip(
                (*FIELDS, "template"), (*level, template),
                (Float, Float, Float, torch.bool, Float, Float, torch.uint8),
                ((rows, cap),) * 5 + ((rows, cap, 6), (rows, *img.shape[-2:])),
            ):
                residual.check_tensor(f"into level {lvl} {name}", t, device, dtype, shape)
        lv = p.lv[lvl]
        lv.image = img.data_ptr()
        lv.h, lv.w = img.shape[-2:]
        lv.cap = cap
        lv.map_stride = stride
        lv.known = known.data_ptr() + nb * map_at
        lv.idepth = maps[0].data_ptr() + 4 * nb * map_at
        lv.variance = maps[1].data_ptr() + 4 * nb * map_at
        lv.order = order.data_ptr() + 4 * nb * cap_at
        lv.xs, lv.ys, lv.z, lv.valid, lv.tmpl, lv.jac = (t.data_ptr() for t in level)
        lv.templ = None if template is None else template.data_ptr()
        map_at += stride
        cap_at += cap
    if nb > 0:
        with residual.on_device(device):
            err = lib.vors_precompute_keyframe(ctypes.addressof(p), torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"keyframe precompute kernel launch failed: CUDA error {err}")
        with residual.COUNT_LOCK:
            keyframe_levels.launches += 2
    return counts if into is not None else (outs, counts)


keyframe_levels.launches = 0
