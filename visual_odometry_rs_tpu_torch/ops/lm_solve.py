"""The LM solve of one pyramid level as ONE kernel launch.

``lm_solve_level`` launches ``csrc/lm_solve.cu`` (sm_90a): evaluation,
reduction, damped 6x6 Cholesky solve, se3 exp, inverse-compositional update,
finiteness check and the accept/reject rule all run on the device, where the
JAX package compiles the same loop with ``lax.while_loop``
(``visual_odometry_rs_tpu/models/tracker.py::solve_level``).  The evaluation
inside it is the port of the Pallas TPU kernel
``visual_odometry_rs_tpu/ops/pallas/residual_kernel.py::_kernel``, shared with
``ops.residual.residual_reduce`` through ``csrc/residual_eval.cuh``.

The launcher takes CUDA tensors only.  Its plain version is the Python loop
``models.tracker.solve_level_reference``; ``models.tracker.solve_level``
picks between the two by the tensors' device, with no fallback.

The start state comes from a 10-float device tensor ``state_in`` (quaternion
wxyz, translation, failed-so-far flag, brightness gain and bias) and the
result goes to a 128-float device record, whose first 10 floats are the
next level's ``state_in``.  With a leading lane axis (image (B, H, W),
candidates (B, N, …), state (B, 10), record (B, 128)) one launch solves the
level of every lane, one thread block cluster per lane:

========== ===================================================================
``[0:7]``    pose handed on: the accepted pose, or the input pose if this or
             an earlier level failed
``[7]``      1.0 if this or an earlier level failed
``[8:10]``   brightness ``(a, b)`` handed on, frozen with the pose (passed
             through by the 6-parameter solve)
``[10:17]``  accepted pose of this solve; ``[17:19]`` its ``(a, b)``
``[19]``     its energy; ``[20]`` lambda; ``[21]`` nb_iter; ``[22]`` number
             of evaluations; ``[23]`` 1.0 if this solve failed
``[24:66]``  ``[H | g]`` at the accepted state, (6, 7) row-major; with the
             brightness model ``[24:96]``, (8, 9)
``[96]``     mean optical flow of the ``flow_of`` candidates under the pose
             handed on (0 when no ``flow_of`` is given)
``[97:100]`` with ``detector``: the plain energy of the level's candidates
             under the pose handed on (the lost-frame detector, the JAX
             package's ``_eval_energy``), its inside count and the valid
             count
``[100:105]`` clock cycles seen by one thread: loading the candidates; summed
             over the evaluations, the candidates' sums, the reduction and
             the scalar step; the whole kernel
========== ===================================================================

The options are instantiations of the one kernel: ``robust_delta > 0``
(Huber weights) and ``brightness`` (the 8-parameter solve over the pose and
``(a, b)``).  ``image_index`` (B,) int32 makes lane b read image
``image_index[b]`` of the image array, and ``active`` (B,) bool turns the
lanes whose flag is False into pass-throughs that return at once: the
relocalization solves of ``models.relocalize`` and
``parallel.batch._recover_lost`` run through them with no host read.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.types import Float
from . import build, residual

RECORD_SIZE = 128
STATE_SIZE = 10
FAILED_SO_FAR = 7
AB_HANDED_ON = slice(8, 10)
POSE = slice(10, 17)
AB = slice(17, 19)
ENERGY, LM_COEF, NB_ITER, NB_EVALS, FAILED = 19, 20, 21, 22, 23
NORMAL_EQUATIONS = slice(24, 66)  # (6, 7)
NORMAL_EQUATIONS_BRIGHTNESS = slice(24, 96)  # (8, 9)
FLOW = 96
DETECTOR = slice(97, 100)  # plain energy, inside count, valid count
PHASE_CYCLES = slice(100, 105)  # load, sums, reduce, scalar step, whole kernel


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("lm_solve")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vors_lm_solve_level.argtypes = [
        p, i, i, p, p, p, p, p, p, i, p, p, i, f, i, f, f, i, p, p, p, p, p, i, i, p, p, p, i, i, p,
    ]
    lib.vors_lm_solve_level.restype = ctypes.c_int
    lib.vors_lm_record_size.restype = ctypes.c_int
    lib.vors_lm_state_size.restype = ctypes.c_int
    lib.vors_lm_max_active_clusters.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.vors_lm_max_active_clusters.restype = ctypes.c_int
    lib.vors_lm_solve_resources.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.vors_lm_solve_resources.restype = ctypes.c_int
    if lib.vors_lm_record_size() != RECORD_SIZE or lib.vors_lm_state_size() != STATE_SIZE:
        raise RuntimeError("csrc/lm_solve.cu and ops/lm_solve.py disagree on the record layout")
    return lib


def _check_state(state_in, lead, device) -> int:
    """``state_in`` is (…lead, 10) f32 on ``device`` with contiguous rows, as
    the first 10 floats of each lane's record of the level before; returns
    the floats from one lane's state to the next."""
    if state_in.device != device or state_in.dtype != Float:
        raise ValueError(f"state_in must be f32 on {device}, got {state_in.dtype} on {state_in.device}")
    if tuple(state_in.shape) != (*lead, STATE_SIZE) or state_in.stride(-1) != 1:
        raise ValueError(f"state_in must be {(*lead, STATE_SIZE)} with contiguous rows, got "
                         f"{tuple(state_in.shape)} strides {state_in.stride()}")
    return state_in.stride(0) if lead else STATE_SIZE


def lm_solve_level(
    image, xs, ys, idepth, tmpl_vals, valid, jacobians, intrinsics, state_in, record,
    *, lm_coef_init: float, max_iterations: int, energy_tol: float, flow_of=None,
    robust_delta: float = 0.0, brightness: bool = False, detector: bool = False,
    image_index=None, active=None, cluster: int | None = None,
):
    """Solve one level on the device, in one launch; returns ``record``.

    ``intrinsics`` is the (5,) tensor ``[cx cy fx fy skew]``, ``state_in`` a
    (10,) and ``record`` a (128,) f32 tensor, all on the CUDA device of
    ``image``.  With a lane axis, the candidates (B, N) and (B, N, 6),
    ``state_in`` (B, 10) with contiguous rows and ``record`` (B, 128): the
    launch is B clusters, one per lane, and ``image`` is (B, H, W), or (M,
    H, W) with ``image_index`` a (B,) int32 tensor of values in [0, M).
    ``active``, a (B,) bool tensor, leaves the lanes whose flag is False
    unsolved: their record passes their state through.  ``cluster`` (1, 2,
    4 or 8 blocks a lane) defaults to ``residual.cluster_size(n)``.
    ``flow_of``, if given, is ``(xs, ys, idepth, valid, intrinsics)`` of the
    level whose mean optical flow under the pose handed on the launch also
    computes (the tracker's keyframe criterion,
    inverse_compositional.rs:211-222), with the same lane axis.
    ``detector`` also writes the lost-frame detector's plain energy and
    counts.  ``robust_delta > 0`` weights the evaluation with Huber weights;
    ``brightness`` solves for the pose and the affine brightness ``(a, b)``
    (the 8-parameter instantiation).  Nothing is read on the host.
    ``lm_solve_level.launches`` counts kernel launches, one for all lanes,
    and ``lm_solve_level.variant_launches`` the same by instantiation.
    """
    device = image.device
    lead = tuple(xs.shape[:-1])
    level = residual.level_pointers(image, xs, ys, idepth, tmpl_vals, valid, jacobians, lanes=True,
                                    image_lanes=image_index is None)
    if image_index is not None:
        if len(lead) != 1 or image.dim() != 3:
            raise ValueError("image_index needs a lane axis: candidates (B, N) and images (M, H, W)")
        residual.check_tensor("image_index", image_index, device, torch.int32, lead)
    residual.check_tensor("intrinsics", intrinsics, device, Float, (5,))
    state_stride = _check_state(state_in, lead, device)
    residual.check_tensor("record", record, device, Float, (*lead, RECORD_SIZE))
    if active is not None:
        if len(lead) != 1:
            raise ValueError("active needs a lane axis")
        residual.check_tensor("active", active, device, torch.bool, lead)
    if cluster is None:
        cluster = residual.cluster_size(level[-1])
    flow_args = (None, None, None, None, None, 0)
    if flow_of is not None:
        f_xs, f_ys, f_idepth, f_valid, f_intrinsics = flow_of
        m = f_xs.shape[-1]
        for name, t in (("flow xs", f_xs), ("flow ys", f_ys), ("flow idepth", f_idepth)):
            residual.check_tensor(name, t, device, Float, (*lead, m))
        residual.check_tensor("flow valid", f_valid, device, torch.bool, (*lead, m))
        residual.check_tensor("flow intrinsics", f_intrinsics, device, Float, (5,))
        flow_args = (*(t.data_ptr() for t in flow_of), m)
    lib = _library()
    with residual.on_device(device):
        err = lib.vors_lm_solve_level(
            *level, intrinsics.data_ptr(), state_in.data_ptr(), state_stride, lm_coef_init,
            max_iterations, energy_tol, float(robust_delta), int(brightness), *flow_args,
            int(detector), None if image_index is None else image_index.data_ptr(),
            None if active is None else active.data_ptr(), record.data_ptr(), cluster,
            lead[0] if lead else 1, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lm_solve_level kernel launch failed: CUDA error {err}")
    name = residual.variant(robust_delta, brightness)
    with residual.COUNT_LOCK:
        lm_solve_level.launches += 1
        lm_solve_level.variant_launches[name] = lm_solve_level.variant_launches.get(name, 0) + 1
    return record


lm_solve_level.launches = 0
lm_solve_level.variant_launches = {}


def resources(brightness: bool = False, robust: bool = False):
    """Registers and local (spilled) bytes a thread of the solver
    instantiation for the options uses (``cudaFuncGetAttributes``)."""
    return residual.kernel_resources(_library(), "vors_lm_solve_resources", brightness, robust)


def max_active_clusters(cluster: int, brightness: bool = False, robust: bool = False) -> int:
    """How many clusters of ``cluster`` blocks of the solver instantiation
    for the options the current card runs at once
    (``cudaOccupancyMaxActiveClusters``): lanes beyond that wait for a free
    slot."""
    count = ctypes.c_int(0)
    err = _library().vors_lm_max_active_clusters(cluster, int(brightness), int(robust), ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {err}")
    return count.value
