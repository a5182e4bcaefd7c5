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

The start pose comes from an 8-float device tensor ``state_in`` (quaternion
wxyz, translation, failed-so-far flag) and the result goes to a 72-float
device record, whose first 8 floats are the next level's ``state_in``.
With a leading lane axis (image (B, H, W), candidates (B, N, …), state
(B, 8), record (B, 72)) one launch solves the level of every lane, one
thread block cluster per lane:

======== =====================================================================
``[0:7]``  pose handed on: the accepted pose, or the input pose if this or an
           earlier level failed
``[7]``    1.0 if this or an earlier level failed
``[8:15]`` accepted pose of this solve
``[15]``   its energy; ``[16]`` lambda; ``[17]`` nb_iter; ``[18]`` number of
           evaluations; ``[19]`` 1.0 if this solve failed
``[20:62]`` ``[H | g]`` at the accepted pose, (6, 7) row-major
``[62]``   mean optical flow of the ``flow_of`` candidates under the pose
           handed on (0 when no ``flow_of`` is given)
``[64:69]`` clock cycles seen by one thread: loading the candidates; summed
           over the evaluations, the candidates' sums, the reduction and the
           scalar step; the whole kernel
======== =====================================================================
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.types import Float
from . import build, residual

RECORD_SIZE = 72
STATE_SIZE = 8
FAILED_SO_FAR = 7
POSE = slice(8, 15)
ENERGY, LM_COEF, NB_ITER, NB_EVALS, FAILED = 15, 16, 17, 18, 19
NORMAL_EQUATIONS = slice(20, 62)
FLOW = 62
PHASE_CYCLES = slice(64, 69)  # load, sums, reduce, scalar step, whole kernel


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("lm_solve")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vors_lm_solve_level.argtypes = [
        p, i, i, p, p, p, p, p, p, i, p, p, i, f, i, f, p, p, p, p, p, i, p, i, i, p,
    ]
    lib.vors_lm_solve_level.restype = ctypes.c_int
    lib.vors_lm_record_size.restype = ctypes.c_int
    lib.vors_lm_max_active_clusters.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.vors_lm_max_active_clusters.restype = ctypes.c_int
    if lib.vors_lm_record_size() != RECORD_SIZE:
        raise RuntimeError("csrc/lm_solve.cu and ops/lm_solve.py disagree on the record size")
    return lib


def _check_state(state_in, lead, device) -> int:
    """``state_in`` is (…lead, 8) f32 on ``device`` with contiguous rows, as
    the first 8 floats of each lane's record of the level before; returns
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
    cluster: int | None = None,
):
    """Solve one level on the device, in one launch; returns ``record``.

    ``intrinsics`` is the (5,) tensor ``[cx cy fx fy skew]``, ``state_in`` an
    (8,) and ``record`` a (72,) f32 tensor, all on the CUDA device of
    ``image``.  With a lane axis, ``image`` (B, H, W), the candidates (B, N)
    and (B, N, 6), ``state_in`` (B, 8) with contiguous rows and ``record``
    (B, 72): the launch is B clusters, one per lane.  ``cluster`` (1, 2, 4
    or 8 blocks a lane) defaults to ``residual.cluster_size(n)``.
    ``flow_of``, if given, is ``(xs, ys, idepth, valid, intrinsics)`` of the
    level whose mean optical flow under the pose handed on the launch also
    computes (the tracker's keyframe criterion,
    inverse_compositional.rs:211-222), with the same lane axis.  Nothing is
    read on the host.  ``lm_solve_level.launches`` counts kernel launches,
    one for all lanes.
    """
    device = image.device
    level = residual.level_pointers(image, xs, ys, idepth, tmpl_vals, valid, jacobians, lanes=True)
    lead = tuple(image.shape[:-2])
    residual.check_tensor("intrinsics", intrinsics, device, Float, (5,))
    state_stride = _check_state(state_in, lead, device)
    residual.check_tensor("record", record, device, Float, (*lead, RECORD_SIZE))
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
            max_iterations, energy_tol, *flow_args, record.data_ptr(), cluster,
            lead[0] if lead else 1, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lm_solve_level kernel launch failed: CUDA error {err}")
    lm_solve_level.launches += 1
    return record


lm_solve_level.launches = 0


def max_active_clusters(cluster: int) -> int:
    """How many clusters of ``cluster`` blocks of the solver the current
    card runs at once (``cudaOccupancyMaxActiveClusters``): lanes beyond
    that wait for a free slot."""
    count = ctypes.c_int(0)
    err = _library().vors_lm_max_active_clusters(cluster, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {err}")
    return count.value
