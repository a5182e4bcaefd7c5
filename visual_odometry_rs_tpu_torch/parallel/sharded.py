"""The LM solve of one level with the candidates sharded over ranks.

The port of ``visual_odometry_rs_tpu/parallel/sharded.py``.  Every rank of
the mesh axis takes its ``N/n`` candidates of the level and evaluates them
against the replicated image with the ``residual_reduce`` kernel (K1,
``csrc/residual_reduce.cu``, through ``ops.residual``; its plain twin on CPU
tensors): the 6x7 ``[JᵀJ | Jᵀr]`` block, ``Σr²`` and ``Σm``, the JAX
package's ``_local_partials``.  Those 44 floats are summed across the ranks
once per evaluation, packed in one tensor and in rank order
(``collectives.psum``); the damped 6x6 solve and the accept/reject rule
(``math.optimizer.damped_solve`` / ``lm_update``) then run on every rank on
the same numbers, with the JAX package's cap of ``max_iterations + 3``.

The per-level solver kernel ``lm_solve_level`` cannot serve here: its
reduction would have to cross cards in the middle of an iteration.  So the
LM loop runs on the host (``models.tracker._lm_loop``), and the host reads
one flag an iteration (continue, and whether the step was finite), on every
rank alike.
"""

from __future__ import annotations

import torch

from ..math.pose import Pose
from ..models import tracker as tracker_mod
from ..models.tracker import LevelObs
from ..ops import residual
from . import collectives
from .mesh import Mesh


def shard_level(obs: LevelObs, mesh: Mesh, axis: str = "points") -> LevelObs:
    """This rank's ``N/n`` candidates of ``obs``, contiguous on its device
    (the kernel's input contract); the intrinsics and template replicated."""
    ag = collectives.axis_group(mesh, axis)
    n, rank = (1, 0) if ag is None else (ag.size, ag.rank)
    N = obs.xs.shape[-1]
    if N % n:
        raise ValueError(f"{N} candidates do not split over the {n} ranks of axis {axis!r}")
    lo, hi = rank * (N // n), (rank + 1) * (N // n)
    device = mesh.device
    cut = {f: getattr(obs, f)[lo:hi].contiguous().to(device)
           for f in ("xs", "ys", "idepth", "valid", "tmpl_vals", "jacobians")}
    return LevelObs(intrinsics=obs.intrinsics.to(device), template=obs.template.to(device), **cut)


def solve_level_point_sharded(
    obs: LevelObs,
    image,
    model0: Pose,
    mesh: Mesh,
    axis: str = "points",
    *,
    lm_coef_init: float = 0.1,
    max_iterations: int = 20,
    energy_tol: float = 1.0,
):
    """LM solve of one level with the candidates sharded over ``mesh[axis]``:
    ``(model, failed, nb_iter)``, the same on every rank.  Every rank passes
    the whole level; the candidate count must be a multiple of the axis
    size.  The same numbers as ``models.tracker.solve_level`` up to the f32
    order of the cross-rank sum (bit-equal on one rank)."""
    local = shard_level(obs, mesh, axis)
    device = mesh.device
    image = image.to(device)
    k = local.intrinsics.vector()

    def evaluate(model, out):
        params = torch.cat([model.q, model.t, k])
        m, rsq, count = residual.residual_reduce(
            image, local.xs, local.ys, local.idepth, local.tmpl_vals, local.valid, local.jacobians, params, out=out,
        )
        packed = out if out is not None else torch.cat([m.reshape(-1), rsq[None], count[None]])
        total = collectives.psum(packed, mesh, axis)
        m = total[:42].view(6, 7)
        return total[42] / total[43], m[:, 6], m[:, :6]

    result = tracker_mod._lm_loop(
        evaluate, tracker_mod._pose_step, model0.to(device), image, lm_coef_init=lm_coef_init,
        max_iterations=max_iterations, energy_tol=energy_tol, out_size=residual.OUT_SIZE,
    )
    return result.state.model, result.failed, result.nb_iter
