"""Iterative-optimizer harness and Levenberg-Marquardt building blocks.

The port of ``visual_odometry_rs_tpu/math/optimizer.py``.  The reference's
four hooks (``init / step / eval / stop_criterion``, optimizer.rs:32-71)
drive a plain Python loop instead of ``lax.while_loop``.  On a GPU the
tracker does not run this loop: ``ops.lm_solve`` runs the same control flow
inside one kernel, and this module is its plain version
(``models.tracker.solve_level_reference``).

Each iteration makes ONE device→host sync: the finiteness of the step and
the stopper's ``continue?`` flag are packed into one integer and read with a
single ``.item()``.  The evaluation runs before that read, also for a step
that turns out non-finite; its result is then discarded, so the outcome is
the JAX driver's: a non-finite step stops the loop with ``failed`` and
leaves the state untouched.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch


class SolveResult(NamedTuple):
    """``nb_iter`` and ``failed`` are a Python int and bool from
    ``iterative_solve``, and 0-d device tensors from the GPU solver."""

    state: Any
    nb_iter: Any
    failed: Any  # a step() produced non-finite model values


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return []


def all_finite(tree) -> torch.Tensor:
    """Device bool: every float tensor of ``tree`` is finite."""
    oks = [torch.isfinite(x).all() for x in _leaves(tree) if x.is_floating_point()]
    return torch.stack(oks).all()


def iterative_solve(
    obs: Any,
    initial_model: Any,
    *,
    init: Callable[[Any, Any], Any],
    step: Callable[[Any], Any],
    eval_fn: Callable[[Any, Any, Any], Any],
    stop_criterion: Callable[[Any, int, Any], Tuple[Any, torch.Tensor]],
    max_iterations: int = 100,
) -> SolveResult:
    """Run the solver until ``stop_criterion`` stops it, a step is
    non-finite, or ``max_iterations`` (a hard bound on top of the stopper)
    is reached.  ``nb_iter`` starts at 1 on the first iteration
    (optimizer.rs:57-70)."""
    state = init(obs, initial_model)
    nb_iter = 0
    failed = False
    while nb_iter < max_iterations:
        nb_iter += 1
        new_model = step(state)
        step_ok = all_finite(new_model)
        eval_out = eval_fn(obs, state, new_model)
        new_state, cont = stop_criterion(state, nb_iter, eval_out)
        flags = int((step_ok.to(torch.int32) * 2 + cont.to(torch.int32)).item())
        if not flags & 2:
            failed = True
            break
        state = new_state
        if not flags & 1:
            break
    return SolveResult(state=state, nb_iter=nb_iter, failed=failed)


class LMState(NamedTuple):
    """Accepted LM state: the model and the quadratic approximation at it
    (lm_optimizer.rs:16-40).  ``lm_coef`` is the damping coefficient."""

    model: Any
    energy: torch.Tensor
    gradient: torch.Tensor  # (n,)
    hessian: torch.Tensor  # (n, n)
    lm_coef: torch.Tensor


def damped_solve(hessian: torch.Tensor, gradient: torch.Tensor, lm_coef) -> torch.Tensor:
    """Solve ``(H with diag * (1+lm)) delta = g`` by Cholesky
    (lm_optimizer.rs:123-134: Marquardt scaling of the diagonal only).

    A system that is not positive definite yields a NaN delta, as JAX's
    Cholesky does; the driver then reports ``failed``.  Nothing raises and
    nothing syncs with the host.
    """
    n = hessian.shape[-1]
    eye = torch.eye(n, dtype=hessian.dtype, device=hessian.device)
    damped = hessian * (1.0 + lm_coef * eye)
    chol, info = torch.linalg.cholesky_ex(damped)
    delta = torch.cholesky_solve(gradient[..., None], chol)[..., 0]
    return torch.where(info[..., None] == 0, delta, torch.full_like(delta, float("nan")))


def _tree_where(cond: torch.Tensor, a, b):
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    return type(a)(*(_tree_where(cond, x, y) for x, y in zip(a, b)))


def lm_update(
    state: LMState,
    nb_iter: int,
    new_model: Any,
    new_energy: torch.Tensor,
    new_gradient: torch.Tensor,
    new_hessian: torch.Tensor,
    *,
    max_iterations: int,
    energy_tol: float,
) -> Tuple[LMState, torch.Tensor]:
    """Accept/reject and the λ schedule of the reference's LM instances.

    - energy increased (strictly): reject, ``λ *= 10``, continue
      (lm_optimizer.rs:170-174);
    - energy decreased or equal, or NaN (Rust's ``>`` is false for NaN):
      accept, ``λ *= 0.1``, continue iff ``old - new > energy_tol``
      (lm_optimizer.rs:176-189);
    - ``nb_iter > max_iterations``: stop either way (lm_optimizer.rs:157-167).

    Returns ``(state, continue?)`` with ``continue?`` a device bool.
    """
    rejected = new_energy > state.energy
    d_energy = state.energy - new_energy
    accepted_state = LMState(
        model=new_model,
        energy=new_energy,
        gradient=new_gradient,
        hessian=new_hessian,
        lm_coef=state.lm_coef * 0.1,
    )
    rejected_state = state._replace(lm_coef=state.lm_coef * 10.0)
    new_state = _tree_where(rejected, rejected_state, accepted_state)
    if nb_iter > max_iterations:
        cont = torch.zeros_like(rejected)
    else:
        cont = rejected | (d_energy > energy_tol)
    return new_state, cont
