"""LM on the Rosenbrock function through the optimizer harness.

The port of ``examples/optim_rosenbrock.py`` (reference
``examples/optim_rosenbrock.rs``): residuals ``r1 = (a-x)^2``,
``r2 = b (y - x^2)^2`` with a=1, b=100; LM from (-2, -2); stop at
d_energy <= 1e-10 or 100 iterations.

    python -m visual_odometry_rs_tpu_torch.examples.optim_rosenbrock [--cpu]
"""

from __future__ import annotations

import torch

from ..math.optimizer import LMState, damped_solve, iterative_solve, lm_update
from ._common import device_of, parser

A, B = 1.0, 100.0


def res(m: torch.Tensor) -> torch.Tensor:
    x, y = m[0], m[1]
    return torch.stack([(A - x) ** 2, B * (y - x * x) ** 2])


def jac(m: torch.Tensor) -> torch.Tensor:
    x, y = m[0], m[1]
    zero = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([-2.0 * (A - x), zero]), torch.stack([-4.0 * B * x * (y - x * x), 2.0 * B * (y - x * x)])]
    )


def evaluate(m: torch.Tensor):
    r = res(m)
    j = jac(m)
    return torch.sum(r * r), j.T @ r, j.T @ j


def main(argv=None):
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = device_of(args)
    lm0 = torch.tensor(0.1, device=device)
    result = iterative_solve(
        None,
        torch.tensor([-2.0, -2.0], device=device),
        init=lambda o, m: LMState(m, *evaluate(m), lm0),
        step=lambda s: s.model - damped_solve(s.hessian, s.gradient, s.lm_coef),
        eval_fn=lambda o, s, m: (m, *evaluate(m)),
        stop_criterion=lambda s, n, e: lm_update(s, n, *e, max_iterations=99, energy_tol=1e-10),
        max_iterations=150,
    )
    print(f"After {int(result.nb_iter)} iterations:")
    print(f"Computed: {tuple(float(v) for v in result.state.model)}")
    print("Solution: (1.0, 1.0)")
    return result


if __name__ == "__main__":
    main()
