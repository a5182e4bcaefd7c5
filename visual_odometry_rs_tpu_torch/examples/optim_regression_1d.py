"""LM fit of ``y = exp(-a x)`` on 100 noisy points.

The port of ``examples/optim_regression_1d.py`` (reference
``examples/optim_regression-1d.rs``): ground truth a = 1.5, uniform noise in
[-0.1, 0.1], scalar gradient and Hessian.  The noise is the JAX example's
``jax.random.uniform(PRNGKey(0), (100,), minval=-1, maxval=1)``, bit for
bit, computed in numpy (``core.candidates.dso.jax_uniform``).

    python -m visual_odometry_rs_tpu_torch.examples.optim_regression_1d [--cpu]
"""

from __future__ import annotations

import torch

from ..core.candidates import dso
from ..math.optimizer import LMState, damped_solve, iterative_solve, lm_update
from ._common import device_of, parser


def main(argv=None):
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    device = device_of(args)
    a_truth = 1.5
    nb = 100
    x = torch.linspace(-5.0, 3.0, nb, device=device)
    noise = torch.from_numpy(dso.jax_uniform((nb,), 0, -1.0, 1.0)).to(device)
    y = torch.exp(-a_truth * x) + 0.1 * noise

    def evaluate(a):
        f = torch.exp(-a * x)
        r = f - y
        energy = torch.sum(r * r) / nb
        j = -f * x
        return energy, torch.dot(j, r).reshape(1), torch.dot(j, j).reshape(1, 1)

    lm0 = torch.tensor(0.1, device=device)
    result = iterative_solve(
        None,
        torch.tensor(0.0, device=device),
        init=lambda o, m: LMState(m, *evaluate(m), lm0),
        step=lambda s: s.model - damped_solve(s.hessian, s.gradient, s.lm_coef)[0],
        eval_fn=lambda o, s, m: (m, *evaluate(m)),
        stop_criterion=lambda s, n, e: lm_update(s, n, *e, max_iterations=50, energy_tol=1e-8),
        max_iterations=80,
    )
    print(f"After {int(result.nb_iter)} iterations:")
    print(f"Ground truth: a = {a_truth}")
    print(f"Computed:     a = {float(result.state.model)}")
    return result


if __name__ == "__main__":
    main()
