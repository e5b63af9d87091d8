"""Learning a regularization strength through a differentiable solve.

The port of ``examples/learn_regularizer.py``. The classic bilevel
problem: pick the soft-threshold strength ``lam`` so that the denoised
reconstruction best matches held-out truth, by gradient descent on the
outer loss, with gradients flowing through the inner solve by implicit
differentiation at its fixed point
(``proxmin_tpu_torch.functional.make_differentiable_pgm_solver``: O(1)
memory in the inner iteration count, no unrolling), taken by
``torch.autograd``.

Run:  python -m proxmin_tpu_torch.examples.learn_regularizer [--cpu]
"""

import sys

import numpy as np
import torch

from proxmin_tpu_torch import operators
from proxmin_tpu_torch.examples import example_device
from proxmin_tpu_torch.functional import make_differentiable_pgm_solver


def main(cpu=False):
    dev = example_device(cpu)
    rng = np.random.default_rng(5)
    n = 256
    truth = np.zeros(n)
    truth[rng.integers(0, n, 12)] = rng.normal(0, 1.0, 12)  # sparse spikes
    truth = torch.tensor(truth, device=dev)
    y = truth + 0.1 * torch.tensor(rng.standard_normal(n), device=dev)

    # inner problem: min 0.5||x - y||^2 + softplus(lam) ||x||_1
    def grad(x, lam):
        return x - y

    def prox(z, step, lam):
        return operators.prox_soft(z, step,
                                   thresh=torch.nn.functional.softplus(lam))

    solve = make_differentiable_pgm_solver(grad, 0.9, prox=prox,
                                           prox_params=True, e_rel=1e-10)

    def outer(lam):
        x, conv = solve(torch.zeros(n, dtype=y.dtype, device=dev), lam)
        assert bool(conv), "the inner solve did not converge"
        return 0.5 * torch.sum((x - truth) ** 2)

    def outer_grad(lam):
        lam = lam.detach().requires_grad_(True)
        val = outer(lam)
        (g,) = torch.autograd.grad(val, lam)
        return val.detach(), g

    lam = torch.tensor(-4.0, dtype=y.dtype, device=dev)  # far too weak
    l0 = None
    for it in range(150):
        val, g = outer_grad(lam)
        if l0 is None:
            l0 = val
        lam = lam - 1.0 * g
    with torch.no_grad():
        l1 = outer(lam)
    learned = float(torch.nn.functional.softplus(lam))
    print(f"outer loss {float(l0):.4f} -> {float(l1):.4f} "
          f"(learned lam = {learned:.4f})")
    assert float(l1) < 0.5 * float(l0)

    # the learned lam beats both a too-weak and a too-strong choice
    with torch.no_grad():
        weak = float(outer(torch.tensor(-4.0, dtype=y.dtype, device=dev)))
        strong = float(outer(torch.tensor(2.0, dtype=y.dtype, device=dev)))
    assert float(l1) <= min(weak, strong)
    print(f"vs fixed choices: weak {weak:.4f}, strong {strong:.4f} — "
          "learned wins")
    return {"l0": float(l0), "l1": float(l1), "lam": learned, "weak": weak,
            "strong": strong}


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv)
