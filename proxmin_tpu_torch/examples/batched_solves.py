"""Batched solving: thousands of independent problems in one call.

The port of ``examples/batched_solves.py``. Many small independent solves
leave a card idle; ``proxmin_tpu_torch.functional`` exposes the solver
cores as pure functions, so ``torch.func.vmap`` turns a batch of problems
into one batched loop: the lanes controller runs until every lane has
converged, freezing the lanes that have, and each lane's result is its
individual solve.

Demo: fit a disk-constrained quadratic per "source" of a catalog, e.g.
thousands of per-object calibration problems from one survey tile.

Run:  python -m proxmin_tpu_torch.examples.batched_solves [batch] [--cpu]
"""

import sys
import time

import numpy as np
import torch

from proxmin_tpu_torch.examples import example_device, positional
from proxmin_tpu_torch.functional import make_pgm_solver


def prox_disk(x, step, r=0.5):
    nrm = torch.sqrt(torch.sum(x ** 2))
    return torch.where(nrm > r, x * (r / nrm), x)


def main(batch=4096, cpu=False):
    dev = example_device(cpu)
    rng = np.random.default_rng(7)
    dim = 8
    centers = torch.tensor(rng.normal(size=(batch, dim)), dtype=torch.float32,
                           device=dev)
    # per-problem curvature -> per-problem step sizes and iteration counts
    curv = torch.tensor(rng.uniform(0.5, 2.0, size=(batch, dim)),
                        dtype=torch.float32, device=dev)

    def solve_one(x0, c, h):
        def grad(x):
            return h * (x - c)

        step = 1.0 / torch.max(h)
        return make_pgm_solver(grad, step, prox=prox_disk, accelerated=True,
                               e_rel=1e-6, max_iter=500)(x0)

    solve_all = torch.func.vmap(solve_one)

    x0s = torch.zeros((batch, dim), dtype=torch.float32, device=dev)
    # a first call, as the JAX script's compile (here: warm caches)
    solve_all(x0s, centers, curv)
    t0 = time.perf_counter()
    xs, its, convs, _ = solve_all(x0s, centers, curv)
    xs = xs.cpu().numpy()
    dt = time.perf_counter() - t0

    its = its.cpu().numpy()
    n_conv = int(convs.all(dim=-1).sum())
    print(f"{batch} solves in one call: {dt * 1e3:.1f} ms "
          f"({dt / batch * 1e6:.1f} us/solve)")
    print(f"iterations per lane: min {its.min()}, median "
          f"{int(np.median(its))}, max {its.max()}; "
          f"{n_conv}/{batch} converged")

    # spot-check three lanes against individual solves. (Batched
    # reductions can round differently from the single-problem layout in
    # float32, so the stopping iteration may shift near the tolerance; the
    # solutions agree.)
    for i in (0, batch // 2, batch - 1):
        xi, iti, _, _ = solve_one(x0s[i], centers[i], curv[i])
        np.testing.assert_allclose(xs[i], xi.cpu().numpy(), rtol=1e-4,
                                   atol=1e-6)
        assert abs(int(its[i]) - int(iti)) <= 2
    print("lane results match individual solves (3 spot checks)")
    return {"batch": batch, "ms": dt * 1e3, "it_min": int(its.min()),
            "it_median": int(np.median(its)), "it_max": int(its.max()),
            "converged": n_conv}


if __name__ == "__main__":
    args = positional(sys.argv[1:])
    main(int(args[0]) if args else 4096, cpu="--cpu" in sys.argv)
