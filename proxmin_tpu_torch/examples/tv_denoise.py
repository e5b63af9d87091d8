"""Total-variation denoising with a matrix-free constraint operator.

The port of ``examples/tv_denoise.py``. Solves

    min_x  0.5 ||x - y||^2 + lam ||D x||_1

with D the 1-D forward-difference operator, by linearized ADMM. D is a
:class:`~proxmin_tpu_torch.linop.FunctionOperator`: its action (two
one-liners on tensors), never materialized. At n = 2^20 samples a dense D
would be a ~4 TiB matrix; this solve runs in O(n) memory on one card.
``lambda_max(D^T D) < 4`` is known analytically, so ``norm_sq=4.0`` skips
the Lanczos estimate at construction.

Run:  python -m proxmin_tpu_torch.examples.tv_denoise [n] [--cpu] [--plot]
"""

import sys
import time
from functools import partial

import numpy as np
import torch

from proxmin_tpu_torch import admm, operators
from proxmin_tpu_torch.examples import example_device, positional
from proxmin_tpu_torch.linop import FunctionOperator


def fwd_diff(x):
    return x[1:] - x[:-1]


def fwd_diff_T(y):
    return torch.cat([-y[:1], y[:-1] - y[1:], y[-1:]])


def _prox_quad(x, step, *, y):
    return (x + step * y) / (1.0 + step)


def _prox_l1(z, step, *, lam):
    return operators.prox_soft(z, step, thresh=lam)


def make_data(n):
    """The JAX script's piecewise-constant truth and its noisy samples
    (seed 3), float32."""
    rng = np.random.default_rng(3)
    truth = np.zeros(n, np.float32)
    for lo, hi, v in ((0.1, 0.3, 1.0), (0.45, 0.6, -0.7), (0.8, 0.95, 0.4)):
        truth[int(lo * n):int(hi * n)] = v
    y = truth + 0.25 * rng.standard_normal(n).astype(np.float32)
    return truth, y


def main(n=1 << 20, cpu=False, plot=False):
    dev = example_device(cpu)
    lam = 0.5
    truth, y = make_data(n)
    yt = torch.from_numpy(y).to(dev)

    prox_f = partial(_prox_quad, y=yt)     # prox of 0.5||x - y||^2
    prox_g = partial(_prox_l1, lam=lam)    # prox of lam ||.||_1

    D = FunctionOperator(fwd_diff, fwd_diff_T, (n,), dtype=torch.float32,
                         norm_sq=4.0, device=dev)

    t0 = time.perf_counter()
    res = admm(torch.zeros(n, dtype=torch.float32, device=dev), prox_f, 0.5,
               prox_g=prox_g, L=D, e_rel=1e-4, max_iter=500)
    x = res.x.cpu().numpy()
    dt = time.perf_counter() - t0

    def tv(v):
        return float(np.abs(np.diff(v)).sum())

    rmse_in = float(np.sqrt(np.mean((y - truth) ** 2)))
    rmse_out = float(np.sqrt(np.mean((x - truth) ** 2)))
    print(f"n={n}  iters={res.iterations}  wall={dt:.2f}s")
    print(f"TV:   input {tv(y):10.1f}  ->  solution {tv(x):10.1f}")
    print(f"RMSE: input {rmse_in:10.4f}  ->  solution {rmse_out:10.4f}")
    assert rmse_out < 0.5 * rmse_in, "denoising failed"

    if plot:
        import matplotlib.pyplot as plt

        sl = slice(0, min(n, 4096))
        plt.plot(y[sl], lw=0.3, label="noisy")
        plt.plot(truth[sl], lw=1, label="truth")
        plt.plot(x[sl], lw=1, label="TV-denoised")
        plt.legend()
        plt.savefig("tv_denoise.png", dpi=120)
        print("wrote tv_denoise.png")
    return {"n": n, "iters": int(res.iterations), "wall": dt,
            "tv_in": tv(y), "tv_out": tv(x), "rmse_in": rmse_in,
            "rmse_out": rmse_out}


if __name__ == "__main__":
    args = positional(sys.argv[1:])
    main(int(args[0]) if args else 1 << 20, cpu="--cpu" in sys.argv,
         plot="--plot" in sys.argv)
