"""Weighted hyperspectral unmixing of a synthetic astronomical scene.

The port of ``examples/astro_unmixing.py``. A 5-band 30 x 30-pixel image
holds K=7 Gaussian sources with distinct SEDs, Poisson noise and a sky
background per band. Solves the weighted CMF ``min || sqrt(W) (Y - A S)
||^2 / 2`` with W = 1/sky, non-negativity on the SED matrix A and a
composite constraint on the morphologies S (a hard threshold, then each
source normalized to unit sum over the pixels), racing weighted PGM (the
power-iteration Lipschitz steps, strided and adaptive) against the AdaProx
schemes.

The composite prox normalizes each source over all of S's pixels: the
torch engine applies it to the whole S, as the JAX package's
``engine="xla"`` does, and every solve ends with rows of S summing to 1.

Run:  python -m proxmin_tpu_torch.examples.astro_unmixing [--cpu]
"""

import sys

import numpy as np
import torch

import proxmin_tpu_torch as ptt
from proxmin_tpu_torch import operators
from proxmin_tpu_torch.examples import example_device

# the composite prox's unit sums, in float64 over 900 pixels
ROW_SUM_ATOL = 1e-9


def gaussian_source(nx, pos, size):
    y, x = np.mgrid[0:nx, 0:nx]
    g = np.exp(-0.5 * (((x - pos[0]) ** 2 + (y - pos[1]) ** 2) / size ** 2))
    g = g.reshape(-1)
    return g / g.sum()


def make_scene(nx=30, C=5, K=7, seed=8, noise_seed=10):
    rng = np.random.default_rng(seed)
    poss = rng.uniform(5, nx - 5, size=(K, 2))
    sizes = rng.uniform(1.5, 3.5, size=K)
    S_true = np.stack([gaussian_source(nx, p, s)
                       for p, s in zip(poss, sizes)])
    # smooth SEDs with distinct peaks, scaled to realistic counts
    bands = np.linspace(0, 1, C)
    peaks = rng.uniform(0, 1, size=K)
    A_true = np.exp(-4.0 * (bands[:, None] - peaks[None, :]) ** 2)
    A_true *= rng.uniform(500, 2000, size=K)

    sky = rng.uniform(2, 10, size=C)
    flux = A_true @ S_true + sky[:, None]
    noise_rng = np.random.default_rng(noise_seed)
    Y = noise_rng.poisson(flux).astype(np.float64) - sky[:, None]
    W = np.ones_like(Y) / sky[:, None]
    return Y, W, A_true, S_true, poss, sizes


def prox_S_composite(X, step, thresh=1e-4):
    """Hard threshold, then unit normalization of each source."""
    X = torch.where(X > thresh, X, 0.0)
    return operators.prox_unity_plus(X, step, axis=1)


def main(cpu=False):
    dev = example_device(cpu)
    Y, W, A_true, S_true, poss, sizes = make_scene()
    C, N = Y.shape
    K = S_true.shape[0]
    rng = np.random.default_rng(3)

    # approximate initialization: true positions jittered
    meas = poss + rng.normal(0, 1.0, poss.shape)
    meas = np.clip(meas, 1, 28)
    S0 = np.stack([
        gaussian_source(int(np.sqrt(N)), p, s * (1 + 0.2 * rng.random()))
        for p, s in zip(meas, sizes)
    ])
    A0 = np.maximum(Y @ np.linalg.pinv(S0), 1.0)
    Yt, Wt = (torch.from_numpy(a).to(dev) for a in (Y, W))

    runs = [
        ("PGM (weighted)", dict(algorithm="pgm")),
        # adaptive refresh stride: the weighted Lipschitz bounds refresh
        # on a self-growing interval
        ("PGM (adaptive)", dict(algorithm="pgm", step_adapt=True)),
        ("Adam", dict(algorithm="adaprox", scheme="adam",
                      prox_max_iter=100)),
        ("PAdam", dict(algorithm="adaprox", scheme="padam", p=0.45,
                       prox_max_iter=100)),
        ("AMSGrad", dict(algorithm="adaprox", scheme="amsgrad",
                         prox_max_iter=100)),
    ]

    print(f"scene: {C} bands x {N} px, K={K}, weighted (W = 1/sky)")
    results = {}
    for label, kw in runs:
        A = torch.from_numpy(A0.copy()).to(dev)
        S = torch.from_numpy(S0.copy()).to(dev)
        res = ptt.nmf.nmf(
            Yt, A, S, W=Wt,
            prox_A=operators.prox_plus, prox_S=prox_S_composite,
            e_rel=1e-3, max_iter=500, **kw,
        )
        A, S = res.x
        loss = float(ptt.nmf.log_likelihood(A, S, Y=Yt, W=Wt))
        print(f"{label:16s} weighted loss = {loss:12.2f}  "
              f"iters = {res.iterations:4d}")
        sums = torch.sum(S, dim=1).cpu().numpy()
        assert np.allclose(sums, 1.0, rtol=0, atol=ROW_SUM_ATOL), (
            f"{label}: the sources do not sum to one ({sums})")
        results[label] = {"loss": loss, "iters": int(res.iterations)}
    return results


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv)
