"""Synthetic spectral unmixing: constrained NMF races.

The port of ``examples/unmixing.py``. b=100 observed spectra over n=50
channels made from k=3 ground-truth components with mixture weights on the
simplex. Factorizes Y = A S under ``prox_unity_plus(axis=1)`` on the
mixture matrix A and non-negativity on the spectra S, racing PGM against
the AdaProx schemes (with their prox sub-iterations), then matches the
recovered components to the truth with the Hungarian algorithm. Both run
in the drivers on the torch engine, in float64 as the data come.

Run:  python -m proxmin_tpu_torch.examples.unmixing [--cpu]
"""

import sys

import numpy as np
import torch

import proxmin_tpu_torch as ptt
from proxmin_tpu_torch import operators
from proxmin_tpu_torch.examples import example_device

# a solve recovers the components: its Hungarian-matched correlation with
# the truth (the JAX script's runs print 0.997)
MATCH_MIN = 0.9


def make_data(b=100, n=50, k=3, sigma=0.02, seed=101):
    rng = np.random.default_rng(seed)
    # smooth positive ground-truth spectra
    x = np.linspace(0, 1, n)
    S_true = np.stack([
        np.exp(-0.5 * ((x - mu) / w) ** 2) + 0.1
        for mu, w in [(0.25, 0.08), (0.5, 0.12), (0.8, 0.06)]
    ])
    A_true = rng.dirichlet(np.ones(k), size=b)
    Y = A_true @ S_true + sigma * rng.standard_normal((b, n))
    return Y, A_true, S_true


def match_components(S_est, S_true):
    """Hungarian matching of recovered to true components (by
    correlation)."""
    try:
        from scipy.optimize import linear_sum_assignment
    except ImportError:
        return None
    k = S_true.shape[0]
    corr = np.zeros((k, k))
    for i in range(k):
        for j in range(k):
            a, b = S_est[i], S_true[j]
            corr[i, j] = np.dot(a, b) / (
                np.linalg.norm(a) * np.linalg.norm(b) + 1e-12
            )
    row, col = linear_sum_assignment(-corr)
    return corr[row, col].mean()


def prox_A(X, step):
    return operators.prox_unity_plus(X, step, axis=1)


def main(cpu=False):
    dev = example_device(cpu)
    Y, A_true, S_true = make_data()
    b, n = Y.shape
    k = S_true.shape[0]
    rng = np.random.default_rng(0)
    A0 = rng.dirichlet(np.ones(k), size=b)
    S0 = 0.5 + rng.random((k, n))
    Yt = torch.from_numpy(Y).to(dev)

    runs = [("PGM", dict(algorithm="pgm"))]
    for alpha in (0.1,):
        for scheme in ("adam", "padam", "amsgrad"):
            runs.append((
                f"{scheme} a={alpha}",
                dict(algorithm="adaprox", scheme=scheme,
                     step=lambda *X, it=None, a=alpha: (a, a),
                     prox_max_iter=100),
            ))

    print(f"problem: Y {b}x{n}, k={k}")
    results = {}
    for label, kw in runs:
        A = torch.from_numpy(A0.copy()).to(dev)
        S = torch.from_numpy(S0.copy()).to(dev)
        res = ptt.nmf.nmf(
            Yt, A, S, prox_A=prox_A, prox_S=operators.prox_plus,
            e_rel=1e-4, max_iter=1000, **kw,
        )
        A, S = res.x
        loss = float(ptt.nmf.log_likelihood(A, S, Y=Yt))
        m = match_components(S.cpu().numpy(), S_true)
        match = f"match = {m:.4f}" if m is not None else ""
        print(f"{label:16s} loss = {loss:9.4f}  iters = {res.iterations:4d}  "
              f"{match}")
        results[label] = {"loss": loss, "iters": int(res.iterations),
                          "match": m}
        if m is not None:
            assert m > MATCH_MIN, f"{label} did not recover the components"
    return results


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv)
