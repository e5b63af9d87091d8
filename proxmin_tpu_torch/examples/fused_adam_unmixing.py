"""Proximal-Adam unmixing on the fused engine, with checkpointed
continuation.

The port of ``examples/fused_adam_unmixing.py``. Two executions of the
same Adam recursion:

1. the fused CUDA engine (``engine="cuda"``): gradient, both moment EMAs,
   bias correction and the closed-form prox in one pass over the pixels
   per iteration, in the hand-written kernel K2
   (``csrc/nmf_adaprox_step.cu``); ``moment_dtype=torch.bfloat16`` stores
   the S moments in bfloat16 with casts in registers;
2. the driver on the torch engine with the separable closed-form prox
   (``separable_prox="auto"``, the exact limit of the sub-iteration loop).

The demo fits a K=4 spectral unmixing problem, then continues the solve
through the fused engine's M/V warm start: the moments round-trip as the
driver's do. On the CPU (``--cpu``) the fused engine runs K2's plain
PyTorch version.

Run:  python -m proxmin_tpu_torch.examples.fused_adam_unmixing [N_pixels]
      [--cpu]
"""

import sys

import numpy as np
import torch

import proxmin_tpu_torch as ptt
from proxmin_tpu_torch.examples import example_device, positional


def make_problem(N, C=6, K=4, seed=11):
    rng = np.random.default_rng(seed)
    # smooth Gaussian-bump spectra and non-negative abundances
    grid = np.linspace(0, 1, C)[:, None]
    centers = rng.random((1, K))
    A_true = np.exp(-((grid - centers) ** 2) / 0.05).astype(np.float32)
    S_true = rng.gamma(2.0, 1.0, (K, N)).astype(np.float32)
    Y = (A_true @ S_true
         + 0.01 * rng.standard_normal((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    return Y, A0, S0


def main(N=20000, cpu=False):
    dev = example_device(cpu)
    Y, A0, S0 = (torch.from_numpy(a).to(dev) for a in make_problem(N))
    loss0 = float(ptt.nmf.log_likelihood(A0, S0, Y=Y))

    # one call on the fused engine (bfloat16 moment storage)
    res = ptt.nmf.nmf(Y, A0.clone(), S0.clone(), algorithm="adaprox",
                      engine="cuda", moment_dtype=torch.bfloat16,
                      e_rel=0, max_iter=150)
    loss1 = res.loss
    print(f"fused adam: loss {loss0:.1f} -> {loss1:.1f} "
          f"after {res.iterations} iterations")
    assert loss1 < 0.1 * loss0

    # continuation: warm-start from the returned moments (what a
    # preemption/checkpoint boundary looks like)
    res2 = ptt.nmf.nmf(Y, res.x[0].clone(), res.x[1].clone(),
                       algorithm="adaprox", engine="cuda",
                       moment_dtype=torch.bfloat16, e_rel=0, max_iter=150,
                       M=res.M, V=res.V)
    print(f"continued:  loss {loss1:.1f} -> {res2.loss:.1f}")
    assert res2.loss < loss1

    # the torch engine's driver solves the same recursion
    res_x = ptt.nmf.nmf(Y, A0.clone(), S0.clone(), algorithm="adaprox",
                        separable_prox="auto", e_rel=0, max_iter=150)
    loss_x = float(ptt.nmf.log_likelihood(*res_x.x, Y=Y))
    print(f"torch driver: loss {loss0:.1f} -> {loss_x:.1f}")
    return {"loss0": loss0, "fused": float(loss1),
            "fused_iters": int(res.iterations),
            "continued": float(res2.loss), "driver": loss_x}


if __name__ == "__main__":
    args = positional(sys.argv[1:])
    main(int(args[0]) if args else 20000, cpu="--cpu" in sys.argv)
