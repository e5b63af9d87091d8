"""Multi-rank hyperspectral unmixing: the scaling demo.

The port of ``examples/sharded_unmixing.py``. Shards a synthetic unmixing
problem over every rank of a process group (pixel-axis data parallelism)
and solves it three ways, checking that they agree:

1. auto-SPMD: shard the inputs as ``DTensor`` s
   (``parallel.shard_nmf_problem``) and run the ordinary ``nmf``;
2. explicit collectives: ``parallel.nmf_pgm_sharded``, every rank's host
   loop over its shards with one all-reduce per reduction;
3. one device, as the baseline.

The script starts its ranks itself: one NCCL rank per card, or with
``--cpu`` ``--ranks R`` gloo ranks (default 2), joined through a file
store::

    python -m proxmin_tpu_torch.examples.sharded_unmixing [--cpu]
        [--ranks R]
"""

import sys
import time

import numpy as np
import torch

from proxmin_tpu_torch.examples import ranks_option, sharded_main

# short horizon for the three-way agreement: nonconvex NMF trajectories in
# float32 drift apart after ~50 iterations when the reductions sum in
# another order, so the long run compares losses instead
ITERS = 10
LONG_ITERS = 300
# float32 and a different reduction order: ~1e-4-scale drift that doubles
# per iteration on this nonconvex problem
AGREE_ATOL = 1e-2


def main(cpu=False, ranks=None):
    return sharded_main(rank_main, cpu=cpu, ranks=ranks)


def rank_main(args, dev, work):
    import torch.distributed as dist

    import proxmin_tpu_torch as ptt
    from proxmin_tpu_torch.parallel import (make_mesh, nmf_pgm_sharded,
                                            shard_nmf_problem)

    n_dev = dist.get_world_size()
    print(f"devices: {n_dev} x {dev.type}")

    rng = np.random.default_rng(7)
    C, K = 8, 4
    N = 16384 * n_dev          # scale the pixel axis with the mesh
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true + 0.01 * rng.standard_normal((C, N))).astype(
        np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    mesh = make_mesh(device=dev.type)
    print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
          f"Y {C}x{N}")

    # 1. auto-SPMD
    Ys, As, Ss, _ = shard_nmf_problem(mesh, Y, A0, S0)
    t0 = time.perf_counter()
    r1 = ptt.nmf.nmf(Ys, As, Ss, e_rel=0, max_iter=ITERS)
    sync()
    t_auto = time.perf_counter() - t0
    print(f"auto-SPMD:           {t_auto:6.2f}s")

    # 2. explicit collectives
    t0 = time.perf_counter()
    r2 = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh, e_rel=0,
                         max_iter=ITERS)
    sync()
    t_explicit = time.perf_counter() - t0
    print(f"explicit collectives: {t_explicit:6.2f}s")

    # 3. one device
    Yt = torch.from_numpy(Y).to(dev)
    t0 = time.perf_counter()
    r3 = ptt.nmf.nmf(Yt, torch.from_numpy(A0).to(dev),
                     torch.from_numpy(S0).to(dev), e_rel=0, max_iter=ITERS)
    sync()
    t_single = time.perf_counter() - t0
    print(f"single device:       {t_single:6.2f}s")

    S1, S2 = (r.x[1].full_tensor() for r in (r1, r2))
    d12 = float(torch.max(torch.abs(S1 - S2)))
    d13 = float(torch.max(torch.abs(S1 - r3.x[1])))
    print(f"max |S_auto - S_explicit| = {d12:.2e}; "
          f"max |S_auto - S_single| = {d13:.2e}")
    assert d12 < AGREE_ATOL and d13 < AGREE_ATOL
    print("all three paths agree at the short horizon")

    # long run: loss agreement (the trajectories are chaotic in float32)
    r_long = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh, e_rel=0,
                             max_iter=LONG_ITERS)
    l_long = float(ptt.nmf.log_likelihood(
        *(x.full_tensor() for x in r_long.x), Y=Yt))
    r_single = ptt.nmf.nmf(Yt, torch.from_numpy(A0).to(dev),
                           torch.from_numpy(S0).to(dev), e_rel=0,
                           max_iter=LONG_ITERS)
    l_single = float(ptt.nmf.log_likelihood(*r_single.x, Y=Yt))
    print(f"{LONG_ITERS}-iter losses: sharded {l_long:.4f} vs single "
          f"{l_single:.4f}")
    assert l_long < l_single * 1.5 + 1e-3
    return {"ranks": n_dev, "d12": d12, "d13": d13, "loss_sharded": l_long,
            "loss_single": l_single, "seconds": [t_auto, t_explicit,
                                                 t_single]}


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv, ranks=ranks_option(sys.argv))
