"""Multi-rank serving: export once, serve, preempt, continue.

The port of ``examples/pod_serving.py``, end to end:

1. EXPORT the explicit-collective sharded solve as one ``torch.export``
   program per rank (``export.export_nmf_pgm_sharded``): the whole solve
   over the rank's shards, its loop included, with ``max_iter`` a runtime
   input and the all-reduces as functional collectives.
2. SERVE it from the saved file through ``export.load_exported``, which
   points the program's collectives at this process's groups and takes the
   ``DTensor`` s of ``parallel.shard_nmf_problem``. Unlike JAX's serialized
   artifacts, which ``jax.export.deserialize`` serves with no proxmin_tpu
   in the process, serving a per-rank program needs the port imported (its
   layout and process groups; a program with kernels, its registered ops).
3. PREEMPT mid-solve and CONTINUE through the ``resume=True`` program (the
   strided program returns its step carries): the continuation walks the
   uninterrupted live solve's trajectory bit for bit.

The script starts its ranks itself (one NCCL rank per card, or ``--cpu``
``--ranks R`` gloo ranks, default 2)::

    python -m proxmin_tpu_torch.examples.pod_serving [--cpu] [--ranks R]
"""

import os
import sys

import numpy as np

from proxmin_tpu_torch.examples import ranks_option, sharded_main


def main(cpu=False, ranks=None):
    return sharded_main(rank_main, cpu=cpu, ranks=ranks)


def rank_main(args, dev, work):
    import torch
    import torch.distributed as dist

    from proxmin_tpu_torch.export import (export_nmf_pgm_sharded,
                                          load_exported, save_exported)
    from proxmin_tpu_torch.parallel import (make_mesh, nmf_pgm_sharded,
                                            shard_nmf_problem)

    n_dev = dist.get_world_size()
    rank = dist.get_rank()
    print(f"devices: {n_dev} x {dev.type}")

    rng = np.random.default_rng(11)
    C, K = 6, 4
    N = 4096 * n_dev
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true + 0.01 * rng.standard_normal((C, N))).astype(
        np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    mesh = make_mesh(device=dev.type)
    kw = dict(e_rel=0.0, weighted=True, step_stride=8)

    # 1. export: one fresh program and one continuation program per rank
    fresh_blob = export_nmf_pgm_sharded(mesh, C, K, N, **kw)
    cont_blob = export_nmf_pgm_sharded(mesh, C, K, N, resume=True, **kw)
    paths = [save_exported(os.path.join(work, f"{name}_rank{rank}.pt2"),
                           blob)
             for name, blob in (("fresh", fresh_blob),
                                ("resume", cont_blob))]
    print(f"programs: fresh {len(fresh_blob) // 1024} KiB, "
          f"resume {len(cont_blob) // 1024} KiB")
    del fresh_blob, cont_blob

    # 2. serve from the files
    fresh, cont = (load_exported(p) for p in paths)
    Y_d, A_d, S_d, W_d = shard_nmf_problem(mesh, Y, A0, S0, W)

    # 3. "preemption": 30 iterations, then the pod goes away...
    outs = fresh(A_d, S_d, Y_d, W_d, 30)
    print(f"preempted at it={int(outs[2])}, loss={float(outs[5]):.4f}")

    # ...continuation through the resume program: its carries are the
    # fresh program's outputs from position 2 on (it, conv_A, conv_S,
    # loss, step_A, step_S, stride, seg_end, and the pixel-sharded v)
    outs2 = cont(outs[0], outs[1], Y_d, W_d, 45, *outs[2:])
    print(f"resumed to it={int(outs2[2])}, loss={float(outs2[5]):.4f}")

    # the uninterrupted live solve walks the identical trajectory
    ref = nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                          e_rel=0, max_iter=75, step_stride=8)
    dS = float(torch.max(torch.abs(outs2[1].full_tensor()
                                   - ref.x[1].full_tensor())))
    print(f"max |S_program - S_live_uninterrupted| = {dS:.2e}")
    assert int(outs2[2]) == 75 == ref.iterations
    assert dS == 0.0, "program continuation must be bit-exact"
    print("program-served, preempted, resumed — bit-exact vs live")
    return {"ranks": n_dev, "it_preempted": int(outs[2]),
            "loss_preempted": float(outs[5]), "it": int(outs2[2]),
            "loss": float(outs2[5]), "dS": dS}


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv, ranks=ranks_option(sys.argv))
