"""Preemptible-pod drill: checkpoint a long sharded solve, kill it, resume
exactly.

The port of ``examples/preemptible_resume.py``. A weighted adaptive-stride
NMF solve (the production configuration for large problems) runs in
``slice``-iteration slices; after each slice the factors and the solver's
exact-resume ``.state`` go to disk as a sharded checkpoint
(``proxmin_tpu_torch.checkpoint``, ``torch.distributed.checkpoint``: every
rank writes its shards). The "preemption" then drops every in-memory
object; the continuation reloads the checkpoint on a new mesh and finishes
the solve. The drill checks that the resumed trajectory is identical to an
uninterrupted solve's, mid-stride kills included: the carried segment
state (frozen Lipschitz steps, adaptive refresh interval, segment end,
sharded power iterate) is what makes that exact.

The script starts its ranks itself (one NCCL rank per card, or ``--cpu``
``--ranks R`` gloo ranks, default 2)::

    python -m proxmin_tpu_torch.examples.preemptible_resume [total] [slice]
        [--cpu] [--ranks R]
"""

import os
import sys

import numpy as np

from proxmin_tpu_torch.examples import (positional, ranks_option,
                                        sharded_main)


def main(total=60, slice_iters=23, cpu=False, ranks=None):
    return sharded_main(rank_main, [total, slice_iters], cpu=cpu,
                        ranks=ranks)


def rank_main(args, dev, work):
    import torch
    import torch.distributed as dist

    from proxmin_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from proxmin_tpu_torch.nmf import nmf
    from proxmin_tpu_torch.parallel import make_mesh

    total = int(args[0]) if args else 60
    # not a stride multiple: every preemption lands mid-segment on purpose
    slice_iters = int(args[1]) if len(args) > 1 else 23

    n_dev = dist.get_world_size()
    rng = np.random.default_rng(7)
    C, K, N = 8, 4, 4096 * n_dev
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true
         + 0.01 * rng.standard_normal((C, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)

    kw = dict(W=W, e_rel=0.0, step_adapt=True)

    # --- uninterrupted reference run ------------------------------------
    mesh = make_mesh(device=dev.type)
    ref = nmf(Y, A0.copy(), S0.copy(), mesh=mesh, max_iter=total, **kw)
    ref_x = [x.full_tensor() for x in ref.x]
    print(f"uninterrupted: {total} iters, loss {ref.loss:.6f}")

    # --- preempted run: solve in slices, checkpoint, drop everything ----
    ckpt_dir = os.path.join(work, "checkpoints")
    path = None
    done = 0
    seg_ends = []
    while done < total:
        mesh = make_mesh(device=dev.type)  # each slice: a rebuilt mesh
        if path is None:
            a, s, state = A0.copy(), S0.copy(), None
        else:
            ckpt = load_checkpoint(path, mesh=mesh)
            a, s = ckpt["x"][0], ckpt["x"][1]
            state = ckpt["solver_state"]
        n = min(slice_iters, total - done)
        res = nmf(Y, a, s, mesh=mesh, max_iter=n,
                  **({} if state is None else {"state": state}), **kw)
        done += res.iterations
        path = save_checkpoint(os.path.join(ckpt_dir, f"ckpt_{done:04d}"),
                               x=list(res.x), solver_state=res.state)
        seg_ends.append(int(res.state["seg_end"]))
        print(f"  slice -> it {done} (seg_end "
              f"{int(res.state['seg_end'])}, stride "
              f"{int(res.state['stride'])}) checkpointed")
        del res, a, s, state, mesh  # the preemption

    final = load_checkpoint(path, mesh=make_mesh(device=dev.type))
    got = [x.full_tensor() for x in final["x"]]
    dA = float(torch.max(torch.abs(got[0] - ref_x[0])))
    dS = float(torch.max(torch.abs(got[1] - ref_x[1])))
    print(f"max |resumed - uninterrupted|: A {dA:.3g}, S {dS:.3g}")
    assert dA == 0.0 and dS == 0.0, "resume drifted!"
    print("exact: preempted trajectory == uninterrupted trajectory")
    return {"ranks": n_dev, "total": total, "loss": ref.loss, "dA": dA,
            "dS": dS, "seg_ends": seg_ends}


if __name__ == "__main__":
    main(*map(int, positional(sys.argv[1:])), cpu="--cpu" in sys.argv,
         ranks=ranks_option(sys.argv))
