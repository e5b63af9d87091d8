"""The flagship step as one function, and a multi-rank dry run on the CPU.

Counterpart of the JAX package's ``__graft_entry__``. :func:`entry` returns
the PGM-NMF step that ``bench.py`` measures (residual, both factor
gradients, the Lipschitz steps, the prox, the loss) with its example
arguments, on the card unless ``device="cpu"``. :func:`dryrun_multichip`
runs the sharded training step on ``n`` gloo ranks on the CPU, one process
each, on a 2-D ``('data', 'model')`` mesh when ``n`` is even and at least
4 (else 1-D): the unweighted and the weighted explicit step, then a
3-iteration sharded solve. The ranks join through a file store in a
temporary directory, so no port is opened; a rank that fails fails the
call. Run it as ``python -m proxmin_tpu_torch.dryrun [N]``.
"""

import logging
import os
import pickle
import sys
import tempfile

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]

# ranks still running this long after they were started are stopped (a
# rank process takes seconds to start; the run itself well under a minute)
_TIMEOUT_S = 600


def entry(device=None):
    """``(fn, (A, S, Y))``: the single-card PGM-NMF step ``fn(A, S, Y) ->
    (A', S', loss)`` at C 8, K 8, N 4096 in float32, the arguments on
    ``device`` (the card unless ``device="cpu"``)."""
    from .nmf import log_likelihood, pgm_nmf_iteration
    from .solvers.common import default_device

    C, N, K = 8, 4096, 8

    def pgm_nmf_step(A, S, Y):
        A_new, S_new, _ = pgm_nmf_iteration(A, S, Y)
        return A_new, S_new, log_likelihood(A_new, S_new, Y=Y)

    dev = default_device(device)
    rng = np.random.default_rng(0)
    A, S, Y = (torch.as_tensor(rng.random(shape), dtype=torch.float32,
                               device=dev)
               for shape in ((C, K), (K, N), (C, N)))
    return pgm_nmf_step, (A, S, Y)


def _layout(n):
    """``(mesh shape, axis names, model axis, dp, tp)`` of an n-rank run."""
    if n >= 4 and n % 2 == 0:
        return (n // 2, 2), ("data", "model"), "model", n // 2, 2
    return (n,), ("data",), None, n, 1


def _problem(dp, tp):
    """The dry run's data: C = 4 tp, K = 3, N = 16 dp, float32, seed 0."""
    C, K, N = 4 * tp, 3, 16 * dp
    rng = np.random.default_rng(0)
    Y = rng.random((C, N)).astype(np.float32)
    A = rng.random((C, K)).astype(np.float32)
    S = rng.random((K, N)).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    return Y, A, S, W


class _ExpectedNonConvergence(logging.Filter):
    # the 3-iteration solve runs e_rel=0 by design
    def filter(self, record):
        return "did not converge" not in record.getMessage()


def _dryrun_rank(rank, n, work):
    """One rank of :func:`dryrun_multichip`; rank 0 writes the whole
    results to ``work/result.pkl``."""
    import torch.distributed as dist

    from .parallel import (initialize_distributed, make_mesh,
                           make_nmf_pgm_step, nmf_pgm_sharded,
                           shard_nmf_problem)

    torch.set_num_threads(1)
    initialize_distributed(f"file://{work}/store", n, rank, backend="gloo")
    try:
        shape, names, model_axis, dp, tp = _layout(n)
        mesh = make_mesh(shape, names, device="cpu")
        Y, A, S, W = _problem(dp, tp)
        out = {}
        for weighted in (False, True):
            step = make_nmf_pgm_step(mesh, weighted=weighted,
                                     model_axis=model_axis)
            Ys, As, Ss, Ws = shard_nmf_problem(
                mesh, Y, A, S, W if weighted else None,
                model_axis=model_axis)
            A1, S1, loss = step(As, Ss, Ys, Ws if weighted else None)
            assert np.isfinite(float(loss))
            assert tuple(A1.shape) == A.shape and tuple(S1.shape) == S.shape
            out["weighted" if weighted else "unweighted"] = (
                A1.full_tensor().numpy(), S1.full_tensor().numpy(),
                float(loss))
        log = logging.getLogger("proxmin")
        flt = _ExpectedNonConvergence()
        log.addFilter(flt)
        try:
            res = nmf_pgm_sharded(Y, A.copy(), S.copy(), mesh=mesh,
                                  model_axis=model_axis, e_rel=0,
                                  max_iter=3)
        finally:
            log.removeFilter(flt)
        assert res.iterations == 3
        out["solve"] = (res.x[0].full_tensor().numpy(),
                        res.x[1].full_tensor().numpy(), res.iterations)
        if rank == 0:
            with open(os.path.join(work, "result.pkl"), "wb") as fh:
                pickle.dump(out, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices):
    """Run one sharded PGM-NMF training step, unweighted and weighted, and
    a 3-iteration sharded solve on ``n_devices`` gloo ranks on the CPU
    (one process each). Returns rank 0's whole results, ``{"unweighted":
    (A', S', loss), "weighted": (A', S', loss), "solve": (A, S,
    iterations)}`` as NumPy arrays; a rank that fails raises here, and
    ranks still running after ``_TIMEOUT_S`` seconds are stopped and raise
    ``TimeoutError``."""
    import time

    import torch.multiprocessing as mp

    n = int(n_devices)
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    with tempfile.TemporaryDirectory() as work:
        ctx = mp.spawn(_dryrun_rank, args=(n, work), nprocs=n, join=False)
        deadline = time.monotonic() + _TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
            if time.monotonic() >= deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"dryrun_multichip({n}): the ranks ran "
                                   f"past {_TIMEOUT_S} s")
        with open(os.path.join(work, "result.pkl"), "rb") as fh:
            out = pickle.load(fh)
    shape, _, _, dp, tp = _layout(n)
    print(f"dryrun ok: {n}-rank mesh {shape} (dp={dp}, tp={tp}), "
          "unweighted + weighted sharded steps + 3-iteration sharded solve "
          "all executed (fixed-iteration by design)")
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
