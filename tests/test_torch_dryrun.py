"""proxmin_tpu_torch.dryrun against the JAX package's ``__graft_entry__``.

``dryrun_multichip(n)`` runs the sharded PGM-NMF training step, unweighted
and weighted, and a 3-iteration sharded solve on n gloo ranks on the CPU,
one process each (a 1-D mesh of 2, a 2 x 2 ``('data', 'model')`` mesh of
4). Each step's whole result is held against JAX's ``make_nmf_pgm_step``
on a mesh of as many virtual devices at float32 rtol 1e-5, and the solve
against JAX's ``nmf_pgm_sharded``. ``entry()`` is held against the JAX
entry's step on the same arguments.
"""

import jax
import numpy as np
import pytest
import torch

import proxmin_tpu.parallel as jpar
from proxmin_tpu_torch import dryrun

F32 = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_matches_jax(n):
    got = dryrun.dryrun_multichip(n)
    shape, names, model_axis, dp, tp = dryrun._layout(n)
    mesh = jpar.make_mesh(shape=shape, axis_names=names,
                          devices=jax.devices("cpu")[:n])
    Y, A, S, W = dryrun._problem(dp, tp)
    for weighted in (False, True):
        step = jpar.make_nmf_pgm_step(mesh, weighted=weighted,
                                      model_axis=model_axis)
        Ys, As, Ss, Ws = jpar.shard_nmf_problem(
            mesh, Y, A, S, W if weighted else None, model_axis=model_axis)
        A1, S1, loss = step(As, Ss, Ys, Ws if weighted else None)
        gA, gS, gloss = got["weighted" if weighted else "unweighted"]
        np.testing.assert_allclose(gA, np.asarray(A1), **F32)
        np.testing.assert_allclose(gS, np.asarray(S1), **F32)
        np.testing.assert_allclose(gloss, float(loss), rtol=1e-5)
    ref = jpar.nmf_pgm_sharded(Y, A.copy(), S.copy(), mesh=mesh,
                               model_axis=model_axis, e_rel=0, max_iter=3)
    sA, sS, its = got["solve"]
    assert its == ref.iterations == 3
    np.testing.assert_allclose(sA, np.asarray(ref.x[0]), **F32)
    np.testing.assert_allclose(sS, np.asarray(ref.x[1]), **F32)


def test_entry_matches_jax():
    """The flagship step of ``entry(device="cpu")`` against the JAX
    entry's on the same float32 arguments."""
    import __graft_entry__ as graft

    fn, args = dryrun.entry(device="cpu")
    jfn, jargs = graft.entry()
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    for g, w in zip(fn(*args), jax.jit(jfn)(*jargs)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


# parallel.distributed.run_ranks, which starts the dry run's ranks and the
# examples'; its rank functions live at module level so that the spawned
# ranks unpickle them

def _rank_sum(rank, n, work, base):
    import os

    import torch.distributed as dist

    t = torch.tensor([float(base + rank)])
    dist.all_reduce(t)
    return rank, n, float(t), os.getpid(), os.path.isdir(work)


def _rank_fails(rank, n, work):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def test_run_ranks_returns_rank_zeros_value():
    """Two gloo ranks in processes of their own: rank 0's value comes
    back, after an all-reduce over both, with the shared directory."""
    import os

    from proxmin_tpu_torch.parallel.distributed import run_ranks

    rank, n, total, pid, shared = run_ranks(_rank_sum, 2, (10,))
    assert (rank, n, total, shared) == (0, 2, 21.0, True)
    assert pid != os.getpid()


def test_run_ranks_one_rank_runs_in_this_process():
    """A one-rank group runs here and leaves no group behind."""
    import os

    import torch.distributed as dist

    from proxmin_tpu_torch.parallel.distributed import run_ranks

    assert run_ranks(_rank_sum, 1, (5,))[:4] == (0, 1, 5.0, os.getpid())
    assert not dist.is_initialized()


def test_run_ranks_failing_rank_raises():
    """A rank that raises fails the call with its error."""
    from proxmin_tpu_torch.parallel.distributed import run_ranks

    with pytest.raises(Exception, match="rank 1 fails"):
        run_ranks(_rank_fails, 2)
