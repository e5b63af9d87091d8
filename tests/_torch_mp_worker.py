"""One rank of the multi-process runs of ``test_torch_distributed.py``.

Usage: ``python _torch_mp_worker.py STORE WORLD RANK DIR LAYOUT``. Joins a
gloo group of WORLD ranks through the file store STORE, reads the problem
from ``DIR/inputs.npz``, runs the sharded solves of LAYOUT (``1d``: two
ranks on ``('data',)``; ``2x2``: four ranks on ``('data', 'model')`` and on
``('dcn', 'data')``) and writes this rank's shards with their offsets, the
results and the all-reduce counts to ``DIR/rank<RANK>.npz``. Imports torch
and the port only.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

store, world, rank, out_dir, layout = sys.argv[1:6]
world, rank = int(world), int(rank)
torch.set_num_threads(1)

from proxmin_tpu_torch import nmf as tnmf  # noqa: E402
from proxmin_tpu_torch import parallel as tpar  # noqa: E402
from proxmin_tpu_torch.checkpoint import (load_checkpoint,  # noqa: E402
                                          save_checkpoint)
from proxmin_tpu_torch.interop import state_from_numpy  # noqa: E402
from proxmin_tpu_torch.parallel.sharding import _shard_index  # noqa: E402

info = tpar.initialize_distributed(f"file://{store}", world, rank)
assert info == tpar.initialize_distributed(), "not idempotent"
assert info == tpar.DistributedInfo(rank, world, 1, world), info

inp = np.load(f"{out_dir}/inputs.npz")
Y, A0, S0, W = (inp[k] for k in ("Y", "A0", "S0", "W"))
out = {}

CALLS = []
_real_all_reduce = dist.all_reduce


def _counted(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
    CALLS.append((tensor.numel(), 1 if op == dist.ReduceOp.MAX else 0))
    return _real_all_reduce(tensor, op=op, group=group, async_op=async_op)


dist.all_reduce = _counted


def record(case, res, mesh, data_axis="data", model_axis=None):
    """This rank's shards of ``res.x`` with their global offsets, and the
    result's scalars."""
    A, S = (x.to_local().numpy() for x in res.x)
    out[f"{case}:A"] = A
    out[f"{case}:S"] = S
    out[f"{case}:a_off"] = np.array(
        [_shard_index(mesh, model_axis) * A.shape[0]])
    out[f"{case}:s_off"] = np.array(
        [_shard_index(mesh, data_axis) * S.shape[1]])
    out[f"{case}:meta"] = np.array([res.iterations, *res.converged,
                                    res.loss])
    out[f"{case}:status"] = np.array(res.status)


def run(case, solve, mesh, **kw):
    res = solve(Y, A0.copy(), S0.copy(), mesh=mesh, **kw)
    record(case, res, mesh, kw.get("data_axis", "data"),
           kw.get("model_axis"))
    return res


def count(case, solve, mesh, **kw):
    """The all-reduces of 10 more iterations."""
    seen = []
    for n in (10, 20):
        CALLS.clear()
        solve(Y, A0.copy(), S0.copy(), mesh=mesh, e_rel=0, max_iter=n, **kw)
        seen.append(list(CALLS))
    out[f"{case}:calls"] = np.array(seen[1][len(seen[0]):])


def jax_state(prefix):
    """A JAX sharded state the test process saved as NumPy arrays."""
    st = {k.split(":", 1)[1]: inp[k] for k in inp.files
          if k.startswith(prefix + ":")}
    st["kind"] = str(st["kind"])
    return st


pgm, ada = tpar.nmf_pgm_sharded, tpar.nmf_adaprox_sharded
if layout == "1d":
    mesh = tpar.make_mesh(device="cpu")
    run("pgm", pgm, mesh, e_rel=0, max_iter=30)
    run("pgm_w", pgm, mesh, W=W, e_rel=0, max_iter=15)
    run("pgm_stride", pgm, mesh, W=W, e_rel=0, max_iter=40, step_stride=10)
    run("pgm_adapt", pgm, mesh, W=W, e_rel=0, max_iter=40, step_stride=10,
        step_adapt=True)
    run("pgm_adapt_unw", pgm, mesh, e_rel=0, max_iter=40, step_adapt=True)
    run("pgm_early", pgm, mesh, e_rel=1e-2, max_iter=5000)
    run("ada", ada, mesh, e_rel=0, max_iter=20)
    run("ada_w", ada, mesh, W=W, e_rel=0, max_iter=20)
    # nmf(mesh=) writes the whole result back into the NumPy inputs
    An, Sn = A0.copy(), S0.copy()
    tnmf.nmf(Y, An, Sn, W=W, mesh=mesh, e_rel=0, max_iter=20,
             step_stride=10)
    out["nmf_mesh:A"], out["nmf_mesh:S"] = An, Sn
    # JAX states continued on two ranks: every rank takes its slice
    for case, solve, prefix, kw in (
            ("jax_resume", pgm, "jstate_pgm",
             dict(W=W, step_stride=10, step_adapt=True)),
            ("jax_resume_ada", ada, "jstate_ada", dict(W=W))):
        st = jax_state(prefix)
        res = solve(Y, inp[prefix + "_x:A"], inp[prefix + "_x:S"],
                    mesh=mesh, e_rel=0, max_iter=13,
                    state=state_from_numpy(st, mesh=mesh), **kw)
        record(case, res, mesh)
    count("pgm", pgm, mesh)
    count("pgm_w", pgm, mesh, W=W)
    count("ada", ada, mesh)
    # kill, save, load, resume: the straight run bit for bit
    kw = dict(W=W, mesh=mesh, e_rel=0, step_stride=10, step_adapt=True)
    full = pgm(Y, A0.copy(), S0.copy(), max_iter=24, **kw)
    half = pgm(Y, A0.copy(), S0.copy(), max_iter=11, **kw)
    path = save_checkpoint(f"{out_dir}/ckpt", x=half.x,
                           solver_state=half.state)
    del half
    ck = load_checkpoint(path, mesh=mesh)
    res = pgm(Y, *ck["x"], max_iter=13, state=ck["solver_state"], **kw)
    out["ckpt_bitwise"] = np.array(all(
        torch.equal(a.to_local(), b.to_local())
        for a, b in zip(res.x, full.x)) and res.loss == full.loss)
    try:
        tpar.shard_nmf_problem(mesh, Y[:, :-1], A0, S0[:, :-1])
        out["divides"] = np.array("no error")
    except ValueError as e:
        out["divides"] = np.array(str(e))
elif layout == "2x2":
    mesh = tpar.make_mesh((2, 2), device="cpu")
    tp = dict(model_axis="model")
    run("pgm", pgm, mesh, e_rel=0, max_iter=20, **tp)
    run("pgm_w", pgm, mesh, W=W, e_rel=0, max_iter=10, **tp)
    run("ada_w", ada, mesh, W=W, e_rel=0, max_iter=20, **tp)
    count("pgm", pgm, mesh, **tp)
    ml = tpar.make_mesh((2, 2), ("dcn", "data"), device="cpu")
    axes = dict(data_axis=("dcn", "data"))
    run("ml_pgm", pgm, ml, e_rel=0, max_iter=25, **axes)
    run("ml_pgm_w_stride", pgm, ml, W=W, e_rel=0, max_iter=30,
        step_stride=10, **axes)
    count("ml_pgm", pgm, ml, **axes)
else:
    raise SystemExit(f"unknown layout {layout}")

np.savez(f"{out_dir}/rank{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
print(f"rank {rank} OK", flush=True)
