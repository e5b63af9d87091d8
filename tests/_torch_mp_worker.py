"""One rank of the multi-process runs of ``test_torch_distributed.py``.

Usage: ``python _torch_mp_worker.py STORE WORLD RANK DIR LAYOUT``. Joins a
gloo group of WORLD ranks through the file store STORE, reads the problem
from ``DIR/inputs.npz``, runs the sharded solves of LAYOUT (``1d``: two
ranks on ``('data',)``; ``2x2``: four ranks on ``('data', 'model')`` and on
``('dcn', 'data')``; ``auto1d`` and ``auto2x2``: the auto-SPMD routes on
those meshes, and the collectives that DTensor issues in them on a
pixel-only mesh of every rank; ``export``: the per-rank programs of the
two sharded exporters beside their live solves) and writes this rank's
shards with their offsets, the results and the collective counts to
``DIR/rank<RANK>.npz``. Imports torch and the port only.
"""

import functools
import sys

import numpy as np
import torch
import torch.distributed as dist

store, world, rank, out_dir, layout = sys.argv[1:6]
world, rank = int(world), int(rank)
torch.set_num_threads(1)

from torch.distributed.tensor import (DTensor, Shard,  # noqa: E402
                                      distribute_tensor)
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import proxmin_tpu_torch as ptt  # noqa: E402
from proxmin_tpu_torch import nmf as tnmf  # noqa: E402
from proxmin_tpu_torch import operators as top  # noqa: E402
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


def record_x(case, x, mesh, data_axis="data", model_axis=None):
    """This rank's shards of ``x = (A, S)`` with their global offsets."""
    A, S = (t.to_local().numpy() for t in x)
    out[f"{case}:A"] = A
    out[f"{case}:S"] = S
    out[f"{case}:a_off"] = np.array(
        [_shard_index(mesh, model_axis) * A.shape[0]])
    out[f"{case}:s_off"] = np.array(
        [_shard_index(mesh, data_axis) * S.shape[1]])


def record(case, res, mesh, data_axis="data", model_axis=None):
    """This rank's shards of ``res.x`` with their global offsets, and the
    result's scalars."""
    record_x(case, res.x, mesh, data_axis, model_axis)
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


def half_steps(*X, it=None):
    """Both factors' steps at half their Lipschitz bounds: FISTA converges
    on this problem from there (at the bounds it diverges)."""
    return tuple(0.5 * s for s in tnmf.step_pgm(*X))


# the auto-SPMD option sets of nmf(mesh=), by name (the test process
# holds the same calls of the JAX package); e_rel 0 and 10 iterations
# unless a set says otherwise
ROUTES = {
    "bsdmm": {"algorithm": "bsdmm"},
    "bsdmm_w": {"algorithm": "bsdmm", "W": W},
    "nonseparable": {"algorithm": "adaprox", "separable_prox": False},
    "amsgrad": {"algorithm": "adaprox", "scheme": "amsgrad"},
    "adaprox_stride": {"algorithm": "adaprox", "step_stride": 5},
    "step": {"step": lambda *X, it=None: (0.1, 0.1)},
    "accelerated": {"accelerated": True},
    "accelerated_converging": {"accelerated": True, "step": half_steps,
                               "e_rel": 1e-5, "max_iter": 2000},
    "callback": {"callback": lambda *X, it=None: None},
}
COLLECTIVES = ("all_reduce", "all_reduce_coalesced", "all_gather_into_tensor",
               "all_gather_into_tensor_coalesced", "reduce_scatter_tensor",
               "reduce_scatter_tensor_coalesced", "all_to_all_single",
               "broadcast")


class Collectives(TorchDispatchMode):
    """The collectives that DTensor issues inside the block, as ``(op,
    elements)``: DTensor desugars its redistributions into functional
    collectives on plain tensors, which this mode sees after it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        name = str(func).split(".")
        if name[0] == "_c10d_functional" and name[1] in COLLECTIVES:
            self.seen.append((name[1], args[0].numel()))
        return func(*args, **(kwargs or {}))


def route(case, mesh, name, **extra):
    """nmf(mesh=) of one option set on NumPy inputs, which take the whole
    result back."""
    kw = {"e_rel": 0, "max_iter": 10, **ROUTES[name], **extra}
    An, Sn = A0.copy(), S0.copy()
    res = tnmf.nmf(Y, An, Sn, mesh=mesh, **kw)
    out[f"{case}:A"], out[f"{case}:S"] = An, Sn
    out[f"{case}:meta"] = np.array([res.iterations])
    out[f"{case}:status"] = np.array(res.status)


def admm_family(case, mesh, placements, x0):
    """admm and sdmm on a sharded x, as tests/test_sharding.py:314-416."""
    def prox_f(v, step):
        return (v + step) / (1 + step)

    def cap(v, step):
        return torch.clamp_max(v, 0.8)

    for kind, solve in (("admm", lambda x: ptt.admm(
            x, prox_f, 0.5, prox_g=cap, e_rel=1e-6, max_iter=300)),
                        ("sdmm", lambda x: ptt.sdmm(
            x, prox_f, 0.5, proxs_g=[cap, top.prox_plus], e_rel=1e-6,
            max_iter=300))):
        res = solve(distribute_tensor(torch.from_numpy(x0.copy()), mesh,
                                      placements))
        out[f"{case}_{kind}:x"] = res.x.full_tensor().numpy()
        out[f"{case}_{kind}:meta"] = np.array([res.iterations])


def audit(mesh):
    """The collectives of each auto-SPMD solve on ``mesh`` (pixel-only),
    at the JAX audit's size (C 6, K 3, N 1024; tests/
    test_collective_layout.py:172-272): every (op, elements)."""
    rng = np.random.default_rng(3)
    C, K, N = 6, 3, 1024
    Ya, Aa, Sa = rng.random((C, N)), rng.random((C, K)), rng.random((K, N))
    Yd, Ad, Sd, _ = tpar.shard_nmf_problem(mesh, Ya, Aa, Sa)
    B = distribute_tensor(torch.from_numpy(Ya[:K].copy()), mesh, [Shard(1)])

    def prox_f(x, step):
        return (x + step * B) / (1.0 + step)

    solves = {
        "pgm": lambda: tnmf.nmf(Yd, Ad, Sd, e_rel=1e-4, max_iter=5),
        "adaprox": lambda: tnmf.nmf(Yd, Ad, Sd, algorithm="adaprox",
                                    e_rel=1e-4, max_iter=5),
        "bsdmm": lambda: tnmf.nmf(Yd, Ad, Sd, algorithm="bsdmm", e_rel=1e-4,
                                  max_iter=5),
        "admm": lambda: ptt.admm(Sd, prox_f, 0.5, prox_g=top.prox_plus,
                                 e_rel=1e-6, max_iter=5),
        "sdmm": lambda: ptt.sdmm(Sd, prox_f, 0.5, proxs_g=[
            top.prox_plus, functools.partial(top.prox_max, thresh=2.0)],
            e_rel=1e-6, max_iter=5),
    }
    for name, solve in solves.items():
        mode = Collectives()
        with mode:
            solve()
        out[f"audit_{name}:ops"] = np.array([o for o, _ in mode.seen] or
                                            ["none"])
        out[f"audit_{name}:sizes"] = np.array([n for _, n in mode.seen] or
                                              [0])


def export_case(mesh):
    """The two sharded exporters' per-rank programs, served here and saved
    for a fresh process, beside the live sharded solves; each program's
    shards and scalars for the test process to hold against JAX."""
    from proxmin_tpu_torch import export as tex

    Yd, Ad, Sd, Wd = tpar.shard_nmf_problem(mesh, Y, A0, S0, W)
    C, K = A0.shape
    N = S0.shape[1]
    blob = tex.export_nmf_pgm_sharded(mesh, C, K, N, e_rel=0.0,
                                      dtype=torch.float64)
    tex.save_exported(f"{out_dir}/pgm_rank{rank}.pt2", blob)
    live = pgm(Y, A0.copy(), S0.copy(), mesh=mesh, e_rel=0, max_iter=15)
    got = tex.load_solver(blob)(Ad, Sd, Yd, 15)
    out["export_pgm:bitwise"] = np.array(all(
        torch.equal(a.to_local(), b.to_local())
        for a, b in zip(got[:2], live.x)) and float(got[5]) == live.loss)
    record_x("export_pgm", got[:2], mesh)
    out["export_pgm:meta"] = np.array([int(got[2]), bool(got[3]),
                                       bool(got[4]), float(got[5])])
    # the AdaProx program (weighted, amsgrad) against the live driver
    call = tex.load_solver(tex.export_nmf_adaprox_sharded(
        mesh, C, K, N, e_rel=0.0, weighted=True, scheme="amsgrad",
        dtype=torch.float64))
    o = call(Ad, Sd, Yd, Wd, 12)
    live = tnmf.nmf(Yd, Ad, Sd, W=Wd, algorithm="adaprox", scheme="amsgrad",
                    e_rel=0, max_iter=12)
    out["export_adaprox:bitwise"] = np.array(int(o[8]) == 12 and all(
        torch.equal(a.to_local(), b.to_local())
        for a, b in zip(o[:2], live.x)))
    record_x("export_adaprox", o[:2], mesh)
    out["export_adaprox:meta"] = np.array([int(o[8]), bool(o[9]),
                                           bool(o[10])])


pgm, ada = tpar.nmf_pgm_sharded, tpar.nmf_adaprox_sharded
if layout == "auto1d":
    mesh = tpar.make_mesh(device="cpu")
    for name in ROUTES:
        route(f"auto_{name}", mesh, name)
    admm_family("auto", mesh, [Shard(1)], S0)
    audit(mesh)
elif layout == "auto2x2":
    mesh = tpar.make_mesh((2, 2), device="cpu")
    for name in ("bsdmm", "amsgrad", "accelerated",
                 "accelerated_converging"):
        route(f"tp_{name}", mesh, name, model_axis="model")
    admm_family("tp", mesh, [Shard(1), Shard(0)], Y)
    flat = tpar.make_mesh(device="cpu")
    for name in ("bsdmm_w", "amsgrad"):
        route(f"auto_{name}", flat, name)
    audit(flat)
elif layout == "export":
    export_case(tpar.make_mesh(device="cpu"))
elif layout == "1d":
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
