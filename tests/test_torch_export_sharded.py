"""The two sharded exporters of proxmin_tpu_torch.export: one program per
rank, equal to the live sharded solve bit for bit.

Counterparts of the seven export tests of ``tests/test_sharding.py``
(:606-890): the runtime ``max_iter``, the weighted strided program, a
program served by fresh processes on two gloo ranks that import only
torch, the artifact-only resume, the 2-D mesh, the AdaProx program against
the live driver and its warm continuation. ``test_export_sharded_cross_
platform`` has no counterpart: a port program runs on the device it was
captured for (``platforms=`` may name only that device's type), so there
is no multi-platform artifact to lower. One rank runs in this process on a
gloo group through a file store (no port is opened); two ranks run in
subprocesses (``_torch_mp_worker.py``, layout ``export``), which also hold
each program against its live solve there. Every program is held against
its live sharded solve bit for bit, and in float64 against the JAX
package on a mesh of as many devices (its exported program, or the live
solve JAX's own tests hold that program to) at rtol 1e-9, with equal
iterations.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import proxmin_tpu as pt
import proxmin_tpu.parallel as jpar
import proxmin_tpu_torch as ptt
import proxmin_tpu_torch.parallel as tpar
from proxmin_tpu import export as jex
from proxmin_tpu_torch import export as tex

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = pathlib.Path(__file__).with_name("_torch_mp_worker.py")
C, K, N = 6, 3, 64
F64 = dict(rtol=1e-9, atol=0)
F64_ADA = dict(rtol=1e-9, atol=1e-12)   # as tests/test_sharding.py


@pytest.fixture(scope="module", autouse=True)
def _group(tmp_path_factory):
    """One gloo rank for the whole module, through a file store."""
    store = tmp_path_factory.mktemp("store") / "store"
    tpar.initialize_distributed(f"file://{store}", 1, 0)
    yield
    dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem():
    rng = np.random.default_rng(7)
    Y = rng.random((C, K)) @ rng.random((K, N)) \
        + 0.01 * rng.standard_normal((C, N))
    A0, S0 = rng.random((C, K)), rng.random((K, N))
    W = 0.5 + rng.random((C, N))
    return Y, A0, S0, W


def _mesh(shape=None):
    return tpar.make_mesh(shape, device="cpu")


def _jmesh(shape=(1,), n=1):
    names = ("data", "model") if len(shape) == 2 else None
    return jpar.make_mesh(shape, names, devices=jax.devices("cpu")[:n])


def _same(got, want):
    """Two sequences of (D)tensors, equal bit for bit."""
    for g, w in zip(got, want):
        g = g.to_local() if hasattr(g, "to_local") else g
        w = w.to_local() if hasattr(w, "to_local") else w
        assert torch.equal(g, w)


def _np(x):
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _held_jax(got, want, tol=F64):
    """Two sequences of arrays (port, JAX) at ``tol``."""
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=str(i),
                                   **tol)


def _held_jax_solve(A, S, it, loss, rj):
    """A program's iterates, clock and loss against a JAX solve."""
    _held_jax((A, S), rj.x)
    assert int(it) == rj.iterations
    np.testing.assert_allclose(float(loss), rj.loss, **F64)


def _jax_program(blob, jmesh, arrays, specs, n_iter):
    """A JAX sharded artifact called on ``arrays`` laid out by ``specs``
    (PartitionSpec tuples) and a replicated ``max_iter``."""
    from jax import export as jax_export
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    put = lambda x, spec: jax.device_put(  # noqa: E731
        jnp.asarray(x), NamedSharding(jmesh, P(*spec)))
    args = [put(a, sp) for a, sp in zip(arrays, specs)]
    return jax_export.deserialize(blob).call(*args, put(jnp.int32(n_iter),
                                                        ()))


def test_export_sharded_roundtrip_runtime_max_iter():
    """One program serves any iteration budget and equals
    nmf_pgm_sharded bit for bit, its loss too, and JAX's sharded artifact
    of the same solve at rtol 1e-9."""
    Y, A0, S0, _ = _problem()
    mesh = _mesh()
    call = tex.load_solver(tex.export_nmf_pgm_sharded(
        mesh, C, K, N, e_rel=0.0, dtype=torch.float64))
    jblob = jex.export_nmf_pgm_sharded(_jmesh(), C, K, N, e_rel=0.0,
                                       dtype=jnp.float64)
    Yd, Ad, Sd, _ = tpar.shard_nmf_problem(mesh, Y, A0, S0)
    for n in (7, 20):
        A1, S1, it, cA, cS, loss = call(Ad, Sd, Yd, n)
        assert int(it) == n
        ref = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                                   e_rel=0, max_iter=n)
        _same((A1, S1), ref.x)
        assert float(loss) == ref.loss
        assert (bool(cA), bool(cS)) == tuple(ref.converged)
        assert A1.placements == Ad.placements
        jo = _jax_program(jblob, _jmesh(), (A0, S0, Y),
                          ((None, None), (None, "data"), (None, "data")), n)
        _held_jax((A1, S1, loss), (jo[0], jo[1], jo[5]))
        assert int(jo[2]) == n
        assert (bool(jo[3]), bool(jo[4])) == (bool(cA), bool(cS))


def test_export_sharded_weighted_strided():
    """Weighted with the strided refresh: the carries follow the loss and
    the program equals the live solve, and JAX's, carries included."""
    Y, A0, S0, W = _problem()
    mesh = _mesh()
    call = tex.load_solver(tex.export_nmf_pgm_sharded(
        mesh, C, K, N, e_rel=0.0, weighted=True, step_stride=4,
        dtype=torch.float64))
    Yd, Ad, Sd, Wd = tpar.shard_nmf_problem(mesh, Y, A0, S0, W)
    outs = call(Ad, Sd, Yd, Wd, 13)
    assert len(outs) == 11 and int(outs[2]) == 13
    ref = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                               e_rel=0, max_iter=13, step_stride=4)
    _same(outs[:2], ref.x)
    assert float(outs[5]) == ref.loss
    st = ref.state
    assert float(outs[6]) == float(st["step_A"])
    assert int(outs[8]) == st["stride"] and int(outs[9]) == st["seg_end"]
    _same(outs[10:], (st["v"],))
    rj = jpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=_jmesh(),
                              e_rel=0, max_iter=13, step_stride=4)
    _held_jax_solve(outs[0], outs[1], outs[2], outs[5], rj)
    js = rj.state
    _held_jax((outs[6], outs[7], outs[10]),
              (js["step_A"], js["step_S"], js["v"]))
    assert (int(outs[8]), int(outs[9])) == (int(js["stride"]),
                                            int(js["seg_end"]))


def _spawn(tmp, world, layout):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(tmp / f"store_{layout}"),
         str(world), str(r), str(tmp), layout], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def _gathered(outs, case):
    """The whole (A, S) of a two-rank program from the ranks' shards (A
    replicated: the same bits on every rank)."""
    for o in outs[1:]:
        assert np.array_equal(o[f"{case}:A"], outs[0][f"{case}:A"]), case
    order = sorted(outs, key=lambda o: int(o[f"{case}:s_off"][0]))
    return outs[0][f"{case}:A"], np.concatenate(
        [o[f"{case}:S"] for o in order], axis=1)


SERVE = """
import sys
import numpy as np
import torch
import torch.distributed as dist
store, rank, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=2, rank=rank)
run = torch.export.load(f"{d}/pgm_rank{rank}.pt2").module()
p = np.load(f"{d}/inputs.npz")
Y, A, S = (p[k] for k in ("Y", "A0", "S0"))
n = S.shape[1] // 2
cols = slice(rank * n, (rank + 1) * n)
S_l, Y_l = (np.ascontiguousarray(x[:, cols]) for x in (S, Y))
out = run(torch.from_numpy(A), torch.from_numpy(S_l), torch.from_numpy(Y_l),
          torch.tensor(15, dtype=torch.int32))
assert not [m for m in sys.modules if m.startswith("proxmin")]
np.savez(f"{d}/served{rank}.npz", A=out[0].numpy(), S=out[1].numpy(),
         it=out[2].numpy())
dist.barrier()
dist.destroy_process_group()
print("served-sharded")
"""


def test_export_sharded_serves_without_library(tmp_path):
    """Two ranks export their programs beside the live solves (each equal
    to its live solve bit for bit there: the exact PGM program, and the
    weighted AMSGrad program against the live driver); two fresh
    processes that import only torch then serve the saved programs on a
    gloo group of their own and give the live solve's shards back bit for
    bit. Both programs' results, put together from the two ranks' shards,
    equal JAX's solves on two devices at rtol 1e-9. A group of another
    size refuses a program, naming both sizes."""
    Y, A0, S0, W = _problem()
    np.savez(tmp_path / "inputs.npz", Y=Y, A0=A0, S0=S0, W=W)
    outs = _spawn(tmp_path, 2, "export")
    for o in outs:
        for case in ("export_pgm", "export_adaprox"):
            assert bool(o[f"{case}:bitwise"]), case
    jmesh = _jmesh(n=2)
    rj = jpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=jmesh, e_rel=0,
                              max_iter=15)
    it, cA, cS, loss = outs[0]["export_pgm:meta"]
    _held_jax_solve(*_gathered(outs, "export_pgm"), it, loss, rj)
    assert (bool(cA), bool(cS)) == tuple(rj.converged)
    ra = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, mesh=jmesh,
                    algorithm="adaprox", scheme="amsgrad", e_rel=0,
                    max_iter=12)
    _held_jax(_gathered(outs, "export_adaprox"), ra.x, F64_ADA)
    assert int(outs[0]["export_adaprox:meta"][0]) == ra.iterations == 12
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", SERVE, str(tmp_path / "serve_store"), str(r),
         str(tmp_path)], env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "served-sharded" in log, log[-3000:]
        served = np.load(tmp_path / f"served{r}.npz")
        assert int(served["it"]) == 15
        np.testing.assert_array_equal(served["A"], outs[r]["export_pgm:A"])
        np.testing.assert_array_equal(served["S"], outs[r]["export_pgm:S"])
    blob = (tmp_path / "pgm_rank0.pt2").read_bytes()
    with pytest.raises(ValueError, match="2 ranks.*has 1"):
        tex.load_solver(blob)


def test_export_sharded_artifact_only_resume():
    """A weighted strided program runs 10 iterations, its outputs from
    position 2 on feed the resume program for 15 more, and the result is
    the live uninterrupted 25 bit for bit, and JAX's 25 at rtol 1e-9."""
    Y, A0, S0, W = _problem()
    mesh = _mesh()
    kw = dict(e_rel=0.0, weighted=True, step_stride=4, dtype=torch.float64)
    fresh = tex.load_solver(tex.export_nmf_pgm_sharded(mesh, C, K, N, **kw))
    cont = tex.load_solver(tex.export_nmf_pgm_sharded(mesh, C, K, N,
                                                      resume=True, **kw))
    Yd, Ad, Sd, Wd = tpar.shard_nmf_problem(mesh, Y, A0, S0, W)
    outs = fresh(Ad, Sd, Yd, Wd, 10)
    assert int(outs[2]) == 10
    outs2 = cont(outs[0], outs[1], Yd, Wd, 15, *outs[2:])
    assert int(outs2[2]) == 25
    ref = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                               e_rel=0, max_iter=25, step_stride=4)
    _same(outs2[:2], ref.x)
    rj = jpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=_jmesh(),
                              e_rel=0, max_iter=25, step_stride=4)
    _held_jax_solve(outs2[0], outs2[1], outs2[2], outs2[5], rj)
    # the live solve's state feeds the resume program as well
    half = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                                e_rel=0, max_iter=10, step_stride=4)
    st = half.state
    outs3 = cont(*half.x, Yd, Wd, 15, st["it"], st["conv_A"], st["conv_S"],
                 st["loss"], st["step_A"], st["step_S"], st["stride"],
                 st["seg_end"], st["v"])
    _same(outs3[:2], ref.x)


def test_export_sharded_2d_mesh():
    """A program of a data x model mesh (A and Y channel-sharded) equals
    the live 2-D solve, and JAX's on a data x model mesh."""
    Y, A0, S0, _ = _problem()
    mesh = _mesh((1, 1))
    call = tex.load_solver(tex.export_nmf_pgm_sharded(
        mesh, C, K, N, e_rel=0.0, model_axis="model", dtype=torch.float64))
    Yd, Ad, Sd, _ = tpar.shard_nmf_problem(mesh, Y, A0, S0,
                                           model_axis="model")
    out = call(Ad, Sd, Yd, 12)
    ref = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                               model_axis="model", e_rel=0, max_iter=12)
    _same(out[:2], ref.x)
    assert out[0].placements == ref.x[0].placements
    rj = jpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=_jmesh((1, 1)),
                              model_axis="model", e_rel=0, max_iter=12)
    _held_jax_solve(out[0], out[1], out[2], out[5], rj)


@pytest.mark.parametrize("scheme", ["adam", "radam"])
def test_export_sharded_adaprox_matches_live_driver(scheme):
    """The AdaProx program (runtime max_iter, constant b1) equals the live
    driver on the sharded inputs bit for bit, and JAX's sharded artifact
    (iterates, moments, clock and flags) and its single-device solve at
    rtol 1e-9."""
    Y, A0, S0, _ = _problem()
    mesh = _mesh()
    call = tex.load_solver(tex.export_nmf_adaprox_sharded(
        mesh, C, K, N, e_rel=0.0, scheme=scheme, dtype=torch.float64))
    jblob = jex.export_nmf_adaprox_sharded(_jmesh(), C, K, N, e_rel=0.0,
                                           scheme=scheme, dtype=jnp.float64)
    Yd, Ad, Sd, _ = tpar.shard_nmf_problem(mesh, Y, A0, S0)
    for n_it in (6, 20):
        out = call(Ad, Sd, Yd, n_it)
        assert int(out[8]) == n_it
        live = ptt.nmf.nmf(Yd, Ad, Sd, algorithm="adaprox", scheme=scheme,
                           e_rel=0, max_iter=n_it)
        _same(out[:2], live.x)
        jo = _jax_program(jblob, _jmesh(), (A0, S0, Y),
                          ((None, None), (None, "data"), (None, "data")),
                          n_it)
        _held_jax(out[:8], jo[:8], F64_ADA)
        assert [int(out[8]), *map(bool, out[9:12])] == [
            int(jo[8]), *map(bool, jo[9:12])]
        jl = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                        scheme=scheme, e_rel=0, max_iter=n_it)
        _held_jax(out[:2], jl.x, F64_ADA)


def test_export_sharded_adaprox_warm_continuation():
    """Program-only preemption: a fresh program's 8 iterations, their
    moments, clock and flags into the warm_start program for 12 more,
    equal the live driver's 20 bit for bit, and JAX's 20 at rtol 1e-9."""
    Y, A0, S0, W = _problem()
    mesh = _mesh()
    kw = dict(e_rel=0.0, weighted=True, scheme="amsgrad",
              dtype=torch.float64)
    fresh = tex.load_solver(tex.export_nmf_adaprox_sharded(mesh, C, K, N,
                                                           **kw))
    cont = tex.load_solver(tex.export_nmf_adaprox_sharded(
        mesh, C, K, N, warm_start=True, **kw))
    Yd, Ad, Sd, Wd = tpar.shard_nmf_problem(mesh, Y, A0, S0, W)
    o = fresh(Ad, Sd, Yd, Wd, 8)
    o2 = cont(o[0], o[1], Yd, Wd, 12, *o[2:])
    assert int(o2[8]) == 20
    live = ptt.nmf.nmf(Yd, Ad, Sd, W=Wd, algorithm="adaprox",
                       scheme="amsgrad", e_rel=0, max_iter=20)
    _same(o2[:2], live.x)
    jl = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, mesh=_jmesh(),
                    algorithm="adaprox", scheme="amsgrad", e_rel=0,
                    max_iter=20)
    _held_jax(o2[:2], jl.x, F64_ADA)
    assert int(o2[8]) == jl.iterations
    # local shards in, local shards out
    o3 = cont(*(x.to_local() for x in (o[0], o[1], Yd, Wd)), 12,
              *(x.to_local() if hasattr(x, "to_local") else x
                for x in o[2:]))
    _same(o3[:2], live.x)


def test_export_sharded_refusals():
    """A mesh is required, a b1 schedule and a foreign platform raise."""
    mesh = _mesh()
    with pytest.raises(ValueError, match="mesh"):
        tex.export_nmf_pgm_sharded(None, C, K, N)
    with pytest.raises(ValueError, match="constant b1"):
        tex.export_nmf_adaprox_sharded(mesh, C, K, N, b1=[0.9] * 3)
    with pytest.raises(ValueError, match="platforms"):
        tex.export_nmf_pgm_sharded(mesh, C, K, N, platforms=("tpu", "cpu"))
