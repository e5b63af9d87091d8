"""proxmin_tpu_torch.parallel on several processes against
proxmin_tpu.parallel on a virtual CPU mesh of as many devices.

Two runs of subprocesses that import torch and the port only
(``_torch_mp_worker.py``): two gloo ranks on a ``('data',)`` mesh, and four
on a 2 x 2 ``('data', 'model')`` mesh (``model_axis``) and a 2 x 2
``('dcn', 'data')`` mesh (a multi-level pixel axis). Each rank writes its
shards with their offsets; this process puts them together and holds every
solve against JAX's on 2 or 4 of the test process's 8 virtual devices, in
float64 at rtol 1e-9 with equal ``iterations``, ``converged`` and
``status``, and the loss bit for bit equal on every rank. The two-rank run
also kills, saves, loads and resumes a sharded checkpoint bit for bit,
continues JAX states and counts the all-reduces per iteration (the pattern
of ``test_collective_layout.py``: only small ones, a pinned count). Two
more runs hold the auto-SPMD routes (the ordinary drivers on ``DTensor``
shards) against JAX on two and four devices, and audit the collectives
that DTensor issues in them: only all-reduces, none of the pixel axis's
size.
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
import proxmin_tpu_torch.parallel as tpar

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = pathlib.Path(__file__).with_name("_torch_mp_worker.py")
F64 = dict(rtol=1e-9, atol=0)
C, K, N = 6, 3, 64


def _problem():
    rng = np.random.default_rng(7)
    Y = rng.random((C, K)) @ rng.random((K, N)) \
        + 0.01 * rng.standard_normal((C, N))
    return Y, rng.random((C, K)), rng.random((K, N)), \
        0.5 + rng.random((C, N))


def _spawn(tmp, world, layout):
    """Run ``world`` ranks of the worker; returns each rank's outputs."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    store = tmp / f"store_{layout}"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(store), str(world), str(r),
         str(tmp), layout], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def _whole(outs, case):
    """The whole (A, S) of a case from every rank's shards; replicated
    copies must agree bit for bit."""
    parts = {}
    for name, off_key, axis in (("A", "a_off", 0), ("S", "s_off", 1)):
        whole = None
        for o in outs:
            x, off = o[f"{case}:{name}"], int(o[f"{case}:{off_key}"][0])
            if whole is None:
                whole = np.full((C, K) if name == "A" else (K, N), np.nan)
            idx = [slice(None)] * 2
            idx[axis] = slice(off, off + x.shape[axis])
            have = whole[tuple(idx)]
            seen = ~np.isnan(have)
            assert np.array_equal(have[seen], x[seen]), (case, name)
            whole[tuple(idx)] = x
        assert not np.isnan(whole).any(), (case, name)
        parts[name] = whole
    return parts["A"], parts["S"]


def _held(outs, case, rj):
    A, S = _whole(outs, case)
    np.testing.assert_allclose(A, np.asarray(rj.x[0]), err_msg=case, **F64)
    np.testing.assert_allclose(S, np.asarray(rj.x[1]), err_msg=case, **F64)
    metas = [o[f"{case}:meta"] for o in outs]
    for m in metas[1:]:
        assert m[-1] == metas[0][-1], f"{case}: loss differs across ranks"
    it, cA, cS, loss = metas[0]
    assert int(it) == rj.iterations, case
    assert (bool(cA), bool(cS)) == tuple(rj.converged), case
    assert str(outs[0][f"{case}:status"]) == rj.status, case
    np.testing.assert_allclose(loss, rj.loss, err_msg=case, **F64)


def _jax_state(state, prefix):
    """A JAX sharded state as NumPy entries of the workers' inputs."""
    out = {}
    for k, v in state.items():
        out[f"{prefix}:{k}"] = np.asarray(v)
    return out


def test_two_ranks_match_jax_on_two_devices(tmp_path):
    Y, A0, S0, W = _problem()
    jmesh = jpar.make_mesh(devices=jax.devices("cpu")[:2])
    jp, ja = jpar.nmf_pgm_sharded, jpar.nmf_adaprox_sharded
    adapt = dict(W=W, step_stride=10, step_adapt=True)
    half = jp(Y, A0.copy(), S0.copy(), mesh=jmesh, e_rel=0, max_iter=12,
              **adapt)
    half_a = ja(Y, A0.copy(), S0.copy(), W=W, mesh=jmesh, e_rel=0,
                max_iter=12)
    inputs = dict(Y=Y, A0=A0, S0=S0, W=W)
    for prefix, h in (("jstate_pgm", half), ("jstate_ada", half_a)):
        inputs.update(_jax_state(h.state, prefix))
        inputs[prefix + "_x:A"] = np.asarray(h.x[0])
        inputs[prefix + "_x:S"] = np.asarray(h.x[1])
    np.savez(tmp_path / "inputs.npz", **inputs)
    outs = _spawn(tmp_path, 2, "1d")

    cases = {
        "pgm": (jp, dict(e_rel=0, max_iter=30)),
        "pgm_w": (jp, dict(W=W, e_rel=0, max_iter=15)),
        "pgm_stride": (jp, dict(W=W, e_rel=0, max_iter=40, step_stride=10)),
        "pgm_adapt": (jp, dict(e_rel=0, max_iter=40, **adapt)),
        "pgm_adapt_unw": (jp, dict(e_rel=0, max_iter=40, step_adapt=True)),
        "pgm_early": (jp, dict(e_rel=1e-2, max_iter=5000)),
        "ada": (ja, dict(e_rel=0, max_iter=20)),
        "ada_w": (ja, dict(W=W, e_rel=0, max_iter=20)),
        "jax_resume": (jp, dict(e_rel=0, max_iter=25, **adapt)),
        "jax_resume_ada": (ja, dict(W=W, e_rel=0, max_iter=25)),
    }
    for case, (solve, kw) in cases.items():
        rj = solve(Y, A0.copy(), S0.copy(), mesh=jmesh, **kw)
        if case.startswith("jax_resume"):
            A, S = _whole(outs, case)
            np.testing.assert_allclose(A, np.asarray(rj.x[0]), **F64)
            np.testing.assert_allclose(S, np.asarray(rj.x[1]), **F64)
            assert int(outs[0][f"{case}:meta"][0]) == 13
            continue
        _held(outs, case, rj)
    assert int(outs[0]["pgm_early:meta"][0]) < 5000

    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, W=W, e_rel=0, max_iter=20, step_stride=10,
               mesh=jmesh)
    for o in outs:
        np.testing.assert_allclose(o["nmf_mesh:A"], A1, **F64)
        np.testing.assert_allclose(o["nmf_mesh:S"], S1, **F64)
        assert bool(o["ckpt_bitwise"])
        assert "divisible" in str(o["divides"])

    # the all-reduces of 10 iterations, on every rank: (elements, is max)
    per_iter = {"pgm": [(C * K + K * K, 0), (3, 0)],
                "pgm_w": [(C * K + C * K * K, 0), (1, 1), (3, 0)],
                "ada": [(K + C * K, 0), (3, 0)]}
    for o in outs:
        for case, pattern in per_iter.items():
            assert o[f"{case}:calls"].tolist() == [list(p) for p in
                                                   pattern] * 10, case


def test_four_ranks_match_jax_on_four_devices(tmp_path):
    Y, A0, S0, W = _problem()
    np.savez(tmp_path / "inputs.npz", Y=Y, A0=A0, S0=S0, W=W)
    outs = _spawn(tmp_path, 4, "2x2")
    devs = jax.devices("cpu")[:4]
    tp = jpar.make_mesh((2, 2), devices=devs)
    ml = jpar.make_mesh((2, 2), ("dcn", "data"), devices=devs)
    jp, ja = jpar.nmf_pgm_sharded, jpar.nmf_adaprox_sharded
    cases = {
        "pgm": (jp, tp, dict(e_rel=0, max_iter=20, model_axis="model")),
        "pgm_w": (jp, tp, dict(W=W, e_rel=0, max_iter=10,
                               model_axis="model")),
        "ada_w": (ja, tp, dict(W=W, e_rel=0, max_iter=20,
                               model_axis="model")),
        "ml_pgm": (jp, ml, dict(e_rel=0, max_iter=25,
                                data_axis=("dcn", "data"))),
        "ml_pgm_w_stride": (jp, ml, dict(W=W, e_rel=0, max_iter=30,
                                         step_stride=10,
                                         data_axis=("dcn", "data"))),
    }
    for case, (solve, mesh, kw) in cases.items():
        _held(outs, case, solve(Y, A0.copy(), S0.copy(), mesh=mesh, **kw))

    # 2 x 2 with model_axis: the gradients, the Grams and the stop scalars
    # over their axes; grad_S's model all-reduce is the local (K, N / 2)
    # block (the tensor-parallel contraction, as in JAX's layout), nothing
    # at the whole pixel size
    c_l, n_l = C // 2, N // 2
    tp_pattern = [(c_l * K + K * K, 0), (K * n_l + K * K, 0), (3, 0),
                  (5, 0)]
    for o in outs:
        assert o["pgm:calls"].tolist() == [list(p) for p in
                                           tp_pattern] * 10
        assert o["ml_pgm:calls"].tolist() == [[C * K + K * K, 0],
                                              [3, 0]] * 10
        assert max(n for n, _ in o["pgm:calls"]) < K * N


def _jax_routes(W):
    """The JAX calls of the worker's ROUTES, by name."""
    def half_steps(*X, it=None):
        return tuple(0.5 * s for s in pt.nmf.step_pgm(*X))

    return {
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


def _route_held(outs, case, Y, A0, S0, jmesh, kw):
    """Every rank's written-back whole result of an nmf(mesh=) route
    against JAX's nmf(mesh=) on as many devices (e_rel 0 and 10
    iterations unless ``kw`` says otherwise). A route that converges does
    so with finite iterates on every rank."""
    A1, S1 = A0.copy(), S0.copy()
    rj = pt.nmf.nmf(Y, A1, S1, mesh=jmesh, **{"e_rel": 0, "max_iter": 10,
                                              **kw})
    for o in outs:
        if rj.status == "converged":
            assert np.isfinite(o[f"{case}:A"]).all(), case
            assert np.isfinite(o[f"{case}:S"]).all(), case
        np.testing.assert_allclose(o[f"{case}:A"], A1, err_msg=case, **F64)
        np.testing.assert_allclose(o[f"{case}:S"], S1, err_msg=case, **F64)
        assert int(o[f"{case}:meta"][0]) == rj.iterations, case
        assert str(o[f"{case}:status"]) == rj.status, case


def _admm_held(outs, case, x, jmesh, spec):
    """admm and sdmm on a sharded x against JAX's on as many devices."""
    from jax.sharding import NamedSharding

    def prox_f(v, step):
        return (v + step) / (1 + step)

    def cap(v, step):
        return jnp.minimum(v, 0.8)

    xj = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, spec))
    for kind, rj in (
            ("admm", pt.admm(xj, prox_f, 0.5, prox_g=cap, e_rel=1e-6,
                             max_iter=300)),
            ("sdmm", pt.sdmm(xj, prox_f, 0.5, proxs_g=[
                cap, pt.operators.prox_plus], e_rel=1e-6, max_iter=300))):
        for o in outs:
            np.testing.assert_allclose(o[f"{case}_{kind}:x"],
                                       np.asarray(rj.x), rtol=1e-9,
                                       atol=1e-12)
            assert int(o[f"{case}_{kind}:meta"][0]) == rj.iterations


def _layout_rule(outs, d):
    """The JAX audit's rule (tests/test_collective_layout.py:1-90) on d
    ranks of the data axis: no all-gather, reduce-scatter or all-to-all,
    no all-reduce of K N / d elements or more (the audit's K 3, N 1024),
    and at least one all-reduce, for each solve on every rank."""
    big = 3 * 1024 // d
    for o in outs:
        for name in ("pgm", "adaprox", "bsdmm", "admm", "sdmm"):
            ops = [str(x) for x in o[f"audit_{name}:ops"]]
            sizes = o[f"audit_{name}:sizes"]
            assert set(ops) == {"all_reduce"}, (name, sorted(set(ops)))
            assert int(sizes.max()) < big, (name, int(sizes.max()), big)


def test_auto_spmd_two_ranks_match_jax(tmp_path):
    """The auto-SPMD routes on two ranks of a ('data',) mesh: the nine
    option sets of nmf(mesh=) (FISTA also along a trajectory that
    converges), admm and sdmm on a pixel-sharded x, each
    against JAX on two devices at rtol 1e-9 with equal iterations; and the
    layout rule for pgm, adaprox, bsdmm, admm and sdmm."""
    Y, A0, S0, W = _problem()
    np.savez(tmp_path / "inputs.npz", Y=Y, A0=A0, S0=S0, W=W)
    outs = _spawn(tmp_path, 2, "auto1d")
    jmesh = jpar.make_mesh(devices=jax.devices("cpu")[:2])
    for name, kw in _jax_routes(W).items():
        _route_held(outs, f"auto_{name}", Y, A0, S0, jmesh, kw)
    assert str(outs[0]["auto_accelerated_converging:status"]) == "converged"
    from jax.sharding import PartitionSpec as P

    _admm_held(outs, "auto", S0, jmesh, P(None, "data"))
    _layout_rule(outs, 2)


def test_auto_spmd_four_ranks_match_jax(tmp_path):
    """Four ranks: routes on a 2 x 2 ('data', 'model') mesh with the
    channel axis sharded, admm and sdmm with both of x's axes sharded, two
    routes on a ('data',) mesh of four, each against JAX on four devices;
    and the layout rule on the four-rank pixel axis."""
    from jax.sharding import PartitionSpec as P

    Y, A0, S0, W = _problem()
    np.savez(tmp_path / "inputs.npz", Y=Y, A0=A0, S0=S0, W=W)
    outs = _spawn(tmp_path, 4, "auto2x2")
    devs = jax.devices("cpu")[:4]
    tp = jpar.make_mesh((2, 2), devices=devs)
    routes = _jax_routes(W)
    for name in ("bsdmm", "amsgrad", "accelerated",
                 "accelerated_converging"):
        _route_held(outs, f"tp_{name}", Y, A0, S0, tp,
                    dict(routes[name], model_axis="model"))
    assert str(outs[0]["tp_accelerated_converging:status"]) == "converged"
    _admm_held(outs, "tp", Y, tp, P("model", "data"))
    flat = jpar.make_mesh(devices=devs)
    for name in ("bsdmm_w", "amsgrad"):
        _route_held(outs, f"auto_{name}", Y, A0, S0, flat, routes[name])
    _layout_rule(outs, 4)


def test_initialize_distributed_reraises_configured_failures(monkeypatch):
    """A configured bring-up that fails raises, by arguments or by the
    launcher's variables; with nothing configured the call is a
    single-process no-op that opens no group."""
    assert not dist.is_initialized()

    def boom(*args, **kw):
        raise RuntimeError("connect timed out: coordinator unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="unreachable"):
        tpar.initialize_distributed(coordinator_address="10.0.0.1:1234",
                                    num_processes=2, process_id=0)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"),
                 ("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "1234")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="unreachable"):
        tpar.initialize_distributed()
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k)
    assert tpar.initialize_distributed() == tpar.DistributedInfo(0, 1, 1, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="num_processes"):
        tpar.initialize_distributed(coordinator_address="10.0.0.1:1234")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tpar.initialize_distributed("10.0.0.1:1234", 2, 0,
                                        backend="nccl")
