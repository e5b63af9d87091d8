"""The port's generic exporters against proxmin_tpu.export and against
the port's own drivers: one small float64 problem per exporter (test_aux.py's
cases), the program held to the driver bit for bit (it runs the driver's
body) and to its JAX twin at rtol 1e-9 (only the libraries' summation
orders differ); a callable that reads the host is refused by name, and a
process that imports torch alone serves a kernel-free program.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxmin_tpu.export as jex
import proxmin_tpu_torch as ptt
import proxmin_tpu_torch.export as tex

F64 = dict(rtol=1e-9, atol=0)
CENTER = np.array([1.0, 0.5])


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _disk(x, r, sqrt, where, s):
    nrm = sqrt(s(x ** 2))
    return where(nrm > r, x * (r / nrm), x)


def _prox_disk_t(x, step):
    return _disk(x, 0.5, torch.sqrt, torch.where, torch.sum)


def _prox_disk_j(x, step):
    return _disk(x, 0.5, jnp.sqrt, jnp.where, jnp.sum)


_C_T = torch.tensor(CENTER)


def _grad_t(x):
    return x - _C_T


def _grad_j(x):
    return x - jnp.asarray(CENTER)


def _prox_f_t(v, step):
    return (v + step * _C_T) / (1 + step)


def _prox_f_j(v, step):
    return (v + step * jnp.asarray(CENTER)) / (1 + step)


def _plus_t(v, step):
    return torch.clamp_min(v, 0)


def _plus_j(v, step):
    return jnp.maximum(v, 0)


_C1, _C2 = np.array([1.0, -0.5]), np.array([0.2, 0.8, -0.1])
_CB_T = (torch.tensor(_C1), torch.tensor(_C2))


def _proxs_f_t(x, step, Xs=None, j=None):
    return (x + step * _CB_T[j]) / (1 + step)


def _proxs_f_j(x, step, Xs=None, j=None):
    return (x + step * jnp.asarray([_C1, _C2][j])) / (1 + step)


def _steps_f(Xs, j=None):
    return 0.4


X0 = np.array([-1.0, -1.0])
XB = [np.array([-1.0, -1.0]), np.array([0.5, -0.5, 0.5])]
ADAPROX_C = np.array([2.0, -1.0])


def _generic(name):
    """``(port program, port driver, JAX program, inputs)`` of one generic
    case, float64."""
    f64, dev = torch.float64, "cpu"
    if name.startswith("pgm"):
        acc = name == "pgm fista restart"
        kw = dict(prox=None, e_rel=1e-10, max_iter=500,
                  accelerated=acc, restart=acc)
        port = tex.export_pgm_solver((2,), _grad_t, 0.5, dtype=f64,
                                     device=dev, **dict(kw, prox=_prox_disk_t))
        jax_ = jex.export_pgm_solver((2,), _grad_j, 0.5, dtype=jnp.float64,
                                     **dict(kw, prox=_prox_disk_j))

        def driver(x):
            r = ptt.pgm(x, _grad_t, 0.5, **dict(kw, prox=_prox_disk_t))
            return (r.x,), r.iterations
        return port, driver, jax_, (X0,)
    if name.startswith("adaprox"):
        scheme = name.split()[1]
        sub = name.endswith("prox")
        ct, cj = torch.tensor(ADAPROX_C), jnp.asarray(ADAPROX_C)
        kw = dict(scheme=scheme, e_rel=1e-8, max_iter=200)
        port = tex.export_adaprox_solver(
            (2,), lambda x: x - ct, 0.3, dtype=f64, device=dev,
            prox=_prox_disk_t if sub else None, **kw)
        jax_ = jex.export_adaprox_solver(
            (2,), lambda x: x - cj, 0.3, dtype=jnp.float64,
            prox=_prox_disk_j if sub else None, **kw)

        def driver(x):
            r = ptt.adaprox(x, lambda x: x - ct, 0.3,
                            prox=_prox_disk_t if sub else None, **kw)
            return (r.x,), r.iterations
        return port, driver, jax_, (np.zeros(2),)
    if name == "admm":
        kw = dict(e_rel=1e-8, max_iter=500)
        port = tex.export_admm_solver((2,), _prox_f_t, 0.5,
                                      prox_g=_prox_disk_t, dtype=f64,
                                      device=dev, **kw)
        jax_ = jex.export_admm_solver((2,), _prox_f_j, 0.5,
                                      prox_g=_prox_disk_j,
                                      dtype=jnp.float64, **kw)

        def driver(x):
            r = ptt.admm(x, _prox_f_t, 0.5, prox_g=_prox_disk_t, **kw)
            return r.x, r.iterations
        return port, driver, jax_, (X0,)
    if name == "sdmm":
        kw = dict(e_rel=1e-8, max_iter=500)
        port = tex.export_sdmm_solver((2,), _prox_f_t, 0.5,
                                      [_prox_disk_t, _plus_t], dtype=f64,
                                      device=dev, **kw)
        jax_ = jex.export_sdmm_solver((2,), _prox_f_j, 0.5,
                                      [_prox_disk_j, _plus_j],
                                      dtype=jnp.float64, **kw)

        def driver(x):
            r = ptt.sdmm(x, _prox_f_t, 0.5, proxs_g=[_prox_disk_t, _plus_t],
                         **kw)
            return r.x, r.iterations
        return port, driver, jax_, (X0,)
    kw = dict(e_rel=1e-9, max_iter=300)
    port = tex.export_bsdmm_solver([(2,), (3,)], _proxs_f_t, _steps_f,
                                   proxs_g=[_plus_t, _plus_t], dtype=f64,
                                   device=dev, **kw)
    jax_ = jex.export_bsdmm_solver([(2,), (3,)], _proxs_f_j, _steps_f,
                                   proxs_g=[_plus_j, _plus_j],
                                   dtype=jnp.float64, **kw)

    def driver(*xs):
        r = ptt.bsdmm(list(xs), _proxs_f_t, _steps_f,
                      proxs_g=[_plus_t, _plus_t], **kw)
        return tuple(r.x), r.iterations
    return port, driver, jax_, tuple(XB)


GENERIC = ["pgm", "pgm fista restart", "adaprox amsgrad", "adaprox adam",
           "adaprox radam", "adaprox adam prox", "admm", "sdmm", "bsdmm"]


@pytest.mark.parametrize("name", GENERIC)
def test_generic_program_matches_the_driver_and_jax(name):
    port, driver, jax_blob, inputs = _generic(name)
    got = tex.load_solver(port)(*[_t(x) for x in inputs])
    x_d, it_d = driver(*[_t(x) for x in inputs])
    want = jex.load_solver(jax_blob)(*[jnp.asarray(x) for x in inputs])
    blocks = got[0] if isinstance(got[0], tuple) else (got[0],)
    j_blocks = want[0] if isinstance(want[0], tuple) else (want[0],)
    d_blocks = x_d if isinstance(x_d, tuple) else (x_d,)
    it_pos = 4 if name.startswith("adaprox") else 1
    assert int(got[it_pos]) == it_d == int(want[it_pos])
    for g, d, w in zip(blocks, d_blocks, j_blocks):
        assert torch.equal(g, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    if name in ("admm", "sdmm"):
        assert tuple(got[3].shape) == (1 if name == "admm" else 2, 4)


def test_a_host_reading_callable_is_refused_by_name():
    def grad_reads_host(x):
        # a branch on a tensor's value: the capture cannot take both
        return x - 1.0 if bool(x.sum() > 0) else x

    with pytest.raises(ValueError, match="grad_reads_host"):
        tex.export_pgm_solver((2,), grad_reads_host, 0.5, max_iter=5,
                              dtype=torch.float64, device="cpu")




def _const_t(value):
    def prox(v, step):
        return torch.full_like(v, value)
    return prox


def _const_j(value):
    def prox(v, step):
        return jnp.asarray([value, value])
    return prox


@pytest.mark.parametrize("solver", ["admm", "sdmm"])
def test_a_restart_storm_runs_to_the_driver_budget(solver):
    """A stalling problem (test_torch_admm.py's restart case) restarts
    again and again: the program keeps restarting, its slack a tensor after
    the first stall, and stops where the driver and the JAX program do (the
    work bound)."""
    kw = dict(e_rel=1e-6, max_iter=50)
    f64 = torch.float64
    if solver == "admm":
        port = tex.export_admm_solver((2,), _const_t(0.3), 0.5,
                                      prox_g=_const_t(9.0), dtype=f64,
                                      device="cpu", **kw)
        jax_ = jex.export_admm_solver((2,), _const_j(0.3), 0.5,
                                      prox_g=_const_j(9.0),
                                      dtype=jnp.float64, **kw)
        res = ptt.admm(_t(np.zeros(2)), _const_t(0.3), 0.5,
                       prox_g=_const_t(9.0), **kw)
    else:
        port = tex.export_sdmm_solver((2,), _const_t(0.3), 0.5,
                                      [_const_t(9.0), _plus_t], dtype=f64,
                                      device="cpu", **kw)
        jax_ = jex.export_sdmm_solver((2,), _const_j(0.3), 0.5,
                                      [_const_j(9.0), _plus_j],
                                      dtype=jnp.float64, **kw)
        res = ptt.sdmm(_t(np.zeros(2)), _const_t(0.3), 0.5,
                       proxs_g=[_const_t(9.0), _plus_t], **kw)
    assert res.slack < 0.25  # restarts after the first
    x, it, conv, errors = tex.load_solver(port)(np.zeros(2))
    want = jex.load_solver(jax_)(np.zeros(2))
    assert int(it) == res.iterations == int(want[1])
    assert bool(conv) == res.converged == bool(want[2])
    assert torch.equal(x, res.x)
    np.testing.assert_allclose(errors.numpy(), np.asarray(want[3]), **F64)


SERVE = r"""
import sys
import numpy as np
import torch
ep = torch.export.load(sys.argv[1])
d = np.load(sys.argv[2])
out = ep.module()(torch.from_numpy(d["x0"]))
assert "proxmin_tpu_torch" not in sys.modules, "the port was imported"
np.save(sys.argv[3], out[0][0].numpy())
print(int(out[1]))
"""


def test_a_clean_process_serves_a_generic_program(tmp_path):
    """A kernel-free program is served by a process that imports torch
    alone (test_aux.py's serving test, for the port)."""
    port, driver, _, inputs = _generic("pgm")
    path = tex.save_exported(tmp_path / "pgm.pt2", port)
    np.savez(tmp_path / "x.npz", x0=inputs[0])
    proc = subprocess.run(
        [sys.executable, "-c", SERVE, str(path), str(tmp_path / "x.npz"),
         str(tmp_path / "out.npy")], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    x_d, it_d = driver(_t(inputs[0]))
    assert int(proc.stdout.split()[-1]) == it_d
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  x_d[0].numpy())


_M = np.random.default_rng(9).standard_normal((6, 4)) + 3 * np.eye(6, 4)
_B = np.random.default_rng(10).standard_normal(6)
_M_T, _B_T = torch.tensor(_M), torch.tensor(_B)


def _f_t(x):
    return 0.5 * torch.sum((_M_T @ x - _B_T) ** 2)


def _grad_ls_t(x):
    # torch.t, not .T: a loop body may not close over a tensor and a view
    # of it (torch's while_loop refuses aliased inputs)
    return torch.t(_M_T) @ (_M_T @ x - _B_T)


def _f_j(x):
    return 0.5 * jnp.sum((jnp.asarray(_M) @ x - jnp.asarray(_B)) ** 2)


def _grad_ls_j(x):
    return jnp.asarray(_M).T @ (jnp.asarray(_M) @ x - jnp.asarray(_B))


@pytest.mark.parametrize("accelerated", [False, True])
def test_backtracking_program_matches_the_driver_and_jax(accelerated):
    """Backtracking from a step 5 times too long: the halvings run as a
    nested while_loop, and the program ends where the driver does, bit for
    bit, and where JAX's does within rtol 1e-9. At e_rel 1e-6 the solve
    stops before rounding noise decides the halving test (at 1e-9 the two
    packages' drivers halve differently near the fixed point)."""
    kw = dict(prox=ptt.operators.prox_plus, backtracking=True, e_rel=1e-6,
              max_iter=60, accelerated=accelerated)
    prog = tex.load_solver(tex.export_pgm_solver(
        (4,), _grad_ls_t, 5.0, f=_f_t, dtype=torch.float64, device="cpu",
        **kw))
    xs, it, conv, div = prog(torch.zeros(4, dtype=torch.float64))
    res = ptt.pgm(torch.zeros(4, dtype=torch.float64), _grad_ls_t, 5.0,
                  f=_f_t, **kw)
    assert torch.equal(xs[0], res.x) and int(it) == res.iterations
    jkw = dict(kw, prox=lambda x, step: jnp.maximum(x, 0))
    want = jex.load_solver(jex.export_pgm_solver(
        (4,), _grad_ls_j, 5.0, f=_f_j, dtype=jnp.float64, **jkw))(
        jnp.zeros(4, jnp.float64))
    np.testing.assert_allclose(xs[0].numpy(), np.asarray(want[0][0]), **F64)
    assert int(want[1]) == int(it)
