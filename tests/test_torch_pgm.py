"""The port's pgm driver against proxmin_tpu.pgm.

A box-constrained convex quadratic, f64, the same numpy inputs through
both drivers. Tolerance: rtol 1e-12 on the iterates, since both run the
same operations in the same order and differ only in how the two BLAS
libraries sum a 40-term matrix-vector product (a few ulps per iteration,
contracted by the gradient step). Iteration counts must be equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu_torch as ptt
from proxmin_tpu_torch.interop import state_from_numpy

RTOL = 1e-12

# NumPy inputs go to the card unless the caller names a device; these tests
# run on the CPU
_pgm = functools.partial(ptt.pgm, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(rng, n=40):
    M = rng.normal(size=(n, n))
    Q = M @ M.T / n + 0.05 * np.eye(n)
    b = rng.normal(size=n)
    L = np.linalg.eigvalsh(Q)[-1]
    x0 = rng.random(n)
    return Q, b, 1.0 / L, x0


def _grads(Q, b):
    Qj, bj = jnp.asarray(Q), jnp.asarray(b)
    Qt, bt = torch.from_numpy(Q), torch.from_numpy(b)
    return (lambda x: Qj @ x - bj), (lambda x: Qt @ x - bt)


def _box(lib):
    return lambda x, s: lib.operators.prox_min(
        lib.operators.prox_max(x, s, thresh=0.5, type="absolute"), s,
        thresh=-0.5, type="absolute")


@pytest.mark.parametrize("accelerated,restart", [
    (False, False), (True, False), (True, True)])
def test_pgm_matches_jax(rng, accelerated, restart):
    Q, b, step, x0 = _problem(rng)
    gj, gt = _grads(Q, b)
    kw = dict(accelerated=accelerated, restart=restart, e_rel=1e-6,
              max_iter=5000)
    rj = pt.pgm(x0.copy(), gj, step, prox=_box(pt), **kw)
    rt = _pgm(x0.copy(), gt, step, prox=_box(ptt), **kw)
    assert rj.iterations == rt.iterations
    assert rt.status == rj.status == "converged"
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=RTOL,
                               atol=0)
    conv, G, S = rt  # reference-shaped unpacking
    assert conv == (True,)
    np.testing.assert_allclose(G.numpy(), np.asarray(rj.G), rtol=1e-9,
                               atol=1e-15)


@pytest.mark.parametrize("accelerated", [False, True])
def test_pgm_two_blocks_fixed_iterations(rng, accelerated):
    """Two blocks, callable step, per-block e_rel=0 (runs to max_iter)."""
    Q, b, step, x0 = _problem(rng, n=30)
    x1 = rng.random(30)
    Qj, bj = jnp.asarray(Q), jnp.asarray(b)
    Qt, bt = torch.from_numpy(Q), torch.from_numpy(b)

    def gj(x, y):
        return Qj @ x - bj + 0.1 * y, Qj @ y + bj + 0.1 * x

    def gt(x, y):
        return Qt @ x - bt + 0.1 * y, Qt @ y + bt + 0.1 * x

    def sj(x, y, it=None):
        return step * 0.9, step * 0.8

    rj = pt.pgm([x0.copy(), x1.copy()], gj, sj, prox=[None, _box(pt)],
                accelerated=accelerated, e_rel=0, max_iter=60)
    rt = _pgm([x0.copy(), x1.copy()], gt, sj, prox=[None, _box(ptt)],
                 accelerated=accelerated, e_rel=0, max_iter=60)
    assert rj.iterations == rt.iterations == 60
    for a, c in zip(rj.x, rt.x):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=RTOL)


def test_pgm_writes_numpy_input_in_place(rng):
    Q, b, step, x0 = _problem(rng)
    _, gt = _grads(Q, b)
    x = x0.copy()
    res = _pgm(x, gt, step, prox=_box(ptt), max_iter=20, e_rel=0)
    np.testing.assert_array_equal(x, res.x.numpy())


def test_pgm_resume_is_exact(rng):
    """FISTA 15 + 25 iterations through state= equals 40 straight."""
    Q, b, step, x0 = _problem(rng)
    _, gt = _grads(Q, b)
    kw = dict(prox=_box(ptt), accelerated=True, e_rel=0)
    full = _pgm(x0.copy(), gt, step, max_iter=40, **kw)
    half = _pgm(x0.copy(), gt, step, max_iter=15, **kw)
    rest = _pgm(half.x, gt, step, max_iter=25, state=half.state, **kw)
    assert torch.equal(rest.x, full.x)
    assert rest.state["it"] == 40


def test_pgm_continues_a_jax_state(rng):
    """A JAX FISTA solve stopped after 15 iterations and continued in the
    port matches JAX's 40 straight iterations."""
    Q, b, step, x0 = _problem(rng)
    gj, gt = _grads(Q, b)
    kw = dict(accelerated=True, e_rel=0)
    full = pt.pgm(x0.copy(), gj, step, prox=_box(pt), max_iter=40, **kw)
    half = pt.pgm(x0.copy(), gj, step, prox=_box(pt), max_iter=15, **kw)
    st = jax.tree_util.tree_map(np.asarray, half.state)
    rest = _pgm(np.asarray(half.x), gt, step, prox=_box(ptt),
                   max_iter=25, state=state_from_numpy(st, device="cpu"), **kw)
    np.testing.assert_allclose(rest.x.numpy(), np.asarray(full.x),
                               rtol=RTOL)
    assert rest.state["it"] == 40


def test_pgm_divergence_detected_like_jax(rng):
    Q, b, step, x0 = _problem(rng)
    gj, gt = _grads(Q, b)
    rj = pt.pgm(x0.copy(), gj, 400 * step, max_iter=3000)
    rt = _pgm(x0.copy(), gt, 400 * step, max_iter=3000)
    assert rj.status == rt.status == "diverged"
    assert rj.iterations == rt.iterations


@pytest.mark.parametrize("kw", [
    {"backtracking": True, "f": True},
    {"callback": True},
    {"trace": True},
])
def test_pgm_options_not_yet_ported_raise(rng, kw):
    """These options raised ``NotImplementedError`` until they were ported;
    the test keeps its name and now holds each against the JAX solver on
    the box-constrained quadratic (tests/test_torch_driver_options.py has
    the full set)."""
    Q, b, step, x0 = _problem(rng)
    gj, gt = _grads(Q, b)
    kj, kt = dict(kw), dict(kw)
    if "f" in kw:
        Qj, bj = jnp.asarray(Q), jnp.asarray(b)
        Qt, bt = torch.from_numpy(Q), torch.from_numpy(b)
        kj["f"] = lambda x: 0.5 * x @ (Qj @ x) - bj @ x
        kt["f"] = lambda x: 0.5 * x @ (Qt @ x) - bt @ x
        step = 7 * step  # too long: the line search has to halve it
    seen = {"jax": [], "torch": []}
    if "callback" in kw:
        kj["callback"] = lambda *x, it=None: seen["jax"].append(it)
        kt["callback"] = lambda *x, it=None: seen["torch"].append(it)
    rj = pt.pgm(x0.copy(), gj, step, prox=_box(pt), e_rel=1e-6,
                max_iter=400, **kj)
    rt = _pgm(x0.copy(), gt, step, prox=_box(ptt), e_rel=1e-6, max_iter=400,
              **kt)
    assert rj.iterations == rt.iterations and rj.status == rt.status
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9)
    np.testing.assert_allclose(rt.state["T"].numpy(),
                               np.asarray(rj.state["T"]), rtol=0)
    assert seen["torch"] == seen["jax"]
    if "f" in kw:
        assert float(rt.state["T"][0]) < 1.0
    if "trace" in kw:
        assert rt.history.shape == (rt.iterations, 1)
        np.testing.assert_allclose(rt.history, rj.history, rtol=1e-9)
    else:
        assert rt.history is None
