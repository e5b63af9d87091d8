"""The lanes controller's inner loops and the differentiable solvers under
``torch.func``, against each lane's own solve and against the JAX package,
in float64 at small sizes.

- ``make_pgm_solver(backtracking=True)`` under ``torch.func.vmap``: lanes
  that halve 0, 1 and several times, and one that stops at iteration 1,
  with one block and with two (each lane halving its own block), plain and
  accelerated with restart.
- ``make_adaprox_solver`` with a prox that runs the sub-iterations (a ball
  projection and ``prox_unity_plus``) under ``torch.func.vmap``, with a
  lane that reaches ``prox_max_iter``.
- The five ``make_differentiable_*_solver`` factories under
  ``torch.func.grad``, ``torch.func.vjp``, ``torch.func.vmap(solve)`` and
  ``torch.func.vmap(torch.func.grad(loss))``.

Tolerances and their reasons:
- a lane against its own solve: rtol 1e-12 (the same body; ``vmap`` may
  reorder a batched reduction), iteration counts, halving scales and
  sub-iteration counts equal;
- a lane against JAX's vmapped factory: rtol 1e-9 (the packages' reductions
  and AdaProx's bias corrections round differently), iteration counts
  equal;
- implicit gradients against ``jax.grad`` and ``jax.vmap(jax.grad)``: rtol
  1e-6, as tests/test_torch_functional.py holds them.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxmin_tpu import functional as jf
from proxmin_tpu import operators as jops
from proxmin_tpu_torch import functional as tf
from proxmin_tpu_torch import operators as tops

EXACT = dict(rtol=1e-12, atol=0)
F64 = dict(rtol=1e-9, atol=1e-12)
GRAD = dict(rtol=1e-6, atol=1e-10)
vmap = torch.func.vmap
F = torch._C._functorch


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **tol)


def _lanes_of(t, B):
    """A tensor inside ``vmap`` as a plain tensor whose first dimension is
    the lane (an unbatched one stands for every lane)."""
    batched = False
    while F.is_batchedtensor(t) or F.is_gradtrackingtensor(t):
        if F.is_batchedtensor(t):
            bdim = F.maybe_get_bdim(t)
            t = F.get_unwrapped(t).movedim(bdim, 0)
            batched = True
        else:
            t = F.get_unwrapped(t)
    t = t.detach()
    return t if batched else t.expand(B, *t.shape)


def _final_state(solve, *args, keys=(), B=5):
    """``solve(*args)`` and, of the carry it ended with (the dict the lanes
    controller updates in place), the tensors under ``keys`` by lane."""
    seen = {}
    real = tf.run_lanes

    def spy(st, *a, **k):
        out = real(st, *a, **k)
        for key in keys:
            seen[key] = _lanes_of(st[key], B)
        return out

    with mock.patch.object(tf, "run_lanes", spy):
        out = solve(*args)
    return out, seen


# --- backtracking under vmap -----------------------------------------------
#
# Each lane minimizes 0.5 sum_j c_j ||x_j - y_j||^2 over x >= 0 from step
# 1. The test f(x') <= Q of a quadratic holds once T_j c_j <= 1 for the
# halved block, so a lane with c_j = 1.5, 3 or 20 halves 1, 2 or 5 times in
# its first iteration, and one with c_j <= 1 not at all; the start sets the
# steepest relative update (the block halved) on the block that needs it.
# The last lane starts at its solution and stops at iteration 1.

C1 = np.array([0.5, 1.5, 3.0, 0.5, 0.8])
C2 = np.array([0.5, 0.5, 0.5, 20.0, 0.8])
HALVINGS = [0, 1, 2, 5, 0]


def _bt_data(blocks):
    rng = np.random.default_rng(21)
    y1 = rng.normal(size=(5, 4)) + 1.0
    y2 = rng.normal(size=(5, 3)) + 1.0
    x1 = np.full((5, 4), 0.1)
    x2 = np.full((5, 3), 1.0)
    # lane 3 halves block 2: start it far from y2 and block 1 near y1
    x2[3] = 0.05
    x1[3] = np.maximum(y1[3], 0.0) + 0.01
    # lane 4 starts at its solution
    x1[4], x2[4] = np.maximum(y1[4], 0), np.maximum(y2[4], 0)
    if blocks == 1:
        c = np.where(np.arange(5) == 3, C2, C1)
        x1[3] = 0.05
        return (c,), (y1,), (x1,)
    return (C1, C2), (y1, y2), (x1, x2)


def _bt_problem(lib, c, y):
    """``(grad, f)`` of one lane's problem."""
    def f(*x):
        return sum(0.5 * cj * lib.sum((xj - yj) ** 2)
                   for cj, xj, yj in zip(c, x, y))

    def grad(*x):
        g = tuple(cj * (xj - yj) for cj, xj, yj in zip(c, x, y))
        return g[0] if len(g) == 1 else g

    return grad, f


BT = dict(step=1.0, backtracking=True, e_rel=1e-10, max_iter=500)


def _bt_solver(mk, lib, prox, kw, c, y):
    grad, f = _bt_problem(lib, c, y)
    return mk.make_pgm_solver(grad, prox=prox, f=f, **BT, **kw)


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("kw", [{}, dict(accelerated=True, restart=True)],
                         ids=["plain", "accelerated"])
def test_backtracking_under_vmap_matches_each_lane_and_jax(blocks, kw):
    from proxmin_tpu_torch import pgm

    c, y, x0 = _bt_data(blocks)
    n = len(c)

    def lanes(*a):
        cs, ys, xs = a[:n], a[n:2 * n], a[2 * n:]
        return _bt_solver(tf, torch, tops.prox_plus, kw, cs, ys)(*xs)

    (x, it, conv, div), st = _final_state(
        vmap(lanes), *[_t(a) for a in (*c, *y, *x0)], keys=("T",))
    T = st["T"]
    assert bool(conv.all()) and not bool(div.any())
    its = it.tolist()
    assert its[4] == 1 and len(set(its)) > 2
    if not kw:
        # each lane halved its own block 0, 1, 2 or 5 times
        want = [[1.0] * n for _ in range(5)]
        for i, h in enumerate(HALVINGS):
            want[i][1 if (n == 2 and i == 3) else 0] = 2.0 ** -h
        assert T.tolist() == want
    xs = x if n == 2 else (x,)
    for i in range(5):
        ci, yi = [_t(cj[i]) for cj in c], [_t(yj[i]) for yj in y]
        xi, iti, convi, _ = _bt_solver(tf, torch, tops.prox_plus, kw, ci,
                                       yi)(*[_t(xj[i]) for xj in x0])
        # outside vmap the factory runs the driver's loop: the driver's
        # state holds the lane's own scales
        grad, f = _bt_problem(torch, ci, yi)
        r = pgm([_t(xj[i]) for xj in x0], grad, prox=tops.prox_plus, f=f,
                **BT, **kw)
        assert int(iti) == its[i] == r.iterations
        assert T[i].tolist() == r.state["T"].tolist()
        for xl, xo in zip(xs, xi if n == 2 else (xi,)):
            _close(xl[i], xo, EXACT)
        assert torch.equal(conv[i], convi)

    def lanes_j(*a):
        cs, ys, xs_ = a[:n], a[n:2 * n], a[2 * n:]
        return _bt_solver(jf, jnp, jops.prox_plus, kw, cs, ys)(*xs_)

    xj, itj, _, _ = jax.jit(jax.vmap(lanes_j))(
        *[jnp.asarray(a) for a in (*c, *y, *x0)])
    assert np.asarray(itj).tolist() == its
    for xl, xjl in zip(xs, xj if n == 2 else (xj,)):
        _close(xl, xjl, F64)


# --- AdaProx's prox sub-iterations under vmap ------------------------------
#
# Each lane minimizes 0.5 ||x - c||^2 over a set whose prox is not separable
# (the unit ball, or the non-negative unit simplex of each column), by
# AdaProx with the prox sub-iterations. Lanes converge at different
# iterations, and their sub-iteration counts differ; some reach
# prox_max_iter.

ADA = dict(step=0.05, e_rel=1e-7, max_iter=250, prox_max_iter=40)


def t_ball(x, step):
    nrm = torch.sqrt(torch.sum(x ** 2))
    return torch.where(nrm > 1, x / nrm, x)


def j_ball(x, step):
    nrm = jnp.sqrt(jnp.sum(x ** 2))
    return jnp.where(nrm > 1, x / nrm, x)


def _ada_centers():
    rng = np.random.default_rng(5)
    rng.normal(size=(10, 3))
    ball = rng.normal(size=(10, 3)) * 1.5
    simplex = rng.normal(size=(10, 3, 2)) * 1.5
    return {"ball": ball[[1, 2, 3, 6, 7, 9]],
            "unity_plus": simplex[[0, 1, 4, 5, 6, 9]]}


def _ada_solver(mk, prox, c):
    return mk.make_adaprox_solver(lambda x: x - c, prox=prox, **ADA)


def _taus(solve, name, *args, B=None):
    """``solve(*args)`` and the sub-iteration counts of each call of the
    sub-loop ``name`` of the functional module (by lane under vmap)."""
    rec = []
    real = getattr(tf, name)

    def spy(*a, **k):
        z, tau = real(*a, **k)
        rec.append(_lanes_of(tau, B).tolist() if B else tau)
        return z, tau

    with mock.patch.object(tf, name, spy):
        out = solve(*args)
    return out, rec


@pytest.mark.parametrize("prox", ["ball", "unity_plus"])
def test_adaprox_subiterations_under_vmap_match_each_lane_and_jax(prox):
    cs = _ada_centers()[prox]
    B = len(cs)
    t_prox = (t_ball if prox == "ball" else
              functools.partial(tops.prox_unity_plus, axis=0))
    j_prox = (j_ball if prox == "ball" else
              functools.partial(jops.prox_unity_plus, axis=0))
    x0 = np.full(cs.shape[1:], 0.3)

    def lanes(c):
        return _ada_solver(tf, t_prox, c)(_t(x0))

    (x, M, V, _, it, conv, div), rec = _taus(vmap(lanes), "_prox_subloop_lanes",
                                             _t(cs), B=B)
    its = it.tolist()
    assert bool(conv.all()) and not bool(div.any()) and len(set(its)) > 2
    assert len(rec) == max(its)
    reached = [max(r[i] for r in rec) == ADA["prox_max_iter"]
               for i in range(B)]
    assert any(reached) and not all(reached)
    for i in range(B):
        (xi, Mi, _, _, iti, convi, _), own = _taus(
            _ada_solver(tf, t_prox, _t(cs[i])), "_prox_subloop", _t(x0))
        assert int(iti) == its[i]
        # the lane's sub-iterations are its own solve's, then none
        assert [r[i] for r in rec] == own + [0] * (len(rec) - its[i])
        _close(x[i], xi, EXACT)
        _close(M[0][i], Mi[0], EXACT)
        assert torch.equal(conv[i], convi)
    xj, *_, itj, convj, _ = jax.jit(jax.vmap(
        lambda c: _ada_solver(jf, j_prox, c)(jnp.asarray(x0))))(
        jnp.asarray(cs))
    assert np.asarray(itj).tolist() == its
    _close(x, xj, F64)


# --- the differentiable solvers under torch.func ----------------------------
#
# One small problem per factory, strongly convex in x and smooth in theta, and
# three parameter lanes. Each problem is written once per package.

def _pgm_problem(lib, arr, ops):
    rng = np.random.default_rng(31)
    Mx = rng.normal(size=(6, 6))
    P = np.eye(6) + 0.3 * Mx @ Mx.T / 6
    step = 1.0 / np.linalg.eigvalsh(P)[-1]
    Pa = arr(P)
    solve = lib.make_differentiable_pgm_solver(
        lambda x, th: Pa @ x - th, step, prox=ops.prox_plus, e_rel=1e-12,
        vjp_rtol=1e-12)
    return solve, 6, 1.0


def _adaprox_problem(lib, arr, ops):
    y = np.random.default_rng(11).normal(size=10)
    solve = lib.make_differentiable_adaprox_solver(
        lambda x, th: x - (arr(y) + th), 0.5,
        prox=lambda z, s: ops.prox_soft(z, s, thresh=0.25), e_rel=1e-12,
        max_iter=50000, vjp_rtol=1e-12)
    return solve, 10, 0.1


def _admm_problem(lib, arr, ops):
    n = 12
    y = np.random.default_rng(4).normal(size=n)
    D = np.eye(n)[1:] - np.eye(n)[:-1]
    solve = lib.make_differentiable_admm_solver(
        lambda v, s, th: (v + s * (arr(y) + th)) / (1.0 + s), 0.5,
        lambda v, s, th: ops.prox_soft(v, s, thresh=0.3), L=arr(D),
        e_rel=1e-12, max_iter=20000, vjp_rtol=1e-12, prox_params=True)
    return solve, n, 0.1


def _sdmm_problem(lib, arr, ops):
    n = 12
    y = np.random.default_rng(4).normal(size=n)
    D = np.eye(n)[1:] - np.eye(n)[:-1]
    solve = lib.make_differentiable_sdmm_solver(
        lambda v, s, th: (v + s * (arr(y) + th)) / (1.0 + s), 0.5,
        (lambda v, s, th: ops.prox_soft(v, s, thresh=0.2),
         lambda v, s, th: ops.prox_plus(v, s)), Ls=[arr(D), None],
        e_rel=1e-12, max_iter=20000, vjp_rtol=1e-12, prox_params=True)
    return solve, n, 0.1


def _bsdmm_problem(lib, arr, ops):
    n, alpha = 10, 0.5
    rng = np.random.default_rng(11)
    t1, t2 = rng.normal(size=n), rng.normal(size=n)

    def proxs_f(v, step, theta, Xs=None, j=None):
        target = (arr(t1) + theta) if j == 0 else arr(t2)
        return (v + step * (target + alpha * Xs[1 - j])) / (
            1.0 + step * (1.0 + alpha))

    solve = lib.make_differentiable_bsdmm_solver(
        proxs_f, 0.4,
        proxs_g=[[lambda v, s, th: ops.prox_soft(v, s, thresh=0.15)], None],
        e_rel=1e-12, max_iter=30000, vjp_rtol=1e-12, prox_params=True)
    return solve, n, 0.1


PROBLEMS = {"pgm": _pgm_problem, "adaprox": _adaprox_problem,
            "admm": _admm_problem, "sdmm": _sdmm_problem,
            "bsdmm": _bsdmm_problem}


def _start(name, lib, n):
    z = lib.zeros(n, dtype=lib.float64)
    return (z, lib.zeros(n, dtype=lib.float64)) if name == "bsdmm" else z


def _scalar_loss(lib, x):
    if isinstance(x, tuple):
        return lib.sum(x[0] ** 3) + lib.sum(x[0] * x[1])
    return lib.sum(x ** 3)


def _thetas(name, n, scale):
    return np.random.default_rng(41).normal(size=(3, n)) * scale


def _torch_side(name):
    solve, n, scale = PROBLEMS[name](tf, _t, tops)
    x0 = _start(name, torch, n)

    def loss(theta):
        return _scalar_loss(torch, solve(x0, theta)[0])

    return solve, x0, loss, _thetas(name, n, scale)


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """JAX's solves and gradients of the three lanes, vmapped and one by
    one."""
    solve, n, scale = PROBLEMS[name](jf, jnp.asarray, jops)
    x0 = _start(name, jnp, n)

    def loss(theta):
        return _scalar_loss(jnp, solve(x0, theta)[0])

    ths = jnp.asarray(_thetas(name, n, scale))
    xs, convs = jax.jit(jax.vmap(lambda th: solve(x0, th)))(ths)
    grads = jax.jit(jax.vmap(jax.grad(loss)))(ths)
    one = [jax.grad(loss)(th) for th in ths]
    return xs, convs, grads, one


def _autograd(loss, theta):
    th = _t(theta).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(th), th)
    return g


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_differentiable_solver_under_func_grad(name):
    """``torch.func.grad`` of a loss through the solve: each lane's
    gradient equals ``torch.autograd.grad``'s and ``jax.grad``'s."""
    _, _, loss, ths = _torch_side(name)
    _, _, _, one = _jax_side(name)
    for th, gj in zip(ths, one):
        g = torch.func.grad(loss)(_t(th))
        _close(g, _autograd(loss, th), EXACT)
        _close(g, gj, GRAD)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_differentiable_solver_under_func_vjp(name):
    """``torch.func.vjp`` of the solution: its pullback of a cotangent
    equals ``torch.autograd.grad``'s."""
    solve, x0, _, ths = _torch_side(name)
    th = _t(ths[0])
    x, pull = torch.func.vjp(lambda t_: solve(x0, t_)[0], th)
    u = tuple(torch.linspace(-1.0, 1.0, xl.numel(), dtype=torch.float64)
              for xl in _leaves(x))
    (g,) = pull(u if isinstance(x, tuple) else u[0])
    tr = th.clone().requires_grad_(True)
    (ga,) = torch.autograd.grad(_leaves(solve(x0, tr)[0]), tr, u)
    _close(g, ga, EXACT)
    for xl, xo in zip(_leaves(x), _leaves(solve(x0, th)[0])):
        assert torch.equal(xl, xo)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_differentiable_solver_under_vmap(name):
    """``torch.func.vmap(solve)``: each lane equals its own solve and
    JAX's vmapped solve, and converged."""
    solve, x0, _, ths = _torch_side(name)
    xj, convj, _, _ = _jax_side(name)
    xs, convs = vmap(lambda th: solve(x0, th))(_t(ths))
    assert bool(convs.all()) and np.asarray(convj).all()
    for i, th in enumerate(ths):
        xi, ci = solve(x0, _t(th))
        for xl, xo in zip(_leaves(xs), _leaves(xi)):
            _close(xl[i], xo, EXACT)
        assert bool(ci)
    for xl, xjl in zip(_leaves(xs), _leaves(xj)):
        _close(xl, xjl, F64)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_differentiable_solver_under_vmap_of_grad(name):
    """``torch.func.vmap(torch.func.grad(loss))``: each lane's gradient
    equals its own ``torch.autograd.grad`` and ``jax.vmap(jax.grad)``'s."""
    _, _, loss, ths = _torch_side(name)
    _, _, gj, _ = _jax_side(name)
    gs = vmap(torch.func.grad(loss))(_t(ths))
    for i, th in enumerate(ths):
        _close(gs[i], _autograd(loss, th), EXACT)
    _close(gs, gj, GRAD)
