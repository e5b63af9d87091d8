"""The options of the port's pgm and adaprox against the JAX drivers:
callbacks with ``StopIteration``, ``trace=``, backtracking, ``grad=None``
(autodiff of ``f``), the Barzilai-Borwein stepper, and the structure check
of a resumed stepper state.

The problems of tests/test_pgm.py, tests/test_adaprox.py and
tests/test_aux.py (a disk-constrained quadratic with a known optimum, small
NMF problems), float64, the same NumPy inputs through both packages.
Tolerance: rtol 1e-9 on iterates and histories (both run the same
operations in the same order; the libraries' reductions differ by a few
ulps per iteration), equal iteration counts and status, and the
backtracking scales ``T`` exactly equal (powers of two)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu_torch as ptt
from proxmin_tpu_torch.interop import state_from_numpy
from proxmin_tpu_torch.solvers.common import grad_from_f

RTOL = 1e-9
CENTER = np.array([1.0, 0.5])
RADIUS = 0.5
DISK_OPT = RADIUS * CENTER / np.linalg.norm(CENTER)
X0 = np.array([-1.0, -1.0])

_pgm = functools.partial(ptt.pgm, device="cpu")
_adaprox = functools.partial(ptt.adaprox, device="cpu")
_nmf = functools.partial(ptt.nmf.nmf, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Lib:
    """The disk problem's callables in one package's array type."""

    def __init__(self, lib):
        self.lib = lib
        if lib is ptt:
            self.xp, self.c = torch, torch.from_numpy(CENTER)
            self.pgm, self.adaprox = _pgm, _adaprox
        else:
            self.xp, self.c = jnp, jnp.asarray(CENTER)
            self.pgm, self.adaprox = pt.pgm, pt.adaprox

    def f(self, x):
        return 0.5 * self.xp.sum((x - self.c) ** 2)

    def grad(self, x):
        return x - self.c

    def prox_disk(self, x, step):
        nrm = self.xp.sqrt(self.xp.sum(x ** 2))
        return self.xp.where(nrm > RADIUS, x * (RADIUS / nrm), x)


LIBS = (_Lib(pt), _Lib(ptt))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(rt, rj, rtol=RTOL):
    assert rt.iterations == rj.iterations
    assert rt.status == rj.status
    assert rt.converged == rj.converged
    xs_t = rt.x if isinstance(rt.x, tuple) else (rt.x,)
    xs_j = rj.x if isinstance(rj.x, tuple) else (rj.x,)
    for t, j in zip(xs_t, xs_j):
        np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=1e-15)
    if rj.history is None:
        assert rt.history is None
    else:
        assert rt.history.shape == rj.history.shape
        assert rt.history.dtype == rj.history.dtype
        # relative residuals: below 1e-12 they are rounding noise
        np.testing.assert_allclose(rt.history, rj.history, rtol=rtol,
                                   atol=1e-12)
    if "T" in rj.state:
        np.testing.assert_array_equal(_np(rt.state["T"]),
                                      _np(rj.state["T"]))


def _both(solve):
    """``solve(L)`` through the JAX package and the port."""
    rj, rt = (solve(L) for L in LIBS)
    return rt, rj


# ---------------------------------------------------------------------------
# backtracking

def test_backtracking_recovers_from_large_step():
    rt, rj = _both(lambda L: L.pgm(
        X0.copy(), L.grad, 50.0, backtracking=True, f=L.f, e_rel=1e-10,
        max_iter=500))
    _same(rt, rj)
    np.testing.assert_allclose(_np(rt.x), CENTER, atol=1e-7)
    assert float(rt.state["T"][0]) == 2.0 ** -6
    np.testing.assert_allclose(float(rt.state["f_prev"]),
                               float(rj.state["f_prev"]), rtol=1e-6,
                               atol=1e-18)


def test_backtracking_requires_f():
    with pytest.raises(AssertionError):
        _pgm(np.zeros(2), LIBS[1].grad, 1.0, backtracking=True)


@pytest.mark.parametrize("restart", [False, True])
def test_fista_backtracking_restart_trace(restart):
    """All the options compose: FISTA + backtracking (+ restart) + trace
    (tests/test_aux.py's case)."""
    rt, rj = _both(lambda L: L.pgm(
        X0.copy(), L.grad, 20.0, prox=L.prox_disk, accelerated=True,
        restart=restart, backtracking=True, f=L.f, e_rel=1e-8, max_iter=500,
        trace=True))
    _same(rt, rj)
    assert rt.history.shape == (rt.iterations, 1)
    np.testing.assert_allclose(_np(rt.x), DISK_OPT, atol=1e-4)


@pytest.mark.parametrize("x_first,c_first,steps,max_iter", [
    (0.5, [2.0, 0.0], (7.0, 0.9), 12),   # rel = [finite, inf]
    (0.0, [2.0, 0.0], (7.0, 0.9), 12),   # rel = [inf, inf]
    (0.0, [0.0, 0.0], (0.9, 5.0), 5),    # rel = [nan, inf]
    (0.5, [2.0, 0.0], (0.9, 5.0), 12),   # rel = [finite, inf]
])
def test_backtracking_halves_the_steepest_relative_block(x_first, c_first,
                                                         steps, max_iter):
    """Two blocks, one of them with a step several times too long: only the
    block with the largest ``max|S G| / max|x|`` halves its scale. A block
    that starts at zero makes that ratio x/0 = inf, or 0/0 = NaN where its
    gradient vanishes too; ``torch.argmax`` and ``jnp.argmax`` pick the same
    block there (the first inf, a NaN before an inf), so the scales stay
    equal, also where the rule halves the wrong block up to the cap. Few
    iterations: 60 halvings in each would take a scale below the smallest
    normal number, which the two libraries round differently."""
    def solve(L):
        c1 = L.xp.asarray(np.array(c_first))
        c2 = L.xp.asarray(np.array([[1.0, -1.0], [0.5, 3.0]]))

        def f(x1, x2):
            return (0.5 * L.xp.sum((x1 - c1) ** 2)
                    + 0.5 * L.xp.sum((x2 - c2) ** 2))

        x0 = [np.full(2, x_first), np.zeros((2, 2))]
        return L.pgm(x0, lambda x1, x2: (x1 - c1, x2 - c2), steps,
                     prox=[None, L.lib.operators.prox_plus],
                     backtracking=True, f=f, e_rel=1e-9, max_iter=max_iter)

    rt, rj = _both(solve)
    _same(rt, rj)
    assert _np(rt.state["T"]).min() < 1.0


@pytest.mark.parametrize("rel", [[1.0, np.inf], [np.nan, np.inf],
                                 [np.inf, np.nan], [np.inf, np.inf],
                                 [np.nan, np.nan], [0.0, np.nan, 5.0]])
def test_argmax_picks_the_same_block_on_inf_and_nan(rel):
    assert int(torch.argmax(torch.tensor(rel))) == int(
        jnp.argmax(jnp.asarray(rel)))


def test_backtracking_caps_the_halvings():
    """An ``f`` that accepts no point but the start stops at the cap of 60
    halvings per iteration, as in JAX."""
    def solve(L):
        return L.pgm(np.zeros(2), L.grad, 1.0, backtracking=True,
                     f=lambda x: L.f(x) + 1e6 * L.xp.sum(x != 0), e_rel=0,
                     max_iter=1)

    rt, rj = _both(solve)
    assert float(rt.state["T"][0]) == float(rj.state["T"][0]) == 2.0 ** -60


def test_backtracking_resume_and_jax_state_continued():
    """T and f_prev cross a resume (tests/test_resume.py's case), and a JAX
    backtracking state is continued in the port."""
    L = LIBS[1]
    kw = dict(backtracking=True, f=L.f, e_rel=0.0)
    full = L.pgm(X0.copy(), L.grad, 50.0, max_iter=30, **kw)
    half = L.pgm(X0.copy(), L.grad, 50.0, max_iter=15, **kw)
    assert float(half.state["T"][0]) < 1.0
    rest = L.pgm(half.x, L.grad, 50.0, max_iter=15, state=half.state, **kw)
    assert torch.equal(rest.x, full.x)
    assert torch.equal(rest.state["T"], full.state["T"])
    assert torch.equal(rest.state["f_prev"], full.state["f_prev"])
    J = LIBS[0]
    full_j = J.pgm(X0.copy(), J.grad, 50.0, max_iter=30, backtracking=True,
                   f=J.f, e_rel=0.0)
    half_j = J.pgm(X0.copy(), J.grad, 50.0, max_iter=15, backtracking=True,
                   f=J.f, e_rel=0.0)
    st = state_from_numpy(jax.tree_util.tree_map(np.asarray, half_j.state),
                          device="cpu")
    rest = L.pgm(np.asarray(half_j.x), L.grad, 50.0, max_iter=15, state=st,
                 **kw)
    # the straight run stops at an exact fixed point before 30
    assert rest.state["it"] == int(full_j.state["it"]) == (
        15 + rest.iterations)
    assert rest.status == full_j.status
    np.testing.assert_allclose(_np(rest.x), _np(full_j.x), rtol=RTOL)
    np.testing.assert_array_equal(_np(rest.state["T"]),
                                  _np(full_j.state["T"]))


# ---------------------------------------------------------------------------
# callbacks

def test_pgm_callback_and_stopiteration():
    def solve(L):
        seen = []

        def cb(*X, it=None):
            assert len(X) == 1 and X[0].shape == (2,)
            seen.append(it)
            if it >= 5:
                raise StopIteration

        res = L.pgm(X0.copy(), L.grad, 0.2, callback=cb, e_rel=1e-12,
                    max_iter=100)
        return res, seen

    (rj, seen_j), (rt, seen_t) = (solve(L) for L in LIBS)
    assert seen_t == seen_j == [0, 1, 2, 3, 4, 5]
    _same(rt, rj)
    assert rt.iterations == 5 and rt.status == "max_iter"
    # the final gradient is still computed, at the returned solution
    np.testing.assert_allclose(_np(rt.G), _np(rt.x) - CENTER, rtol=1e-15)
    np.testing.assert_allclose(_np(rt.G), _np(rj.G), rtol=RTOL)


def test_pgm_callback_gets_tensors_on_the_iterates_device():
    kinds = []
    _pgm(X0.copy(), LIBS[1].grad, 0.2, max_iter=2,
         callback=lambda *X, it=None: kinds.append(
             (type(X[0]), X[0].device.type)))
    assert kinds == [(torch.Tensor, "cpu")] * 2


def test_pgm_traceback_callback_matches_jax():
    tbs = []

    def solve(L):
        tb = L.lib.utils.Traceback()
        tbs.append(tb)
        return L.pgm(X0.copy(), L.grad, 1.0, callback=tb, e_rel=1e-6,
                     max_iter=50)

    rt, rj = _both(solve)
    _same(rt, rj)
    tj, tt = (tb.trace for tb in tbs)
    assert len(tt) == len(tj) >= 2
    for a, b in zip(tt, tj):
        np.testing.assert_allclose(a[0], b[0], rtol=RTOL, atol=1e-15)
    losses = [0.5 * np.sum((t[0] - CENTER) ** 2) for t in tt]
    assert all(l2 <= l1 + 1e-12 for l1, l2 in zip(losses, losses[1:]))


def test_pgm_callback_loop_equals_the_plain_loop():
    """FISTA through ``NullCallback`` equals no callback, bit for bit (one
    loop in the port), and equals JAX's callback mode."""
    L = LIBS[1]
    kw = dict(prox=L.prox_disk, accelerated=True, e_rel=1e-11, max_iter=300)
    r1 = L.pgm(X0.copy(), L.grad, 0.5, **kw)
    r2 = L.pgm(X0.copy(), L.grad, 0.5, callback=ptt.utils.NullCallback(),
               **kw)
    assert torch.equal(r1.x, r2.x) and r1.iterations == r2.iterations
    J = LIBS[0]
    rj = J.pgm(X0.copy(), J.grad, 0.5, prox=J.prox_disk, accelerated=True,
               e_rel=1e-11, max_iter=300, callback=pt.utils.NullCallback())
    _same(r2, rj)


def test_callback_mode_resume_exact():
    """A callback half and a callback resume equal the straight run without
    one (tests/test_resume.py's case)."""
    L = LIBS[1]
    H = torch.from_numpy(np.diag([1.0, 0.05]))
    grad = lambda x: H @ (x - 1.0)  # noqa: E731
    cb = lambda *X, it=None: None  # noqa: E731
    kw = dict(accelerated=True, e_rel=0.0)
    full = L.pgm(X0.copy(), grad, 1.0, max_iter=30, **kw)
    half = L.pgm(X0.copy(), grad, 1.0, max_iter=15, callback=cb, **kw)
    rest = L.pgm(half.x, grad, 1.0, max_iter=15, callback=cb,
                 state=half.state, **kw)
    assert torch.equal(rest.x, full.x)


def _weighted_problem(rng, C=4, K=3, N=100, dtype=np.float64):
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(dtype)
    W = (0.5 + rng.random((C, N))).astype(dtype)
    return Y, W, rng.random((C, K)).astype(dtype), rng.random(
        (K, N)).astype(dtype)


def test_weighted_pgm_stepper_callback_mode(rng):
    """WeightedPGMStepper through the callback loop: the same iterates as
    without a callback (bit for bit: one loop here) and as JAX's callback
    mode."""
    Y, W, A0, S0 = _weighted_problem(rng)
    hits = []
    kw = dict(W=W, e_rel=0, max_iter=25, step_stride=10)
    r_cb = _nmf(Y, A0.copy(), S0.copy(),
                callback=lambda *X, it=None: hits.append(it), **kw)
    assert hits == list(range(25))
    r_plain = _nmf(Y, A0.copy(), S0.copy(), **kw)
    for a, b in zip(r_cb.x, r_plain.x):
        assert torch.equal(a, b)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(),
                    callback=lambda *X, it=None: None, **kw)
    for t, j in zip(r_cb.x, rj.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)


def test_step_adapt_identical_through_callback_loop(rng):
    """The adaptive weighted stepper gives identical iterates with and
    without a callback (tests/test_aux.py's invariant), in float32, and the
    same refresh schedule as JAX's callback mode."""
    Y, W, A0, S0 = _weighted_problem(rng, N=48, dtype=np.float32)
    kw = dict(W=W, e_rel=0, max_iter=25, step_stride=4, step_adapt=True)
    r_plain = _nmf(Y, A0.copy(), S0.copy(), **kw)
    r_cb = _nmf(Y, A0.copy(), S0.copy(),
                callback=lambda *X, it=None: None, **kw)
    for a, b in zip(r_cb.x, r_plain.x):
        assert torch.equal(a, b)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(),
                    callback=lambda *X, it=None: None, **kw)
    sj, st = rj.state["stepper_state"], r_cb.state["stepper_state"]
    assert [int(v) for v in sj[2:]] == list(st[2:])
    for t, j in zip(r_cb.x, rj.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4,
                                   atol=2e-5)


def test_nmf_traceback_callback_matches_jax(rng):
    """The call most of the example scripts make: nmf(callback=Traceback())."""
    Y, _, A0, S0 = _weighted_problem(rng, N=40)
    tj, tt = pt.utils.Traceback(), ptt.utils.Traceback()
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=8,
                    callback=tj)
    rt = _nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=8, callback=tt)
    assert len(tt.trace) == len(tj.trace) == 8
    for a, b in zip(tt.trace, tj.trace):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=RTOL)
    np.testing.assert_array_equal(tt.trace[0][1], S0)
    for t, j in zip(rt.x, rj.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)


def test_cuda_engine_refuses_a_callback_and_user_steps(rng):
    Y, _, A0, S0 = _weighted_problem(rng, N=40, dtype=np.float32)
    for kw in ({"callback": ptt.utils.NullCallback()},
               {"step": ptt.nmf.step_pgm}):
        for algorithm in ("pgm", "adaprox"):
            with pytest.raises(ValueError, match="engine='torch'"):
                _nmf(Y, A0, S0, engine="cuda", algorithm=algorithm,
                     max_iter=2, **kw)


def test_adaprox_callback_stopiteration():
    def solve(L):
        seen = []

        def cb(*X, it=None):
            seen.append(it)
            if it >= 4:
                raise StopIteration

        return L.adaprox(X0.copy(), L.grad, 0.1, callback=cb,
                         max_iter=100), seen

    (rj, seen_j), (rt, seen_t) = (solve(L) for L in LIBS)
    assert seen_t == seen_j == [0, 1, 2, 3, 4]
    _same(rt, rj)
    assert rt.iterations == 4


@pytest.mark.parametrize("check", [True, False])
def test_adaprox_callback_loop_stops_as_jax(check):
    """The callback loop stops on convergence only with
    ``check_convergence``, and on divergence always."""
    def solve(L, grad=None):
        n = []
        res = L.adaprox(X0.copy(), grad or L.grad, 0.2, e_rel=1e-3,
                        max_iter=300, check_convergence=check,
                        callback=lambda *X, it=None: n.append(it))
        return res, len(n)

    (rj, n_j), (rt, n_t) = (solve(L) for L in LIBS)
    assert n_t == n_j == rt.iterations
    assert (rt.iterations < 300) == check
    _same(rt, rj)
    (rj, n_j), (rt, n_t) = (solve(L, lambda x: x * np.nan) for L in LIBS)
    assert rt.status == rj.status == "diverged"
    assert n_t == n_j == rt.iterations == 1


# ---------------------------------------------------------------------------
# trace

def test_pgm_trace():
    rt, rj = _both(lambda L: L.pgm(X0.copy(), L.grad, 0.3, e_rel=1e-8,
                                   max_iter=500, trace=True))
    _same(rt, rj)
    h = rt.history
    assert h.shape == (rt.iterations, 1) and h.dtype == np.float64
    assert h[-1, 0] <= 1e-8 < h[0, 0]


def test_pgm_trace_multiblock():
    def solve(L):
        return L.pgm([np.zeros(2), np.zeros(3)],
                     lambda x1, x2: (x1 - 1.0, x2 - 2.0), 0.5, e_rel=1e-8,
                     max_iter=200, trace=True)

    rt, rj = _both(solve)
    _same(rt, rj)
    assert rt.history.shape == (rt.iterations, 2)


def test_pgm_no_trace_by_default_and_an_empty_trace():
    L = LIBS[1]
    assert L.pgm(X0.copy(), L.grad, 0.3, max_iter=50).history is None
    empty = L.pgm(X0.copy(), L.grad, 0.3, max_iter=0, trace=True)
    assert empty.history.shape == (0, 1) and empty.iterations == 0


def test_pgm_trace_resume_concatenates():
    """A resumed solve's history holds this call's rows, which continue
    the first call's."""
    L = LIBS[1]
    kw = dict(accelerated=True, e_rel=0.0, trace=True)
    full = L.pgm(X0.copy(), L.grad, 0.3, max_iter=12, **kw)
    half = L.pgm(X0.copy(), L.grad, 0.3, max_iter=5, **kw)
    rest = L.pgm(half.x, L.grad, 0.3, max_iter=7, state=half.state, **kw)
    assert rest.history.shape == (7, 1)
    np.testing.assert_array_equal(
        np.concatenate([half.history, rest.history]), full.history)


@pytest.mark.parametrize("check", [True, False])
def test_adaprox_trace(check):
    rt, rj = _both(lambda L: L.adaprox(
        X0.copy(), L.grad, 0.1, e_rel=1e-6, max_iter=300, trace=True,
        check_convergence=check))
    _same(rt, rj)
    assert rt.history.shape == (rt.iterations, 1)
    if check:
        assert rt.history[-1, 0] <= 1e-6


def test_float32_trace_keeps_the_iterates_dtype():
    L = LIBS[1]
    c = L.c.to(torch.float32)
    res = L.pgm(X0.astype(np.float32), lambda x: x - c, 0.3, max_iter=5,
                e_rel=0, trace=True)
    assert res.history.dtype == np.float32 and res.history.shape == (5, 1)


# ---------------------------------------------------------------------------
# grad=None

def test_pgm_grad_none_autodiff():
    rt, rj = _both(lambda L: L.pgm(X0.copy(), None, 0.5, prox=L.prox_disk,
                                   f=L.f, e_rel=1e-10, max_iter=500))
    _same(rt, rj)
    np.testing.assert_allclose(_np(rt.x), DISK_OPT, atol=1e-8)
    L = LIBS[1]
    by_hand = L.pgm(X0.copy(), L.grad, 0.5, prox=L.prox_disk, e_rel=1e-10,
                    max_iter=500)
    np.testing.assert_allclose(_np(rt.x), _np(by_hand.x), rtol=1e-12)
    assert rt.iterations == by_hand.iterations
    assert not rt.x.requires_grad and not rt.G.requires_grad


def test_pgm_grad_none_multiblock():
    def solve(L):
        def f2(x1, x2):
            return (0.5 * L.xp.sum((x1 - 1.0) ** 2)
                    + 0.5 * L.xp.sum((x2 + 2.0) ** 2))

        return L.pgm([np.zeros(2), np.zeros(3)], None, 0.9, f=f2,
                     e_rel=1e-12, max_iter=500)

    rt, rj = _both(solve)
    _same(rt, rj)
    np.testing.assert_allclose(_np(rt.x[0]), np.ones(2), atol=1e-8)
    np.testing.assert_allclose(_np(rt.x[1]), -2 * np.ones(3), atol=1e-8)


def test_grad_none_requires_f():
    with pytest.raises(AssertionError):
        _pgm(np.zeros(2), None, 0.5)
    with pytest.raises(AssertionError):
        _adaprox(np.zeros(2), None, 0.5)


def test_adaprox_grad_none_autodiff():
    rt, rj = _both(lambda L: L.adaprox(X0.copy(), None, 0.1, f=L.f,
                                       e_rel=1e-8, max_iter=1000))
    _same(rt, rj)
    np.testing.assert_allclose(_np(rt.x), CENTER, atol=1e-3)


def test_grad_from_f_matches_jax_and_leaves_no_graph(rng):
    """The NMF likelihood's autodiff gradient equals the hand-written one
    and ``jax.grad``'s; the blocks handed in never come to require a
    gradient, an unused block gets zeros, and nothing is retained."""
    Y, _, A, S = _weighted_problem(rng, N=30)
    At, St, Yt = (torch.from_numpy(a) for a in (A, S, Y))
    g = grad_from_f(functools.partial(ptt.nmf.log_likelihood, Y=Yt), 2)
    got = g(At, St)
    want = jax.grad(functools.partial(pt.nmf.log_likelihood, Y=Y),
                    argnums=(0, 1))(jnp.asarray(A), jnp.asarray(S))
    for a, b, c in zip(got, want, ptt.nmf.grad_likelihood(At, St, Y=Yt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-11)
        assert not a.requires_grad and a.grad_fn is None
    assert not At.requires_grad and not St.requires_grad
    gz = grad_from_f(lambda a, s: torch.sum(a ** 2), 2)(At, St)
    assert torch.equal(gz[1], torch.zeros_like(St))
    with torch.no_grad():  # also from inside a no_grad block
        assert torch.equal(g(At, St)[0], got[0])
    with pytest.raises(ValueError):
        g(At)


def test_nmf_grad_none_through_pgm_matches_the_explicit_gradient(rng):
    """The slice as a whole on an NMF problem: pgm with f alone, FISTA and
    backtracking, against JAX with the same options."""
    Y, _, A0, S0 = _weighted_problem(rng, N=60)
    Yt = torch.from_numpy(Y)

    def solve(lib, f, pgm):
        return pgm([A0.copy(), S0.copy()], None,
                   lambda *X, it=None: tuple(
                       4 * s for s in lib.nmf.step_pgm(*X)),
                   prox=[lib.operators.prox_plus] * 2, f=f,
                   accelerated=True, backtracking=True, e_rel=0,
                   max_iter=20, trace=True)

    rj = solve(pt, functools.partial(pt.nmf.log_likelihood, Y=Y), pt.pgm)
    rt = solve(ptt, functools.partial(ptt.nmf.log_likelihood, Y=Yt), _pgm)
    _same(rt, rj)
    assert float(rt.state["T"].min()) < 1.0


# ---------------------------------------------------------------------------
# Barzilai-Borwein through the drivers

@pytest.mark.parametrize("bb_type", [1, 2])
def test_pgm_bb_stepper(bb_type):
    def solve(L):
        H = L.xp.asarray(np.diag([1.0, 0.05]))
        c = L.xp.asarray(np.array([1.0, 1.0]))
        return L.pgm(X0.copy(), lambda x: H @ (x - c),
                     L.lib.utils.BarzilaiBorweinStepper(type=bb_type,
                                                        init_r=0.1),
                     e_rel=1e-10, max_iter=2000)

    rt, rj = _both(solve)
    assert rt.iterations == rj.iterations and rt.status == "converged"
    np.testing.assert_allclose(_np(rt.x), _np(rj.x), rtol=1e-7)
    np.testing.assert_allclose(_np(rt.x), np.ones(2), atol=1e-6)


def test_bb_resume_and_jax_state_continued():
    """The BB history (previous iterate and gradient, Delta) crosses a
    resume, and a JAX BB state is continued in the port. The global clock
    continues, so the first-iteration branch does not fire again."""
    L, J = LIBS[1], LIBS[0]
    Ht, Hj = torch.from_numpy(np.diag([1.0, 0.02])), jnp.asarray(
        np.diag([1.0, 0.02]))
    gt = lambda x: Ht @ (x - 1.0)  # noqa: E731
    gj = lambda x: Hj @ (x - 1.0)  # noqa: E731
    bb_t = ptt.utils.BarzilaiBorweinStepper(type=1, init_r=0.1)
    bb_j = pt.utils.BarzilaiBorweinStepper(type=1, init_r=0.1)
    full = L.pgm(X0.copy(), gt, bb_t, e_rel=0.0, max_iter=24)
    half = L.pgm(X0.copy(), gt, bb_t, e_rel=0.0, max_iter=12)
    rest = L.pgm(half.x, gt, bb_t, e_rel=0.0, max_iter=12, state=half.state)
    assert torch.equal(rest.x, full.x)
    full_j = J.pgm(X0.copy(), gj, bb_j, e_rel=0.0, max_iter=24)
    half_j = J.pgm(X0.copy(), gj, bb_j, e_rel=0.0, max_iter=12)
    st = state_from_numpy(jax.tree_util.tree_map(np.asarray, half_j.state),
                          device="cpu")
    rest = L.pgm(np.asarray(half_j.x), gt, bb_t, e_rel=0.0, max_iter=12,
                 state=st)
    np.testing.assert_allclose(_np(rest.x), _np(full_j.x), rtol=RTOL)


def test_adaprox_takes_a_bb_stepper():
    rt, rj = _both(lambda L: L.adaprox(
        X0.copy(), L.grad, L.lib.utils.BarzilaiBorweinStepper(type=1),
        max_iter=5, check_convergence=False))
    _same(rt, rj)


# ---------------------------------------------------------------------------
# the structure check of a resumed stepper state

def test_pgm_resume_rejects_mismatched_stepper_state():
    L = LIBS[1]
    half = L.pgm(X0.copy(), L.grad, ptt.utils.BarzilaiBorweinStepper(type=1),
                 e_rel=0.0, max_iter=10)
    with pytest.raises(ValueError, match="stepper state structure"):
        L.pgm(half.x, L.grad, 1.0, max_iter=10, state=half.state)
    plain = L.pgm(X0.copy(), L.grad, 1.0, e_rel=0.0, max_iter=3)
    with pytest.raises(ValueError, match="stepper state structure"):
        L.pgm(plain.x, L.grad, ptt.utils.StridedStepper(0.5, 1, stride=3),
              max_iter=3, state=plain.state)


def test_adaprox_resume_rejects_mismatched_stepper_state():
    L = LIBS[1]
    half = L.adaprox(X0.copy(), L.grad,
                     ptt.utils.BarzilaiBorweinStepper(type=1), max_iter=5,
                     check_convergence=False)
    with pytest.raises(ValueError, match="stepper state structure"):
        L.adaprox(half.x, L.grad, 0.1, max_iter=5, state=half.state,
                  check_convergence=False)


@pytest.mark.parametrize("adapt", [False, True])
def test_a_strided_state_passes_the_structure_check(adapt):
    """A fresh StridedStepper state and a carried one have one structure
    (per-block placeholders until the first refresh), also when the solve
    stopped before it refreshed."""
    L = LIBS[1]
    make = lambda: ptt.utils.StridedStepper(  # noqa: E731
        lambda *X, it=None: 0.4, 1, stride=4, adapt=adapt)
    full = L.pgm(X0.copy(), L.grad, make(), e_rel=0.0, max_iter=11)
    none = L.pgm(X0.copy(), L.grad, make(), e_rel=0.0, max_iter=0)
    assert none.state["stepper_state"][1] == (0.0,)
    rest = L.pgm(none.x, L.grad, make(), e_rel=0.0, max_iter=11,
                 state=none.state)
    assert torch.equal(rest.x, full.x)
    half = L.pgm(X0.copy(), L.grad, make(), e_rel=0.0, max_iter=6)
    rest = L.pgm(half.x, L.grad, make(), e_rel=0.0, max_iter=5,
                 state=half.state)
    assert torch.equal(rest.x, full.x)
