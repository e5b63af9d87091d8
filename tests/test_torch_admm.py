"""The port's admm and sdmm against proxmin_tpu.admm / sdmm, on the same
NumPy inputs, in float64.

Tolerances and their reasons:
- iterates, errors and trace rows at a fixed iteration count: rtol 1e-9. The
  two solvers run the same operations in the same order; only the
  reductions' and BLAS libraries' summation orders differ (a few ulps per
  iteration).
- iteration counts, status, slack and restart counts: equal.
- a resume inside the port: bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu_torch as ptt
from proxmin_tpu_torch import linop as tl
from proxmin_tpu_torch.interop import state_from_numpy

F64 = dict(rtol=1e-9, atol=1e-12)

# NumPy inputs go to the card unless the caller names a device; these tests
# run on the CPU
t_admm = functools.partial(ptt.admm, device="cpu")
t_sdmm = functools.partial(ptt.sdmm, device="cpu")

CENTER = np.array([1.0, 0.5])
RADIUS = 0.5
DISK_OPT = RADIUS * CENTER / np.linalg.norm(CENTER)
X0 = np.array([-1.0, -1.0])


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=F64):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **tol)


def _numpy_state(state):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, state)


# each prox as a (port, JAX) pair of the same function

def quad(center=CENTER):
    """prox of f(x) = 0.5 ||x - center||^2."""
    ct, cj = _t(center), jnp.asarray(center)
    return (lambda v, s: (v + s * ct) / (1.0 + s),
            lambda v, s: (v + s * cj) / (1.0 + s))


def _disk_t(v, step, r=RADIUS):
    nrm = torch.sqrt(torch.sum(v ** 2))
    return torch.where(nrm > r, v * (r / nrm), v)


def _disk_j(v, step, r=RADIUS):
    nrm = jnp.sqrt(jnp.sum(v ** 2))
    return jnp.where(nrm > r, v * (r / nrm), v)


DISK = (_disk_t, _disk_j)


def soft(thresh):
    return (lambda v, s: ptt.operators.prox_soft(v, s, thresh=thresh),
            lambda v, s: pt.operators.prox_soft(v, s, thresh=thresh))


PLUS = (lambda v, s: torch.clamp_min(v, 0.0), lambda v, s: jnp.maximum(v, 0))


def _halfplane_t(v, step, i=1):
    out = v.clone()
    out[i] = torch.clamp_min(v[i], 0.15)
    return out


def halfplane(i):
    return (functools.partial(_halfplane_t, i=i),
            lambda v, s: v.at[i].set(jnp.maximum(v[i], 0.15)))


def both_admm(x0, prox_f, step_f, prox_g=None, L=None, **kw):
    """The same admm solve in the port and in JAX."""
    rt = t_admm(np.array(x0), prox_f[0], step_f,
                prox_g=None if prox_g is None else prox_g[0], L=L, **kw)
    rj = pt.admm(jnp.asarray(x0), prox_f[1], step_f,
                 prox_g=None if prox_g is None else prox_g[1],
                 L=None if L is None else jnp.asarray(L), **kw)
    return rt, rj


def both_sdmm(x0, prox_f, step_f, proxs_g, Ls=None, **kw):
    jLs = (None if Ls is None else
           [None if L is None else jnp.asarray(L) for L in Ls])
    rt = t_sdmm(np.array(x0), prox_f[0], step_f,
                proxs_g=[p[0] for p in proxs_g], Ls=Ls, **kw)
    rj = pt.sdmm(jnp.asarray(x0), prox_f[1], step_f,
                 proxs_g=[p[1] for p in proxs_g], Ls=jLs, **kw)
    return rt, rj


def assert_same_solve(rt, rj, multi=False):
    """Equal counts, status and slack; iterates and errors to rtol 1e-9."""
    assert rt.iterations == rj.iterations
    assert rt.total_iterations == rj.total_iterations
    assert rt.status == rj.status and rt.converged == rj.converged
    assert rt.slack == rj.slack
    assert isinstance(rt.x, torch.Tensor) and rt.x.dtype == torch.float64
    _close(rt.x, rj.x)
    _close(rt.errors, rj.errors)
    rows = rt.errors if multi else (rt.errors,)
    assert all(isinstance(v, float) for row in rows for v in row)


# ---------------------------------------------------------------------------
# admm

@pytest.mark.parametrize("kw", [dict(e_rel=0, max_iter=30),
                                dict(e_rel=1e-8, max_iter=2000)])
def test_admm_disk(kw):
    rt, rj = both_admm(X0, quad(), 0.5, DISK, **kw)
    assert_same_solve(rt, rj)
    converged, error = rt
    assert converged == rj[0] and len(error) == 4
    if kw["e_rel"]:
        assert converged and rt.status == "converged"
        _close(rt.x, DISK_OPT, dict(atol=1e-5))


def test_admm_no_constraint_fixed_point():
    """prox_g=None: the plain fixed-point method on prox_f."""
    rt, rj = both_admm(X0, quad(), 0.5, e_rel=1e-10, e_abs=1e-10,
                       max_iter=2000)
    assert_same_solve(rt, rj)
    _close(rt.x, CENTER, dict(atol=1e-5))
    assert rt.slack == 1.0


@pytest.mark.parametrize("step_g", [None, 0.7])
def test_admm_with_dense_operator(rng, step_g):
    """L inside g: a soft threshold on L x; with the derived and with a
    user step_g (the admm convention hands the convergence test the
    user's value, None when defaulted)."""
    L = rng.normal(size=(3, 2))
    rt, rj = both_admm(X0, quad(), 0.3, soft(0.1), L=L, step_g=step_g,
                       e_rel=0, e_abs=0, max_iter=40)
    assert_same_solve(rt, rj)
    rt, rj = both_admm(X0, quad(), 0.3, soft(0.1), L=L, step_g=step_g,
                       e_rel=1e-5, max_iter=3000)
    assert_same_solve(rt, rj)


def test_admm_callable_step_and_numpy_writeback():
    x_t = X0.copy()
    rt = t_admm(x_t, quad()[0], lambda X, it=None: 0.5 / (1 + it),
                prox_g=DISK[0], e_rel=0, max_iter=12)
    rj = pt.admm(jnp.asarray(X0), quad()[1],
                 lambda X, it=None: 0.5 / (1 + it), prox_g=DISK[1], e_rel=0,
                 max_iter=12)
    assert_same_solve(rt, rj)
    # the reference's "X will be updated" contract
    np.testing.assert_array_equal(x_t, rt.x.numpy())


def test_admm_restart_triggers_and_terminates():
    """A stalling problem triggers the slack-halving restart and still
    terminates (the total work is capped), on the JAX solver's counts."""
    const_f = (lambda v, s: torch.tensor([0.3, 0.3], dtype=v.dtype),
               lambda v, s: jnp.asarray([0.3, 0.3]))
    const_g = (lambda v, s: torch.tensor([9.0, 9.0], dtype=v.dtype),
               lambda v, s: jnp.asarray([9.0, 9.0]))
    rt, rj = both_admm(np.zeros(2), const_f, 0.5, const_g, e_rel=1e-6,
                       max_iter=50)
    assert_same_solve(rt, rj)
    assert rt.slack < 1.0                      # restarts happened
    assert rt.total_iterations > rt.iterations
    assert rt.total_iterations <= 8 * 50       # bounded work
    for k in ("it", "total_it", "slack"):
        assert rt.state[k] == np.asarray(rj.state[k])


def test_admm_status_reports_converged_and_max_iter():
    grad_step = (
        lambda x, s: ptt.operators.prox_plus(x - s * (x - 1.0), s),
        lambda x, s: pt.operators.prox_plus(x - s * (x - 1.0), s))
    rt, rj = both_admm(np.full(3, 5.0), grad_step, 0.5, PLUS, e_rel=1e-8,
                       max_iter=3000)
    assert_same_solve(rt, rj)
    assert rt.status == "converged" and rt.converged
    rt, rj = both_admm(np.full(3, 5.0), grad_step, 0.5, PLUS, e_rel=1e-12,
                       max_iter=3)
    assert_same_solve(rt, rj)
    assert rt.status == "max_iter" and not rt.converged


# ---------------------------------------------------------------------------
# sdmm

def test_sdmm_two_constraints():
    """Disk and half-plane x_1 >= 0.15."""
    rt, rj = both_sdmm(X0, quad(), 0.5, [DISK, halfplane(1)], e_rel=0,
                       max_iter=40)
    assert_same_solve(rt, rj, multi=True)
    rt, rj = both_sdmm(X0, quad(), 0.5, [DISK, halfplane(1)], e_rel=1e-8,
                       max_iter=3000)
    assert_same_solve(rt, rj, multi=True)
    x = rt.x.numpy()
    assert bool(rt) and np.linalg.norm(x) <= RADIUS + 1e-4
    assert x[1] >= 0.15 - 1e-4
    _close(x, DISK_OPT, dict(atol=1e-3))
    assert len(rt.errors) == 2 and len(rt.errors[0]) == 4


@pytest.mark.parametrize("steps_g", [None, [0.9, 1.3]])
def test_sdmm_operator_list(rng, steps_g):
    """Ls=[L1, None] with a soft threshold and non-negativity."""
    L1 = rng.normal(size=(2, 2))
    rt, rj = both_sdmm(X0, quad(), 0.3, [soft(0.05), PLUS], Ls=[L1, None],
                       steps_g=steps_g, e_rel=0, max_iter=25)
    assert_same_solve(rt, rj, multi=True)
    assert not rt


def test_sdmm_scalar_fallback_honors_e_abs():
    """The scalar spelling falls back to admm and forwards e_abs."""
    kw = dict(e_rel=1e-6, e_abs=1e-2, max_iter=2000)
    r_sdmm = t_sdmm(X0.copy(), quad()[0], 0.5, proxs_g=DISK[0], **kw)
    r_admm = t_admm(X0.copy(), quad()[0], 0.5, prox_g=DISK[0], **kw)
    r_jax = pt.sdmm(jnp.asarray(X0), quad()[1], 0.5, proxs_g=DISK[1], **kw)
    converged, error = r_sdmm  # admm-style return
    assert r_sdmm.iterations == r_admm.iterations == r_jax.iterations
    assert torch.equal(r_sdmm.x, r_admm.x)
    _close(r_sdmm.x, r_jax.x)
    r_tight = t_sdmm(X0.copy(), quad()[0], 0.5, proxs_g=DISK[0], e_rel=1e-6,
                     e_abs=0, max_iter=2000)
    assert r_sdmm.iterations < r_tight.iterations


def test_sdmm_one_element_list_against_the_scalar_form(rng):
    """The one-element list follows the sdmm convention (the evaluated
    step_g in the convergence test), the scalar form admm's (the user's
    step_g, None when defaulted): the iterates are the same, e_dual is
    not, in both packages alike."""
    L = rng.normal(size=(2, 2))
    kw = dict(e_rel=1e-4, max_iter=500)
    rt, rj = both_sdmm(X0, quad(), 0.3, [PLUS], Ls=[L], **kw)
    assert_same_solve(rt, rj, multi=True)
    assert bool(rt) and len(rt.errors) == 1
    st, sj = both_admm(X0, quad(), 0.3, PLUS, L=L, **kw)
    assert_same_solve(st, sj)
    kw = dict(e_rel=0, max_iter=20)
    rt, _ = both_sdmm(X0, quad(), 0.3, [PLUS], Ls=[L], **kw)
    st, _ = both_admm(X0, quad(), 0.3, PLUS, L=L, **kw)
    assert torch.equal(rt.x, st.x)


def test_sdmm_argument_checks_keep_their_exception_type():
    with pytest.raises(AssertionError):
        t_sdmm(X0.copy(), quad()[0], 0.5, proxs_g=[DISK[0]], Ls=[None, None])
    with pytest.raises(AssertionError):
        t_sdmm(X0.copy(), quad()[0], 0.5, proxs_g=[DISK[0], PLUS[0]],
               steps_g=[0.5])


# ---------------------------------------------------------------------------
# adapt_step

def _tv1d(rng, n=48):
    y = np.cumsum(rng.normal(size=n)) + 0.3 * rng.normal(size=n)
    D = np.eye(n)[1:] - np.eye(n)[:-1]
    return y, D


@pytest.mark.parametrize("step", [0.005, 0.5, 50.0])
def test_admm_adapt_step_matches_jax(rng, step):
    """Residual balancing on a mis-scaled step (both directions) and on a
    well-scaled one, where it never trips."""
    y, D = _tv1d(rng)
    kw = dict(L=D, e_rel=1e-5, max_iter=4000, adapt_step=True)
    rt, rj = both_admm(y, quad(y), step, soft(0.5), **kw)
    assert_same_solve(rt, rj)
    assert rt.converged
    _close(rt.state["step_scale"], rj.state["step_scale"], dict(rtol=0))
    if step == 0.5:
        plain = t_admm(y.copy(), quad(y)[0], step, prox_g=soft(0.5)[0], L=D,
                       e_rel=1e-5, max_iter=4000)
        assert plain.iterations == rt.iterations
        assert torch.equal(plain.x, rt.x)
    else:
        assert float(rt.state["step_scale"]) != 1.0


def test_sdmm_adapt_step_matches_jax():
    """A step wrong by orders of magnitude, at a fixed count (this problem
    converges to rounding noise, where the stopping iteration is the
    noise's), and to a tolerance the noise does not reach."""
    kw = dict(adapt_step=True)
    rt, rj = both_sdmm(X0, quad(), 200.0, [DISK, halfplane(0)], e_rel=0,
                       max_iter=25, **kw)
    assert_same_solve(rt, rj, multi=True)
    _close(rt.state["step_scale"], rj.state["step_scale"], dict(rtol=0))
    assert float(rt.state["step_scale"]) < 1.0
    rt, rj = both_sdmm(X0, quad(), 200.0, [DISK, halfplane(0)], e_rel=1e-3,
                       e_abs=1e-6, max_iter=20000, **kw)
    assert_same_solve(rt, rj, multi=True)
    assert rt.converged and rt.iterations < 100
    fixed = t_sdmm(X0.copy(), quad()[0], 200.0,
                   proxs_g=[DISK[0], halfplane(0)[0]], e_rel=1e-3,
                   e_abs=1e-6, max_iter=20000)
    assert rt.iterations < fixed.iterations


def test_adapt_step_rejects_explicit_step_g():
    with pytest.raises(ValueError, match="adapt_step"):
        t_admm(np.zeros(2), quad()[0], 0.5, prox_g=DISK[0], step_g=0.5,
               adapt_step=True)
    with pytest.raises(ValueError, match="adapt_step"):
        t_sdmm(np.zeros(2), quad()[0], 0.5, proxs_g=[DISK[0], DISK[0]],
               steps_g=[0.5, 0.5], adapt_step=True)


# ---------------------------------------------------------------------------
# failure detection, callback, trace

NAN = (lambda x, s: torch.full_like(x, float("nan")),
       lambda x, s: jnp.full_like(x, jnp.nan))
IDENT = (lambda x, s: x, lambda x, s: x)


def test_admm_divergence_detection():
    rt, rj = both_admm(np.ones(3), NAN, 0.5, PLUS, e_rel=1e-6, max_iter=200)
    assert rt.status == rj.status == "diverged"
    assert rt.iterations == rj.iterations < 200 and not rt.converged
    again = t_admm(rt.x, NAN[0], 0.5, prox_g=PLUS[0], max_iter=5,
                   state=rt.state)
    assert again.total_iterations == 0 and again.status == "diverged"


def test_sdmm_divergence_detection():
    rt, rj = both_sdmm(np.ones(3), NAN, 0.5, [PLUS, IDENT], e_rel=1e-6,
                       max_iter=200)
    assert rt.status == rj.status == "diverged"
    assert rt.iterations == rj.iterations < 200


def test_admm_callback_stopiteration():
    seen = []

    def cb(X, it=None):
        assert isinstance(X, torch.Tensor) and X.shape == (2,)
        seen.append(it)
        if it >= 3:
            raise StopIteration

    res = t_admm(X0.copy(), quad()[0], 0.5, prox_g=DISK[0], callback=cb,
                 e_rel=1e-12, max_iter=100)
    assert seen == [0, 1, 2, 3] and res.iterations == 3
    full = t_admm(X0.copy(), quad()[0], 0.5, prox_g=DISK[0], e_rel=1e-12,
                  max_iter=3)
    assert torch.equal(res.x, full.x)


def test_trace_history_matches_jax():
    rt, rj = both_admm(X0, quad(), 0.5, DISK, e_rel=0, max_iter=15,
                       trace=True)
    assert rt.history.shape == rj.history.shape == (15, 1, 4)
    _close(rt.history, rj.history)
    _close(rt.history[-1, 0], rt.errors)
    st, sj = both_sdmm(X0, quad(), 0.5, [DISK, halfplane(1)], e_rel=0,
                       max_iter=15, trace=True)
    assert st.history.shape == sj.history.shape == (15, 2, 4)
    _close(st.history, sj.history)
    assert t_admm(X0.copy(), quad()[0], 0.5, prox_g=DISK[0],
                  max_iter=3).history is None


def test_trace_history_is_clamped_under_a_restart_storm():
    """2 * max_iter rows hold a run of up to 8 * max_iter evaluations."""
    const_f = (lambda v, s: torch.tensor([0.3, 0.3], dtype=v.dtype),
               lambda v, s: jnp.asarray([0.3, 0.3]))
    const_g = (lambda v, s: torch.tensor([9.0, 9.0], dtype=v.dtype),
               lambda v, s: jnp.asarray([9.0, 9.0]))
    rt, rj = both_admm(np.zeros(2), const_f, 0.5, const_g, e_rel=1e-6,
                       max_iter=6, trace=True)
    assert rt.total_iterations == rj.total_iterations > 12
    assert rt.history.shape == rj.history.shape == (12, 1, 4)
    _close(rt.history, rj.history)


# ---------------------------------------------------------------------------
# resume

@pytest.mark.parametrize("adapt", [False, True])
def test_admm_resume_is_bit_exact(rng, adapt):
    y, D = _tv1d(rng)
    kw = dict(prox_g=soft(0.5)[0], L=D, e_rel=0, adapt_step=adapt)
    step = 50.0 if adapt else 0.5
    full = t_admm(y.copy(), quad(y)[0], step, max_iter=30, **kw)
    half = t_admm(y.copy(), quad(y)[0], step, max_iter=12, **kw)
    rest = t_admm(half.x, quad(y)[0], step, max_iter=18, state=half.state,
                  **kw)
    assert rest.iterations == 18 and rest.state["total_it"] == 30
    assert torch.equal(rest.x, full.x)
    assert rest.errors == full.errors
    for k in ("z", "u", "r_prev"):
        assert torch.equal(rest.state[k], full.state[k])


def test_sdmm_resume_across_a_restart_is_bit_exact():
    """The restart-resettable clock and the slack continue."""
    const_f = lambda v, s: torch.tensor([0.3, 0.3], dtype=v.dtype)  # noqa
    const_g = lambda v, s: torch.tensor([9.0, 9.0], dtype=v.dtype)  # noqa
    kw = dict(proxs_g=[const_g, PLUS[0]], e_rel=1e-6)
    full = t_sdmm(np.zeros(2), const_f, 0.5, max_iter=40, **kw)
    assert full.slack < 1.0
    half = t_sdmm(np.zeros(2), const_f, 0.5, max_iter=4, **kw)
    assert half.slack < 1.0 and half.total_iterations > 4
    rest = t_sdmm(half.x, const_f, 0.5, max_iter=36, state=half.state, **kw)
    assert torch.equal(rest.x, full.x) and rest.slack == full.slack
    assert rest.state["total_it"] == full.state["total_it"]
    assert rest.state["it"] == full.state["it"]
    # a resumed solve reports this call's steps
    assert rest.iterations == rest.total_iterations \
        == full.total_iterations - half.total_iterations


@pytest.mark.parametrize("solver", ["admm", "admm adapt", "sdmm"])
def test_continue_a_jax_solve_in_the_port(rng, solver):
    """12 JAX iterations, then 18 in the port from state_from_numpy,
    against 30 JAX iterations."""
    y, D = _tv1d(rng)
    D2 = rng.normal(size=(5, y.size))
    if solver == "sdmm":
        def jax_run(n, x=y, **kw):
            return pt.sdmm(jnp.asarray(x), quad(y)[1], 0.5,
                           proxs_g=[soft(0.5)[1], PLUS[1]],
                           Ls=[jnp.asarray(D), jnp.asarray(D2)], e_rel=0,
                           max_iter=n, **kw)

        def port_run(n, x, **kw):
            return t_sdmm(x, quad(y)[0], 0.5, proxs_g=[soft(0.5)[0], PLUS[0]],
                          Ls=[D, D2], e_rel=0, max_iter=n, **kw)
    else:
        adapt = solver.endswith("adapt")
        step = 50.0 if adapt else 0.5

        def jax_run(n, x=y, **kw):
            return pt.admm(jnp.asarray(x), quad(y)[1], step,
                           prox_g=soft(0.5)[1], L=jnp.asarray(D), e_rel=0,
                           max_iter=n, adapt_step=adapt, **kw)

        def port_run(n, x, **kw):
            return t_admm(x, quad(y)[0], step, prox_g=soft(0.5)[0], L=D,
                          e_rel=0, max_iter=n, adapt_step=adapt, **kw)
    full, half = jax_run(30), jax_run(12)
    state = state_from_numpy(_numpy_state(half.state), device="cpu")
    assert isinstance(state["slack"], float) and state["total_it"] == 12
    rest = port_run(18, np.asarray(half.x), state=state)
    assert rest.iterations == 18 and rest.state["total_it"] == 30
    _close(rest.x, full.x)
    _close(rest.errors, full.errors)
    # and the straight run in the port agrees too
    _close(port_run(30, y.copy()).x, full.x)


# ---------------------------------------------------------------------------
# the slice as a whole: a small anisotropic TV denoise

def _tv_problem(H=32, dtype=np.float64):
    rng = np.random.default_rng(11)
    truth = np.zeros((H, H), dtype)
    truth[H // 8: H // 2, H // 6: H // 2] = 1.0
    truth[5 * H // 8: 7 * H // 8, H // 3: 5 * H // 6] = -0.6
    y = truth + 0.3 * rng.standard_normal((H, H)).astype(dtype)
    return truth, y


def _tv_ops(lib, H, dtype):
    cat = jnp.concatenate if lib is jnp else (
        lambda xs, axis: torch.cat(xs, dim=axis))
    mod = pt.linop if lib is jnp else tl

    def dh_T(v):
        return cat([-v[:, :1], v[:, :-1] - v[:, 1:], v[:, -1:]], axis=1)

    def dv_T(v):
        return cat([-v[:1, :], v[:-1, :] - v[1:, :], v[-1:, :]], axis=0)

    return (mod.FunctionOperator(lambda x: x[:, 1:] - x[:, :-1], dh_T,
                                 (H, H), dtype=dtype, norm_sq=4.0),
            mod.FunctionOperator(lambda x: x[1:, :] - x[:-1, :], dv_T,
                                 (H, H), dtype=dtype, norm_sq=4.0))


def test_tv_denoise_sdmm_matches_jax():
    H, lam = 32, 0.4
    truth, y = _tv_problem(H)
    ops_t = _tv_ops(torch, H, torch.float64)
    ops_j = _tv_ops(jnp, H, np.float64)
    x0 = np.zeros((H, H))
    run_t = functools.partial(t_sdmm, prox_f=quad(y)[0], step_f=0.5,
                              proxs_g=[soft(lam)[0]] * 2, Ls=list(ops_t))
    run_j = functools.partial(pt.sdmm, prox_f=quad(y)[1], step_f=0.5,
                              proxs_g=[soft(lam)[1]] * 2, Ls=list(ops_j))
    rt = run_t(x0.copy(), e_rel=0, e_abs=0, max_iter=60)
    rj = run_j(jnp.asarray(x0), e_rel=0, e_abs=0, max_iter=60)
    assert_same_solve(rt, rj, multi=True)
    # the benchmark's quality row: the solve denoises, on the JAX count
    rt = run_t(x0.copy(), e_rel=1e-4, max_iter=400)
    rj = run_j(jnp.asarray(x0), e_rel=1e-4, max_iter=400)
    assert_same_solve(rt, rj, multi=True)
    rmse_in = np.sqrt(np.mean((y - truth) ** 2))
    rmse_out = np.sqrt(np.mean((rt.x.numpy() - truth) ** 2))
    assert rmse_out < 0.5 * rmse_in
    # the one-constraint solve through admm, with the operator as L
    at = t_admm(x0.copy(), quad(y)[0], 0.5, prox_g=soft(lam)[0], L=ops_t[0],
                e_rel=0, e_abs=0, max_iter=40)
    aj = pt.admm(jnp.asarray(x0), quad(y)[1], 0.5, prox_g=soft(lam)[1],
                 L=ops_j[0], e_rel=0, e_abs=0, max_iter=40)
    assert_same_solve(at, aj)


def test_tv_denoise_with_the_prox_kernel_wrapper_is_bitwise():
    """ops.prox_soft_pallas (on CPU tensors its plain version) as prox_g
    gives operators.prox_soft's iterates bit for bit, in float32."""
    H, lam = 16, 0.4
    _, y = _tv_problem(H, np.float32)
    ops = _tv_ops(torch, H, torch.float32)
    yt = _t(y)
    kw = dict(Ls=list(ops), e_rel=0, e_abs=0, max_iter=25)

    def prox_f(v, s):
        return (v + s * yt) / (1.0 + s)

    plain = t_sdmm(torch.zeros((H, H)), prox_f, 0.5, proxs_g=[
        functools.partial(ptt.operators.prox_soft, thresh=lam)] * 2, **kw)
    k4 = t_sdmm(torch.zeros((H, H)), prox_f, 0.5, proxs_g=[
        functools.partial(ptt.ops.prox_soft_pallas, thresh=lam)] * 2, **kw)
    assert plain.x.dtype == torch.float32
    assert torch.equal(plain.x, k4.x) and plain.errors == k4.errors


# ---------------------------------------------------------------------------
# devices

@pytest.mark.parametrize("entry", ["admm", "sdmm", "sdmm list"])
def test_numpy_inputs_go_to_the_card_or_raise(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "admm": lambda **kw: ptt.admm(X0.copy(), quad()[0], 0.5,
                                      prox_g=DISK[0], max_iter=2, **kw),
        "sdmm": lambda **kw: ptt.sdmm(X0.copy(), quad()[0], 0.5,
                                      proxs_g=DISK[0], max_iter=2, **kw),
        "sdmm list": lambda **kw: ptt.sdmm(X0.copy(), quad()[0], 0.5,
                                           proxs_g=[DISK[0]], max_iter=2,
                                           **kw),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    assert calls[entry](device="cpu").x.device.type == "cpu"
    # a tensor input is the caller's choice of device, its operator follows
    res = ptt.admm(_t(X0), quad()[0], 0.5, prox_g=DISK[0], L=np.eye(2),
                   max_iter=2)
    assert res.x.device.type == "cpu"
