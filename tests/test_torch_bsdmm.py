"""The port's bsdmm and nmf(algorithm="bsdmm") against proxmin_tpu, on the
same seeded NumPy inputs, in float64.

Tolerances and their reasons:
- iterates and trace rows at a fixed sweep count: rtol 1e-9. The two
  solvers run the same operations in the same order; only the reductions'
  and BLAS libraries' summation orders differ (grown by the nonconvex NMF
  iteration).
- sweep counts, status, strides and refresh clocks: equal.
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
from proxmin_tpu_torch import nmf as tnmf
from proxmin_tpu_torch.interop import state_from_numpy

F64 = dict(rtol=1e-9, atol=1e-12)

# NumPy inputs go to the card unless the caller names a device; these tests
# run on the CPU
t_bsdmm = functools.partial(ptt.bsdmm, device="cpu")
t_nmf = functools.partial(ptt.nmf.nmf, device="cpu")

C1 = np.array([1.0, -0.5])
C2 = np.array([0.2, 0.8, -0.1])


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


def _close_blocks(rt, rj):
    assert len(rt.x) == len(rj.x)
    for a, b in zip(rt.x, rj.x):
        assert isinstance(a, torch.Tensor)
        _close(a, b)


def _numpy_state(state):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, state)


def _same_counts(rt, rj):
    assert rt.iterations == rj.iterations and rt.status == rj.status
    assert tuple(rt.converged) == tuple(rj.converged) == tuple(rt)


# the two-block quadratic of the JAX suite, in both packages

def _quad_t(x, step, Xs=None, j=None):
    return (x + step * _t([C1, C2][j])) / (1 + step)


def _quad_j(x, step, Xs=None, j=None):
    return (x + step * jnp.asarray([C1, C2][j])) / (1 + step)


def _coupled_t(x, step, Xs=None, j=None):
    c = _t([np.array([2.0]), np.array([3.0])][j]) + 0.1 * Xs[1 - j]
    return (x + step * c) / (1 + step)


def _coupled_j(x, step, Xs=None, j=None):
    c = jnp.asarray([np.array([2.0]), np.array([3.0])][j]) + 0.1 * Xs[1 - j]
    return (x + step * c) / (1 + step)


def _plus_t(v, step):
    return torch.clamp_min(v, 0.0)


def _plus_j(v, step):
    return jnp.maximum(v, 0)


def _steps(Xs, j=None):
    return 0.4


def _steps_by_block(Xs, j=None):
    """A step that changes from sweep to sweep with the iterate."""
    return 0.3 + 0.05 * j + 0.01 * abs(Xs[j]).sum()


def both(x0, proxs_f, steps, nest=lambda lib: None, **kw):
    """The same bsdmm solve in the port and in JAX. ``nest(lib, j)`` gives
    the library's nested arguments (proxs_g, Ls)."""
    rt = t_bsdmm([np.array(b) for b in x0], proxs_f[0], steps,
                 **(nest("t") or {}), **kw)
    rj = pt.bsdmm([jnp.asarray(b) for b in x0], proxs_f[1], steps,
                  **(nest("j") or {}), **kw)
    return rt, rj


def _nested(lib, L=None):
    pg = _plus_t if lib == "t" else _plus_j
    out = {"proxs_g": [[pg], [pg, pg]]}
    if L is not None:
        out["Ls"] = [None, [L if lib == "t" else jnp.asarray(L), None]]
    return out


# ---------------------------------------------------------------------------
# the solver

def test_bsdmm_with_constraints(rng):
    """Blocks with per-block constraint lists (nested proxs_g)."""
    rt, rj = both([C1 * 0, C2 * 0], (_quad_t, _quad_j), _steps,
                  lambda lib: _nested(lib), e_rel=0, max_iter=20)
    _same_counts(rt, rj)
    _close_blocks(rt, rj)
    assert rt.iterations == 20 and rt.status == "max_iter"
    assert isinstance(rt.state["z"][1], tuple) and len(rt.state["z"][1]) == 2


def test_bsdmm_with_operators_and_mixed_blocks(rng):
    """A dense L inside one constraint, and an unconstrained block beside a
    constrained one."""
    L = rng.normal(size=(4, 3))
    rt, rj = both([C1 * 0, C2 * 0], (_quad_t, _quad_j), _steps,
                  lambda lib: _nested(lib, L), e_rel=0, max_iter=20)
    _same_counts(rt, rj)
    _close_blocks(rt, rj)
    mixed = lambda lib: {"proxs_g": [None, _plus_t if lib == "t"  # noqa
                                     else _plus_j]}
    # (with e_abs=0 an unconstrained block converges only at an exact
    # fixed point, which is the rounding's to decide)
    rt, rj = both([C1 * 0, C2 * 0], (_quad_t, _quad_j), _steps, mixed,
                  e_rel=1e-6, e_abs=1e-9, max_iter=500)
    _same_counts(rt, rj)
    _close_blocks(rt, rj)
    assert rt.status == "converged" and all(rt)
    assert isinstance(rt.state["z"][0], torch.Tensor)


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_bsdmm_update_order(order):
    """The order of the Gauss-Seidel sweep: block j's prox sees the blocks
    already updated."""
    rt, rj = both([np.zeros(1), np.zeros(1)], (_coupled_t, _coupled_j),
                  lambda Xs, j=None: 0.5, update_order=order, e_rel=0,
                  max_iter=12)
    _close_blocks(rt, rj)
    other = t_bsdmm([np.zeros(1), np.zeros(1)], _coupled_t,
                    lambda Xs, j=None: 0.5, update_order=order[::-1],
                    e_rel=0, max_iter=1)
    first = t_bsdmm([np.zeros(1), np.zeros(1)], _coupled_t,
                    lambda Xs, j=None: 0.5, update_order=order, e_rel=0,
                    max_iter=1)
    assert not torch.equal(other.x[0], first.x[0])


@pytest.mark.parametrize("mode,steps_g", [
    ("steps_f", None), ("steps_f", [[0.5], [0.6, 0.7]]),
    ("fixed", [[0.5], [0.6, 0.7]]), ("relative", [[0.5], [0.6, 0.7]]),
    ("relative", None), ("FIXED", 0.8)])
def test_bsdmm_steps_g_update_modes(mode, steps_g):
    """'steps_f' derives steps_g (and drops a given one), 'fixed' keeps the
    given one, 'relative' rescales it by the block step's change from the
    second sweep on; without steps_g both fall back to 'steps_f'."""
    rt, rj = both([C1 * 0, C2 * 0], (_quad_t, _quad_j), _steps_by_block,
                  lambda lib: _nested(lib), steps_g=steps_g,
                  steps_g_update=mode, e_rel=0, max_iter=15)
    _close_blocks(rt, rj)
    for a, b in zip(rt.state["steps_g"], rj.state["steps_g"]):
        _close([float(v) for v in a], [float(v) for v in b])
    _close([float(v) for v in rt.state["steps_f"]], rj.state["steps_f"])


def test_bsdmm_steps_f_stride():
    """The step callable runs on sweeps 0, 4, 8 only, for each block; in
    between the carried step (shrunk by 0.9) serves."""
    calls = []

    def steps(Xs, j=None):
        calls.append(j)
        return _steps_by_block(Xs, j)

    rt = t_bsdmm([C1 * 0, C2 * 0], _quad_t, steps, proxs_g=_nested("t")[
        "proxs_g"], e_rel=0, max_iter=10, steps_f_stride=4)
    assert calls == [0, 1] * 3
    rj = pt.bsdmm([jnp.zeros(2), jnp.zeros(3)], _quad_j, _steps_by_block,
                  proxs_g=_nested("j")["proxs_g"], e_rel=0, max_iter=10,
                  steps_f_stride=4)
    _close_blocks(rt, rj)
    assert rt.state["stride_config"] == (4, 0, False)
    with pytest.raises(ValueError, match="step-stride"):
        t_bsdmm(list(rt.x), _quad_t, steps, proxs_g=_nested("t")["proxs_g"],
                max_iter=2, steps_f_stride=2, state=rt.state)


def test_bsdmm_callback_and_trace():
    seen = []

    def cb(*X, it=None):
        assert len(X) == 2 and isinstance(X[0], torch.Tensor)
        seen.append(it)
        if it >= 2:
            raise StopIteration

    res = t_bsdmm([C1 * 0, C2 * 0], _quad_t, _steps, callback=cb,
                  max_iter=100)
    assert seen == [0, 1, 2] and res.iterations == 2
    rt, rj = both([C1 * 0, C2 * 0], (_quad_t, _quad_j), _steps,
                  lambda lib: _nested(lib), e_rel=0, max_iter=9, trace=True)
    assert rt.history.shape == rj.history.shape == (9, 2, 2)
    _close(rt.history, rj.history)
    assert t_bsdmm([C1 * 0], _quad_t, _steps, max_iter=2).history is None


def test_bsdmm_per_block_tolerances():
    """Sequences (and arrays) of per-block tolerances; the loose block
    converges first and the solve goes on until both have."""
    kw = dict(e_rel=np.asarray([1e-2, 1e-7]), e_abs=[1e-3, 1e-9],
              max_iter=400)
    rt, rj = both([C1 * 0, C2 * 0], (_quad_t, _quad_j), _steps, **kw)
    _same_counts(rt, rj)
    _close_blocks(rt, rj)
    assert rt.status == "converged"
    assert 20 < rt.iterations < 400
    early = t_bsdmm([C1 * 0, C2 * 0], _quad_t, _steps, max_iter=20,
                    e_rel=[1e-2, 1e-7], e_abs=[1e-3, 1e-9])
    assert early.converged == (True, False)


def test_bsdmm_divergence_detection():
    nan_t = lambda v, s, Xs=None, j=None: (  # noqa: E731
        torch.full_like(v, float("nan")) if j == 1 else v)
    nan_j = lambda v, s, Xs=None, j=None: (  # noqa: E731
        jnp.full_like(v, jnp.nan) if j == 1 else v)
    nest = lambda lib: {"proxs_g": [_plus_t, _plus_t] if lib == "t"  # noqa
                        else [_plus_j, _plus_j]}
    rt, rj = both([np.ones(3), np.ones(2)], (nan_t, nan_j),
                  lambda Xs, j=None: 0.5, nest, e_rel=1e-6, max_iter=200)
    assert rt.status == rj.status == "diverged"
    assert rt.iterations == rj.iterations < 200
    again = t_bsdmm(list(rt.x), nan_t, lambda Xs, j=None: 0.5,
                    proxs_g=[_plus_t, _plus_t], max_iter=5, state=rt.state)
    assert again.iterations == 0 and again.status == "diverged"


def test_bsdmm_resume_is_bit_exact_and_continues_a_jax_state():
    """'relative' steps with a stride: the carried steps and the sweep
    clock continue, in the port bit for bit and from a JAX state to
    rtol 1e-9."""
    kw = dict(steps_g=[[0.5], [0.6, 0.7]], steps_g_update="relative",
              e_rel=0, steps_f_stride=3)
    t_kw = dict(kw, proxs_g=_nested("t")["proxs_g"])
    j_kw = dict(kw, proxs_g=_nested("j")["proxs_g"])
    full = t_bsdmm([C1 * 0, C2 * 0], _quad_t, _steps_by_block, max_iter=14,
                   **t_kw)
    half = t_bsdmm([C1 * 0, C2 * 0], _quad_t, _steps_by_block, max_iter=5,
                   **t_kw)
    rest = t_bsdmm(list(half.x), _quad_t, _steps_by_block, max_iter=9,
                   state=half.state, **t_kw)
    assert rest.iterations == 9 and rest.state["it"] == 14
    for a, b in zip(rest.x, full.x):
        assert torch.equal(a, b)
    assert rest.state["steps_f"] == full.state["steps_f"]

    x0 = [jnp.zeros(2), jnp.zeros(3)]
    jfull = pt.bsdmm(x0, _quad_j, _steps_by_block, max_iter=14, **j_kw)
    jhalf = pt.bsdmm(x0, _quad_j, _steps_by_block, max_iter=5, **j_kw)
    state = state_from_numpy(_numpy_state(jhalf.state), device="cpu")
    assert state["it"] == 5 and state["stride_config"] == (3, 0, False)
    cont = t_bsdmm([np.asarray(b) for b in jhalf.x], _quad_t,
                   _steps_by_block, max_iter=9, state=state, **t_kw)
    assert cont.iterations == 9 and cont.state["it"] == 14
    _close_blocks(cont, jfull)
    _close_blocks(full, jfull)


def test_bsdmm_argument_checks():
    with pytest.raises(AssertionError):
        t_bsdmm([C1 * 0, C2 * 0], _quad_t, _steps, proxs_g=[_plus_t])
    with pytest.raises(AssertionError):
        t_bsdmm([C1 * 0], _quad_t, _steps, steps_g_update="sometimes")
    with pytest.raises(AssertionError):
        t_bsdmm([C1 * 0, C2 * 0], _quad_t, _steps,
                proxs_g=[[_plus_t], [_plus_t]], Ls=[[None, None], [None]])

    class Stateful:
        def init_bsdmm_state(self, xs):
            return ()

    with pytest.raises(AssertionError, match="striding"):
        t_bsdmm([C1 * 0], _quad_t, Stateful(), steps_f_stride=2)


def test_numpy_inputs_go_to_the_card_or_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ptt.bsdmm([C1 * 0, C2 * 0], _quad_t, _steps, max_iter=2)
    x = [C1 * 0, C2 * 0]
    res = t_bsdmm(x, _quad_t, _steps, max_iter=3)
    assert res.x[0].device.type == "cpu"
    # the reference's "X will be updated" contract
    np.testing.assert_array_equal(x[1], res.x[1].numpy())
    assert ptt.bsdmm([_t(C1 * 0)], _quad_t, _steps,
                     max_iter=2).x[0].device.type == "cpu"


# ---------------------------------------------------------------------------
# nmf(algorithm="bsdmm")

def _problem(seed=101, C=5, K=3, N=120):
    rng = np.random.default_rng(seed)
    Y = (rng.random((C, K)) @ rng.random((K, N))
         + 0.01 * rng.standard_normal((C, N)))
    W = 0.5 + rng.random((C, N))
    return Y, rng.random((C, K)), rng.random((K, N)), W


def both_nmf(Y, A0, S0, **kw):
    rt = t_nmf(Y, A0.copy(), S0.copy(), algorithm="bsdmm", **kw)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="bsdmm", **kw)
    return rt, rj


@pytest.mark.parametrize("kw", [
    {}, {"prox_A": None, "prox_S": None}, {"weighted": True},
    {"step_stride": 4}, {"weighted": True, "step_stride": 4},
    {"weighted": True, "step_stride": 2, "step_adapt": True},
    {"weighted": True, "step_adapt": True}],
    ids=["plain", "prox None", "weighted", "stride 4", "weighted stride 4",
         "weighted adaptive from 2", "weighted adaptive"])
def test_nmf_bsdmm_matches_jax(kw):
    """Unweighted and weighted, exact and strided steps, the
    WeightedBSDMMStepper fixed and adaptive against the JAX stepper."""
    Y, A0, S0, W = _problem()
    kw = dict(kw)
    if kw.pop("weighted", False):
        kw["W"] = W
    rt, rj = both_nmf(Y, A0, S0, e_rel=0, max_iter=24, **kw)
    _same_counts(rt, rj)
    _close_blocks(rt, rj)
    assert rt.x[0].dtype == torch.float64
    assert rt.state["stride_config"] == tuple(rj.state["stride_config"])
    if "W" in kw and (kw.get("step_stride") or kw.get("step_adapt")):
        # the stepper state: the power iterate, strides and clocks
        v_t, strides_t, nxt_t = rt.state["steps_state"]
        v_j, strides_j, nxt_j = rj.state["steps_state"]
        _close(v_t, v_j, dict(rtol=1e-9, atol=1e-15))
        assert strides_t == tuple(np.asarray(strides_j))
        assert nxt_t == tuple(np.asarray(nxt_j))
        assert all(isinstance(s, int) for s in strides_t + nxt_t)
        if kw.get("step_adapt"):
            assert max(strides_t) > (kw.get("step_stride") or 1)


def test_nmf_bsdmm_is_a_gauss_seidel_pgm_step():
    """With no proxs_g a bsdmm sweep is a PGM step whose S update sees the
    new A; it lowers the loss as PGM does."""
    Y, A0, S0, _ = _problem()
    rb = t_nmf(Y, A0.copy(), S0.copy(), algorithm="bsdmm", e_rel=0,
               max_iter=40)
    rp = t_nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=40)
    loss = lambda r: float(tnmf.log_likelihood(*r.x, Y=_t(Y)))  # noqa: E731
    l0 = float(tnmf.log_likelihood(_t(A0), _t(S0), Y=_t(Y)))
    assert loss(rb) < 0.1 * l0 and loss(rp) < 0.1 * l0
    # ten sweeps by hand: the A step, then the S step at the new A
    ten = t_nmf(Y, A0.copy(), S0.copy(), algorithm="bsdmm", e_rel=0,
                max_iter=10)
    A, S, Yt = _t(A0), _t(S0), _t(Y)
    for _ in range(10):
        gA = tnmf.grad_likelihood(A, S, Y=Yt)[0]
        A = torch.clamp_min(A - tnmf.step_A(A, S) * gA, 0)
        gS = tnmf.grad_likelihood(A, S, Y=Yt)[1]
        S = torch.clamp_min(S - tnmf.step_S(A, S) * gS, 0)
    _close(ten.x[0], A, dict(rtol=1e-12))
    _close(ten.x[1], S, dict(rtol=1e-12))
    # PGM updates both factors from the old ones: another trajectory
    assert not np.allclose(ten.x[1].numpy(), t_nmf(
        Y, A0.copy(), S0.copy(), e_rel=0, max_iter=10).x[1].numpy(),
        rtol=1e-3)


def test_nmf_bsdmm_computes_one_gradient_and_one_step_per_block(monkeypatch):
    """The host loop computes block j's gradient and step only (the JAX
    adapters compute both and let the compiler drop one)."""
    Y, A0, S0, W = _problem()
    calls = {"grad": [], "A": 0, "S": 0}
    real_grad = tnmf._block_gradient
    real_A, real_S = tnmf._weighted_lipschitz_A, tnmf._weighted_lipschitz_S

    def grad(Xs, j, Y, W):
        calls["grad"].append(j)
        return real_grad(Xs, j, Y, W)

    def lip_A(*a, **k):
        calls["A"] += 1
        return real_A(*a, **k)

    def lip_S(*a, **k):
        calls["S"] += 1
        return real_S(*a, **k)

    monkeypatch.setattr(tnmf, "_block_gradient", grad)
    monkeypatch.setattr(tnmf, "_weighted_lipschitz_A", lip_A)
    monkeypatch.setattr(tnmf, "_weighted_lipschitz_S", lip_S)
    t_nmf(Y, A0.copy(), S0.copy(), W=W, algorithm="bsdmm", e_rel=0,
          max_iter=6)
    assert calls == {"grad": [0, 1] * 6, "A": 6, "S": 6}
    for j in (0, 1):
        both_g = tnmf.grad_likelihood(_t(A0), _t(S0), Y=_t(Y), W=_t(W))
        assert torch.equal(real_grad((_t(A0), _t(S0)), j, _t(Y), _t(W)),
                           both_g[j])


def test_nmf_bsdmm_with_constraints_and_custom_steps():
    """A sum-to-one constraint on S as proxs_g through nmf's
    algorithm_args, and a custom step function with a stride."""
    Y, A0, S0, _ = _problem()
    unity_t = functools.partial(ptt.operators.prox_unity, axis=0)
    unity_j = functools.partial(pt.operators.prox_unity, axis=0)
    rt = t_nmf(Y, A0.copy(), S0.copy(), algorithm="bsdmm", e_rel=0,
               max_iter=20, proxs_g=[None, [unity_t]])
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="bsdmm", e_rel=0,
                    max_iter=20, proxs_g=[None, [unity_j]])
    _close_blocks(rt, rj)
    rt = t_nmf(Y, A0.copy(), S0.copy(), algorithm=ptt.bsdmm, e_rel=0,
               max_iter=12, step=lambda A, S: tnmf.step_pgm(A, S),
               step_stride=3)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm=pt.bsdmm, e_rel=0,
                    max_iter=12, step=lambda A, S: pt.nmf.step_pgm(A, S),
                    step_stride=3)
    _close_blocks(rt, rj)
    assert rt.state["stride_config"] == (3, 0, False)


@pytest.mark.parametrize("policy", [{"step_stride": 4}, {"step_adapt": True}])
def test_nmf_bsdmm_weighted_resume_and_jax_state(policy):
    """A weighted strided solve resumed in the port across a refresh
    boundary, bit for bit; and ten JAX sweeps continued in the port against
    twenty JAX sweeps."""
    Y, A0, S0, W = _problem()
    kw = dict(W=W, e_rel=0, **policy)
    full = t_nmf(Y, A0.copy(), S0.copy(), algorithm="bsdmm", max_iter=20,
                 **kw)
    for split in (4, 10):
        half = t_nmf(Y, A0.copy(), S0.copy(), algorithm="bsdmm",
                     max_iter=split, **kw)
        rest = t_nmf(Y, *half.x, algorithm="bsdmm", max_iter=20 - split,
                     state=half.state, **kw)
        assert rest.state["it"] == 20 and rest.iterations == 20 - split
        for a, b in zip(rest.x, full.x):
            assert torch.equal(a, b)
        assert rest.state["steps_state"][1:] == full.state["steps_state"][1:]
    jfull = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="bsdmm",
                       max_iter=20, **kw)
    jhalf = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="bsdmm",
                       max_iter=10, **kw)
    state = state_from_numpy(_numpy_state(jhalf.state), device="cpu")
    cont = t_nmf(Y, np.asarray(jhalf.x[0]), np.asarray(jhalf.x[1]),
                 algorithm="bsdmm", max_iter=10, state=state, **kw)
    assert cont.iterations == 10 and cont.state["it"] == 20
    _close_blocks(cont, jfull)
    assert cont.state["steps_state"][1] == tuple(
        np.asarray(jfull.state["steps_state"][1]))


def test_nmf_bsdmm_option_gates():
    Y, A0, S0, W = _problem()
    with pytest.raises(ValueError, match="step_adapt"):
        t_nmf(Y, A0, S0, algorithm="bsdmm", step_adapt=True, max_iter=2)
    with pytest.raises(ValueError, match="step_adapt"):
        t_nmf(Y, A0, S0, W=W, algorithm="bsdmm", step_adapt=True,
              step=lambda A, S: (0.1, 0.1), max_iter=2)
    with pytest.raises(ValueError, match="engine='cuda'"):
        t_nmf(Y, A0, S0, algorithm="bsdmm", engine="cuda", max_iter=2)
    strided = t_nmf(Y, A0.copy(), S0.copy(), W=W, algorithm="bsdmm",
                    step_stride=4, max_iter=2)
    with pytest.raises(ValueError, match="step-stride"):
        t_nmf(Y, *strided.x, W=W, algorithm="bsdmm", step_stride=5,
              max_iter=2, state=strided.state)
    with pytest.raises(ValueError, match="unknown algorithm"):
        t_nmf(Y, A0, S0, algorithm="sdmm", max_iter=2)


def test_nmf_bsdmm_callback():
    Y, A0, S0, W = _problem()
    hits = []
    r1 = t_nmf(Y, A0.copy(), S0.copy(), W=W, algorithm="bsdmm", e_rel=0,
               max_iter=12, step_stride=5,
               callback=lambda *X, it=None: hits.append(it))
    assert hits == list(range(12))
    r2 = t_nmf(Y, A0.copy(), S0.copy(), W=W, algorithm="bsdmm", e_rel=0,
               max_iter=12, step_stride=5)
    assert torch.equal(r1.x[1], r2.x[1])
