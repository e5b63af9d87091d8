"""The strided step refresh: grow_stride, StridedStepper and pgm's segmented
mode in the port against proxmin_tpu.

Tolerances and their reasons:
- grow_stride: equal integers (the same float32 drift, the same rule).
- trajectories, f64: rtol 1e-9. The same iteration in the same order; only
  the BLAS libraries' summation orders differ (a few ulps per iteration,
  grown by the nonconvex NMF iteration).
- resume in the port: bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu_torch as ptt
from proxmin_tpu_torch.interop import state_from_numpy

F64 = dict(rtol=1e-9, atol=0)
BUDGET = (1.0 - 0.9) / 2

# NumPy inputs go to the card unless the caller names a device; these tests
# run on the CPU
_pgm = functools.partial(ptt.pgm, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(seed=101, C=5, K=3, N=300):
    rng = np.random.default_rng(seed)
    Y = rng.random((C, K)) @ rng.random((K, N))
    return Y, rng.random((C, K)), rng.random((K, N))


def _numpy_state(state):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, state)


@pytest.mark.parametrize("stride,old,new,first", [
    (10, (1.0, 2.0), (1.01, 2.0), False),      # grow: 10 + 50
    (10, (1.0, 2.0), (1.001, 2.0), False),     # grow, capped at 100
    (10, (1.0, 2.0), (1.2, 2.0), False),       # halve
    (1, (1.0, 2.0), (1.5, 2.0), False),        # halve, floor 1
    (10, (1.0, 2.0), (1.0, 2.0), False),       # keep: no drift
    (10, (0.0, 0.0), (1.0, 2.0), True),        # first refresh: pinned
    (7, (np.array([1.0, 3.0]), 2.0), (np.array([1.02, 3.0]), 2.0), False),
])
def test_grow_stride_matches_jax(stride, old, new, first):
    want = pt.utils.grow_stride(
        jnp.int32(stride), tuple(jnp.asarray(o) for o in old),
        tuple(jnp.asarray(n) for n in new), BUDGET, 100, first=first)
    got = ptt.utils.grow_stride(
        stride, tuple(torch.as_tensor(o) for o in old),
        tuple(torch.as_tensor(n) for n in new), BUDGET, 100, first=first)
    assert isinstance(got, int)
    assert got == int(want)


def _nmf_pgm(lib, Y, A0, S0, step, max_iter, state=None, **kw):
    """``lib.pgm`` on the NMF problem with the library's own gradient."""
    Y_ = torch.from_numpy(Y) if lib is ptt else Y
    grad = functools.partial(lib.nmf.grad_likelihood, Y=Y_)
    run = _pgm if lib is ptt else lib.pgm
    return run([A0.copy(), S0.copy()], grad, step,
               prox=lib.operators.prox_plus, e_rel=0, max_iter=max_iter,
               state=state, **kw)


def _step_with_grads(lib):
    """A step callable that takes ``grads``: the JAX driver then refreshes
    inside the body (not segmented)."""
    def step(A, S, it=None, grads=None):
        return lib.nmf.step_pgm(A, S)
    return step


@pytest.mark.parametrize("adapt", [False, True])
@pytest.mark.parametrize("accelerated", [False, True])
@pytest.mark.parametrize("grads", [False, True])
def test_strided_pgm_trajectory_matches_jax(adapt, accelerated, grads):
    """StridedStepper(step_pgm) through pgm: segmented in the JAX driver
    (a grads-free inner step), per-iteration with a step that takes grads;
    the port's host loop is both. (FISTA drives A to 0 here and stops
    early, on the same iteration in both.)"""
    Y, A0, S0 = _problem()
    steppers = [
        lib.utils.StridedStepper(
            _step_with_grads(lib) if grads else lib.nmf.step_pgm, 2,
            stride=3, adapt=adapt)
        for lib in (pt, ptt)]
    assert steppers[0].segmentable == steppers[1].segmentable == (not grads)
    rj = _nmf_pgm(pt, Y, A0, S0, steppers[0], 40, accelerated=accelerated)
    rt = _nmf_pgm(ptt, Y, A0, S0, steppers[1], 40, accelerated=accelerated)
    assert rj.iterations == rt.iterations
    assert rj.status == rt.status
    assert accelerated or rt.iterations == 40
    for t, j in zip(rt.x, rj.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F64)
    sj, st = rj.state["stepper_state"], rt.state["stepper_state"]
    assert len(sj) == len(st)
    # the schedule (stride, next refresh) and the cached steps
    assert [int(v) for v in sj[2:]] == list(st[2:])
    for t, j in zip(st[1], sj[1]):
        np.testing.assert_allclose(float(t), float(j), **F64)


def test_stepper_hooks():
    """The segmented-mode hooks read the state as the JAX ones do."""
    Y, A0, S0 = _problem()
    X = (torch.from_numpy(A0), torch.from_numpy(S0))
    s = ptt.utils.StridedStepper(ptt.nmf.step_pgm, 2, stride=4, adapt=True)
    state = s.init_state(X, None)
    assert s.segment_end(state, 0) == 0 and s.state_stride(state) == 4
    steps, state = s.segment_refresh(state, X, 0)
    assert s.segment_end(state, 0) == 4 and s.state_stride(state) == 4
    assert s.state_steps(state) is steps
    want = ptt.nmf.step_pgm(*X)
    for got, w in zip(steps, want):
        assert float(got) == pytest.approx(0.9 * float(w), rel=1e-15)
    with pytest.raises(ValueError):
        ptt.utils.StridedStepper(ptt.nmf.step_pgm, 2).state_stride(())


@pytest.mark.parametrize("adapt", [False, True])
def test_strided_nmf_stops_on_the_xla_iteration(adapt):
    """A strided solve that converges stops on the same iteration."""
    Y, A0, S0 = _problem(seed=0)
    kw = dict(e_rel=1e-4, max_iter=3000, step_stride=5, step_adapt=adapt)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw)
    rt = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), device="cpu", **kw)
    assert rj.status == rt.status == "converged"
    assert rj.iterations == rt.iterations
    for t, j in zip(rt.x, rj.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F64)


@pytest.mark.parametrize("policy", [{"step_stride": 3},
                                    {"step_adapt": True},
                                    {"step_stride": 4, "step_adapt": True,
                                     "separable_prox": "auto"}])
def test_strided_adaprox_matches_jax(policy):
    """nmf(algorithm='adaprox') wraps step_adaprox in a StridedStepper on
    the torch engine, as on the JAX package's xla engine."""
    Y, A0, S0 = _problem()
    kw = dict(algorithm="adaprox", e_rel=0, max_iter=25, **policy)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw)
    rt = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), device="cpu", **kw)
    assert rj.iterations == rt.iterations == 25
    for t, j in zip(rt.x, rj.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F64)
    assert [int(v) for v in rj.state["stepper_state"][2:]] == list(
        rt.state["stepper_state"][2:])


@pytest.mark.parametrize("split", [15, 10])
@pytest.mark.parametrize("adapt", [False, True])
def test_resume_mid_segment_and_on_a_boundary(split, adapt):
    """Stride 10: a stop at 15 lands mid-segment, a stop at 10 exactly on a
    refresh boundary (the carried clock says "due now"). A JAX solve stopped
    there and continued in the port matches 30 JAX iterations; in the port
    the resumed solve equals the straight one bit for bit."""
    Y, A0, S0 = _problem()
    kw = dict(e_rel=0, step_stride=10, step_adapt=adapt)
    full = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=30, **kw)
    half = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=split, **kw)
    state = state_from_numpy(_numpy_state(half.state), device="cpu")
    if not adapt:
        # the next refresh: at 20 after a stop at 15, due now after 10
        assert state["stepper_state"][-1] == {15: 20, 10: 10}[split]
    rest = ptt.nmf.nmf(Y, np.asarray(half.x[0]), np.asarray(half.x[1]),
                       max_iter=30 - split, state=state, device="cpu", **kw)
    assert rest.iterations == 30 - split and rest.state["it"] == 30
    for t, j in zip(rest.x, full.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **F64)

    p_full = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=30,
                         device="cpu", **kw)
    p_half = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=split,
                         device="cpu", **kw)
    p_rest = ptt.nmf.nmf(Y, *p_half.x, max_iter=30 - split,
                         state=p_half.state, **kw)
    for a, b in zip(p_rest.x, p_full.x):
        assert torch.equal(a, b)
    assert p_rest.state["stepper_state"][2:] == p_full.state[
        "stepper_state"][2:]


def test_unweighted_stride10_overshoot_is_copied_from_jax():
    """Unweighted step_stride=10 from a random start (chip_smoke.py's
    make_problem at C=5, K=7, N=10_000, seed 101): a frozen step overshoots
    in both packages alike, the prox zeroes both factors, and both solves
    stop at the same iteration at that exact fixed point. The port copies
    the reference here (ROADMAP Queue 3)."""
    C, K, N = 5, 7, 10_000
    rng = np.random.default_rng(101)
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true
         + 0.02 * rng.standard_normal((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    kw = dict(e_rel=0, max_iter=60, step_stride=10)
    jr = pt.nmf.nmf(Y, A0.copy(), S0.copy(), engine="xla", **kw)
    tr = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), engine="torch", device="cpu",
                     **kw)
    assert tr.iterations == jr.iterations < 60
    for j, t in zip(jr.x, tr.x):
        assert not np.asarray(j).any() and not bool(t.any())


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_simplex_stride10_nan_is_copied_from_jax(weighted):
    """The simplex on S (prox_unity_plus, axis 0) with step_stride=10 from
    a random start at C=64, K=16, N=10_000 (seed 101): a frozen step
    overshoots, whole columns of S fall to zero, and the projection divides
    0 by 0 there. Both packages stop at the same iteration with NaN in the
    same columns of S and none in A: the port copies the reference here
    (ROADMAP Queue 3)."""
    C, K, N = 64, 16, 10_000
    rng = np.random.default_rng(101)
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true
         + 0.02 * rng.standard_normal((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    W = ((0.5 + rng.random((C, N))).astype(np.float32) if weighted
         else None)
    kw = dict(e_rel=0, max_iter=30, step_stride=10)
    jr = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, engine="xla",
                    prox_A=pt.operators.prox_plus,
                    prox_S=functools.partial(pt.operators.prox_unity_plus,
                                             axis=0), **kw)
    tr = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, engine="torch",
                     device="cpu", prox_A=ptt.operators.prox_plus,
                     prox_S=functools.partial(ptt.operators.prox_unity_plus,
                                              axis=0), **kw)
    assert tr.iterations == jr.iterations == 12
    j_nan = np.isnan(np.asarray(jr.x[1])).any(axis=0)
    t_nan = torch.isnan(tr.x[1]).any(dim=0).numpy()
    assert j_nan.any() and np.array_equal(t_nan, j_nan)
    assert not np.isnan(np.asarray(jr.x[0])).any()
    assert not bool(torch.isnan(tr.x[0]).any())
