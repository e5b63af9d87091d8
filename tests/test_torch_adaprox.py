"""The port's adaprox driver against proxmin_tpu.adaprox.

A small NMF problem (the same numpy inputs, gradient and step heuristic in
both packages), float64. Tolerance: rtol 1e-9 on the iterates and moments
(atol 1e-13 for entries that the prox drives to about zero): both run the
same operations in the same order and differ only in how the BLAS libraries
sum the pixel-axis products, a few ulps per iteration grown by the
nonconvex iteration over 30 steps. Iteration and sub-iteration counts must
be equal. bfloat16 moments: the same float64 values round to the same
bfloat16 ones, so the same tolerance holds there too.
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
from proxmin_tpu_torch.solvers.adaprox import SCHEMES

F64 = dict(rtol=1e-9, atol=1e-13)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(seed=101, C=5, K=3, N=400):
    rng = np.random.default_rng(seed)
    Y = (rng.random((C, K)) @ rng.random((K, N))
         + 0.01 * rng.standard_normal((C, N)))
    return Y, rng.random((C, K)), rng.random((K, N))


def _solve(lib, Y, A0, S0, prox=None, **kw):
    """``lib.adaprox`` on the NMF problem, with the library's own
    gradient and ``step_adaprox``."""
    Y_ = torch.from_numpy(Y) if lib is ptt else Y
    grad = functools.partial(lib.nmf.grad_likelihood, Y=Y_)
    if prox is None:
        prox = lib.operators.prox_plus
    if lib is ptt:
        # NumPy inputs go to the card unless the caller names a device
        kw = dict(kw, device="cpu")
    return lib.adaprox([A0.copy(), S0.copy()], grad, lib.nmf.step_adaprox,
                       prox=prox, **kw)


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _close(got, want, tol=F64):
    for t, j in zip(got, want):
        np.testing.assert_allclose(_as_np(t), _as_np(j), **tol)


def _same_run(rt, rj, tol=F64):
    assert rt.iterations == rj.iterations
    assert rt.sub_iterations == rj.sub_iterations
    assert rt.status == rj.status
    _close(rt.x, rj.x, tol)
    for name in ("M", "V", "Vhat"):
        _close(getattr(rt, name), getattr(rj, name), tol)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_schemes_match_jax(scheme):
    """Each Φ/Ψ scheme with the closed-form separable prox, 30 fixed
    iterations."""
    Y, A0, S0 = _problem()
    kw = dict(scheme=scheme, e_rel=0, max_iter=30, separable_prox=True)
    rj = _solve(pt, Y, A0, S0, **kw)
    rt = _solve(ptt, Y, A0, S0, **kw)
    assert rt.iterations == 30
    _same_run(rt, rj)


@pytest.mark.parametrize("scheme", ["adam", "amsgrad", "padam"])
def test_prox_sub_iterations_match_jax(scheme):
    """separable_prox=False runs the reference's sub-iterations (one host
    read each); their counts match the JAX nested loop's."""
    Y, A0, S0 = _problem()
    kw = dict(scheme=scheme, e_rel=1e-3, max_iter=30)
    rj = _solve(pt, Y, A0, S0, **kw)
    rt = _solve(ptt, Y, A0, S0, **kw)
    assert sum(rt.sub_iterations) > rt.iterations  # the loop did iterate
    _same_run(rt, rj)


def test_separable_auto_reads_the_markers():
    """'auto' asks each operator's separable_when over its bound keywords,
    with the JAX package's answers; the solve then matches JAX's."""
    cases = [
        ("prox_plus", {}), ("prox_id", {}), ("prox_zero", {}),
        ("prox_min", {}), ("prox_min", {"thresh": 0.1}),
        ("prox_min", {"thresh": 0.1, "type": "absolute"}),
        ("prox_max", {"thresh": 0.2}), ("prox_soft", {"thresh": 0.01}),
        ("prox_soft", {"thresh": 0.01, "type": "absolute"}),
        ("prox_soft_plus", {"thresh": 0.01}), ("prox_hard", {"thresh": 0.1}),
        ("prox_unity", {}),
    ]
    from proxmin_tpu.solvers.common import separable_blocks as sep_j
    from proxmin_tpu_torch.solvers.common import separable_blocks as sep_t
    for name, kw in cases:
        pj = functools.partial(getattr(pt.operators, name), **kw)
        pt_ = functools.partial(getattr(ptt.operators, name), **kw)
        assert sep_t((pt_, None), (True, False), "auto") == sep_j(
            (pj, None), (True, False), "auto"), (name, kw)
    with pytest.raises(ValueError, match="separable_prox"):
        sep_t((pt_,), (True,), "Auto")

    Y, A0, S0 = _problem()
    kw = dict(e_rel=0, max_iter=30, separable_prox="auto")
    rj = _solve(pt, Y, A0, S0, prox=[
        functools.partial(pt.operators.prox_soft_plus, thresh=0.01),
        pt.operators.prox_plus], **kw)
    rt = _solve(ptt, Y, A0, S0, prox=[
        functools.partial(ptt.operators.prox_soft_plus, thresh=0.01),
        ptt.operators.prox_plus], **kw)
    _same_run(rt, rj)


def test_b1_schedule_matches_jax():
    Y, A0, S0 = _problem()
    b1 = np.linspace(0.9, 0.5, 25)
    kw = dict(e_rel=0, max_iter=25, separable_prox=True)
    rj = _solve(pt, Y, A0, S0, b1=b1, scheme="adamx", **kw)
    rt = _solve(ptt, Y, A0, S0, b1=b1, scheme="adamx", **kw)
    _same_run(rt, rj)
    with pytest.raises(ValueError, match="b1"):
        _solve(ptt, Y, A0, S0, b1=b1[:-1], **kw)


def test_moment_warm_start_matches_jax():
    """M/V/Vhat from a previous JAX solve warm-start both packages (the
    bias-correction clock restarts)."""
    Y, A0, S0 = _problem()
    kw = dict(scheme="amsgrad", e_rel=0, max_iter=15, separable_prox=True)
    first = _solve(pt, Y, A0, S0, **kw)
    A1, S1 = (np.asarray(x) for x in first.x)
    moments = {k: tuple(np.asarray(m) for m in getattr(first, k))
               for k in ("M", "V", "Vhat")}
    rj = _solve(pt, Y, A1, S1, **moments, **kw)
    rt = _solve(ptt, Y, A1, S1, **moments, **kw)
    _same_run(rt, rj)


@pytest.mark.parametrize("mdt", ["bfloat16", torch.bfloat16])
def test_bfloat16_moments_match_jax(mdt):
    Y, A0, S0 = _problem()
    kw = dict(e_rel=0, max_iter=30, separable_prox=True)
    rj = _solve(pt, Y, A0, S0, moment_dtype=jnp.bfloat16, **kw)
    rt = _solve(ptt, Y, A0, S0, moment_dtype=mdt, **kw)
    assert all(m.dtype == torch.bfloat16 for m in rt.M + rt.V + rt.Vhat)
    assert all(x.dtype == torch.float64 for x in rt.x)
    _same_run(rt, rj)


def test_stopping_iteration_matches_jax():
    """e_rel > 0: both stop on the same iteration, converged."""
    Y, A0, S0 = _problem(seed=0)
    kw = dict(e_rel=1e-4, max_iter=3000, separable_prox=True)
    rj = _solve(pt, Y, A0, S0, **kw)
    rt = _solve(ptt, Y, A0, S0, **kw)
    assert rt.status == rj.status == "converged"
    assert rt.iterations < 3000
    _same_run(rt, rj)


def test_no_convergence_check_runs_to_max_iter():
    Y, A0, S0 = _problem()
    kw = dict(e_rel=1.0, max_iter=12, check_convergence=False,
              separable_prox=True)
    rj = _solve(pt, Y, A0, S0, **kw)
    rt = _solve(ptt, Y, A0, S0, **kw)
    assert rt.converged == rj.converged == (None, None)
    _same_run(rt, rj)


def test_resume_is_bit_exact_and_unpacks_like_the_reference():
    """15 + 15 iterations through state= equal 30 straight, bit for bit
    (moments and the global bias-correction clock carry over)."""
    Y, A0, S0 = _problem()
    kw = dict(scheme="nadam", e_rel=0, separable_prox=True)
    full = _solve(ptt, Y, A0, S0, max_iter=30, **kw)
    half = _solve(ptt, Y, A0, S0, max_iter=15, **kw)
    rest = _solve(ptt, Y, *(x.numpy() for x in half.x), max_iter=15,
                  state=half.state, **kw)
    assert rest.state["it"] == 30
    for a, b in zip(rest.x + rest.M + rest.V, full.x + full.M + full.V):
        assert torch.equal(a, b)
    converged, M, V, Vhat = rest  # the reference's return shape
    assert converged == (False, False) and M is rest.M
    with pytest.raises(ValueError, match="mutually exclusive"):
        _solve(ptt, Y, A0, S0, max_iter=3, state=half.state, M=half.M, **kw)


def test_continues_a_jax_driver_state():
    """A JAX adaprox solve stopped after 15 iterations and continued in the
    port matches JAX's 30 straight iterations."""
    Y, A0, S0 = _problem()
    kw = dict(scheme="radam", e_rel=0, separable_prox=True)
    full = _solve(pt, Y, A0, S0, max_iter=30, **kw)
    half = _solve(pt, Y, A0, S0, max_iter=15, **kw)
    st = state_from_numpy(jax.tree_util.tree_map(np.asarray, half.state),
                          device="cpu")
    rest = _solve(ptt, Y, *(np.asarray(x) for x in half.x), max_iter=15,
                  state=st, **kw)
    assert rest.state["it"] == 30
    _close(rest.x, full.x)


@pytest.mark.parametrize("kw", [
    {"callback": True},
    {"trace": True},
    {"f": True},
])
def test_options_not_yet_ported_raise(kw):
    """These options raised ``NotImplementedError`` until they were ported;
    the test keeps its name and now holds each against the JAX solver
    (tests/test_torch_driver_options.py has the full set)."""
    Y, A0, S0 = _problem()
    kj, kt = dict(kw), dict(kw)
    seen = {"jax": [], "torch": []}
    if "callback" in kw:
        kj["callback"] = lambda *x, it=None: seen["jax"].append(it)
        kt["callback"] = lambda *x, it=None: seen["torch"].append(it)
    if "f" in kw:
        # with f and a gradient both given, the gradient is used
        kj["f"] = functools.partial(pt.nmf.log_likelihood, Y=jnp.asarray(Y))
        kt["f"] = functools.partial(ptt.nmf.log_likelihood,
                                    Y=torch.from_numpy(Y))
    rj = _solve(pt, Y, A0, S0, max_iter=12, e_rel=0, **kj)
    rt = _solve(ptt, Y, A0, S0, max_iter=12, e_rel=0, **kt)
    assert rj.iterations == rt.iterations == 12
    assert seen["torch"] == seen["jax"]
    _close(rt.x, rj.x)
    if "trace" in kw:
        assert rt.history.shape == (12, 2)
        np.testing.assert_allclose(rt.history, rj.history, rtol=1e-9)
    else:
        assert rt.history is None
