"""The port's elementwise prox operators against proxmin_tpu.operators.

Same f64 inputs (numpy, seeded) through both. Tolerance: bitwise, since each
operator is one or two IEEE operations per element that both frameworks
round identically (max, min, abs, sign, where, one division); the column
sums of prox_unity are allowed 1e-15 relative, as the two libraries may
reduce in another order."""

import functools

import numpy as np
import pytest
import torch

import proxmin_tpu.operators as jop
import proxmin_tpu_torch.operators as top


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


CASES = [
    ("prox_id", {}),
    ("prox_zero", {}),
    ("prox_plus", {}),
    ("prox_min", {"thresh": 0.3}),
    ("prox_min", {"thresh": 0.3, "type": "absolute"}),
    ("prox_max", {"thresh": 0.3}),
    ("prox_max", {"thresh": -0.2, "type": "absolute"}),
    ("prox_hard", {"thresh": 0.4}),
    ("prox_hard", {"thresh": 0.4, "type": "absolute"}),
    ("prox_hard_plus", {"thresh": 0.4}),
    ("prox_soft", {"thresh": 0.4}),
    ("prox_soft", {"thresh": 0.4, "type": "absolute"}),
    ("prox_soft_plus", {"thresh": 0.4}),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{sorted(k.items())}" for n, k in CASES])
def test_elementwise_prox_bitwise(rng, name, kw):
    X = rng.normal(size=(6, 50))
    step = 0.7
    want = np.asarray(getattr(jop, name)(X, step, **kw))
    got = getattr(top, name)(torch.from_numpy(X.copy()), step, **kw)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["prox_unity", "prox_unity_plus"])
@pytest.mark.parametrize("axis", [0, 1])
def test_unity_prox(rng, name, axis):
    X = 0.1 + rng.random((6, 50))
    if name == "prox_unity_plus":
        X = X - 0.3
    want = np.asarray(getattr(jop, name)(X, 0.5, axis=axis))
    got = getattr(top, name)(torch.from_numpy(X.copy()), 0.5, axis=axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)


def test_tensor_step_and_partial(rng):
    """A 0-d tensor step (what the solvers pass) and a partial-bound prox
    give the same values as a float step."""
    X = torch.from_numpy(rng.normal(size=(4, 30)))
    p = functools.partial(top.prox_soft, thresh=0.25)
    np.testing.assert_array_equal(
        p(X, torch.tensor(0.5, dtype=torch.float64)).numpy(),
        np.asarray(jop.prox_soft(X.numpy(), 0.5, thresh=0.25)))


_THRESHOLD_PROXES = ("prox_soft", "prox_soft_plus", "prox_min", "prox_max")
_MIXED_STEPS = {
    "python float": (lambda: 0.37, lambda: 0.37),
    "0-d float64 tensor": (lambda: torch.tensor(0.37, dtype=torch.float64),
                           lambda: np.asarray(0.37, dtype=np.float64)),
    "numpy float64": (lambda: np.float64(0.37), lambda: np.float64(0.37)),
}


@pytest.mark.parametrize("name", _THRESHOLD_PROXES)
@pytest.mark.parametrize("step", list(_MIXED_STEPS))
def test_threshold_promotes_as_in_jax(rng, name, step):
    """A float32 X with a float64 step (a 0-d tensor on the port's side, a
    typed float64 array on JAX's, or a NumPy float64 scalar on both) gives
    a float64 result, as JAX's promotion does; a Python float step is
    weakly typed and keeps float32. Values in float64, rtol 1e-12."""
    X = rng.normal(size=(3, 5)).astype(np.float32)
    t_step, j_step = (f() for f in _MIXED_STEPS[step])
    want = np.asarray(getattr(jop, name)(X, j_step, thresh=0.3))
    got = getattr(top, name)(torch.from_numpy(X.copy()), t_step, thresh=0.3)
    want_dtype = np.float32 if step == "python float" else np.float64
    assert want.dtype == want_dtype
    assert got.dtype == getattr(torch, want.dtype.name)
    np.testing.assert_allclose(got.double().numpy(), want.astype(np.float64),
                               rtol=1e-12, atol=0)


def test_nan_propagates_through_prox_plus():
    X = torch.tensor([float("nan"), -1.0, 2.0], dtype=torch.float64)
    got = top.prox_plus(X, 1.0)
    assert torch.isnan(got[0]) and got[1] == 0 and got[2] == 2


def test_get_thresh_convention():
    assert top.get_thresh(0.5, 0.4, "relative") == jop.get_thresh(0.5, 0.4,
                                                                   "relative")
    assert top.get_thresh(0.5, 0.4, "absolute") == 0.4
    with pytest.raises(ValueError, match="relative"):
        top.get_thresh(0.5, 0.4, "Relative")


# prox_components, AlternatingProjections, prox_max_entropy and the Lambert
# W function, in float64. Tolerance: bitwise where the operators are the
# elementwise ones above; rtol 1e-10 where the Lambert W iteration runs (the
# JAX package's own bound against scipy), since the two frameworks' log and
# exp may differ in the last ulp.
W_TOL = dict(rtol=1e-10, atol=0)


@pytest.mark.parametrize("axis", [0, 1])
def test_prox_components_per_slice(rng, axis):
    X = rng.normal(size=(3, 4))
    soft = functools.partial(jop.prox_soft, thresh=0.2)
    t_soft = functools.partial(top.prox_soft, thresh=0.2)
    K = X.shape[axis]
    j_list = [jop.prox_plus, soft, None, jop.prox_zero][:K]
    t_list = [top.prox_plus, t_soft, None, top.prox_zero][:K]
    want = np.asarray(jop.prox_components(X, 0.5, prox=j_list, axis=axis))
    got = top.prox_components(torch.from_numpy(X), 0.5, prox=t_list,
                              axis=axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prox_components_single_prox_and_none(rng):
    X = rng.normal(size=(3, 4))
    for jp, tp in ((jop.prox_plus, top.prox_plus), (None, None)):
        want = np.asarray(jop.prox_components(X, 0.5, prox=jp, axis=1))
        got = top.prox_components(torch.from_numpy(X), 0.5, prox=tp, axis=1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_prox_components_refuses_what_jax_refuses(rng):
    X = torch.from_numpy(rng.normal(size=(3, 4)))
    with pytest.raises(ValueError, match="need 3 prox operators"):
        top.prox_components(X, 0.5, prox=[top.prox_plus] * 2, axis=0)
    with pytest.raises(NotImplementedError, match="axis 0 or 1"):
        top.prox_components(X[None], 0.5, prox=top.prox_plus, axis=2)


@pytest.mark.parametrize("repeat", [1, 3])
def test_alternating_projections_order_and_repeat(rng, repeat):
    """The list applies in reverse: [unity, plus] is prox_unity_plus."""
    X = rng.normal(size=(5, 40)) + 0.5
    jp = jop.AlternatingProjections(
        [jop.prox_unity, functools.partial(jop.prox_soft, thresh=0.1)],
        repeat=repeat)
    tp = top.AlternatingProjections(
        [top.prox_unity, functools.partial(top.prox_soft, thresh=0.1)],
        repeat=repeat)
    got = tp(torch.from_numpy(X), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jp(X, 0.5)),
                               rtol=1e-15, atol=0)
    pair = top.AlternatingProjections([top.prox_unity, top.prox_plus])
    Xt = torch.from_numpy(X)
    assert torch.equal(pair(Xt, 0.5), top.prox_unity_plus(Xt, 0.5))
    assert torch.equal(top.AlternatingProjections()(Xt, 0.5), Xt)


def test_alternating_projections_find_sees_through_partial():
    ops = [top.prox_plus, functools.partial(top.prox_soft, thresh=0.2),
           top.prox_unity]
    jops_ = [jop.prox_plus, functools.partial(jop.prox_soft, thresh=0.2),
             jop.prox_unity]
    tp, jp = top.AlternatingProjections(ops), jop.AlternatingProjections(jops_)
    for t_cls, j_cls in ((top.prox_plus, jop.prox_plus),
                         (top.prox_soft, jop.prox_soft),
                         (top.prox_unity, jop.prox_unity),
                         (top.prox_hard, jop.prox_hard)):
        assert tp.find(t_cls) == jp.find(j_cls)
    assert tp.find(top.prox_soft) == 1 and tp.find(top.prox_hard) == -1


@pytest.mark.parametrize("kw", [{}, {"gamma": 0.3}, {"gamma": 2.0},
                                {"gamma": 0.5, "type": "absolute"}])
def test_prox_max_entropy_matches_jax(rng, kw):
    X = 3.0 * rng.normal(size=(6, 50))
    X[0, :5] = [0.0, 1e-300, 50.0, 700.0, -2.0]
    want = np.asarray(jop.prox_max_entropy(X, 0.7, **kw))
    got = top.prox_max_entropy(torch.from_numpy(X), 0.7, **kw)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **W_TOL)
    # a 0-d tensor step, as the solvers pass it
    got_t = top.prox_max_entropy(torch.from_numpy(X),
                                 torch.tensor(0.7, dtype=torch.float64), **kw)
    np.testing.assert_allclose(got_t.numpy(), want, **W_TOL)


def test_prox_max_entropy_separable_marker():
    f = top.prox_max_entropy.separable_when
    assert f({}) and f({"gamma": 0.3}) and not f({"type": "absolute"})
    for kw in ({}, {"type": "absolute"}):
        assert f(kw) == jop.prox_max_entropy.separable_when(kw)


def test_lambertw_exp_matches_jax():
    from proxmin_tpu import special as jsp
    from proxmin_tpu_torch import special as tsp

    t = np.concatenate([np.linspace(-700.0, 40.0, 741),
                        [1e3, 1e5, 1e10, 1e300]])
    want = np.asarray(jsp.lambertw_exp(t))
    got = tsp.lambertw_exp(torch.from_numpy(t))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **W_TOL)
    # it solves w + log(w) = t
    w = got.numpy()[(t > -300) & (t < 1e10)]
    tt = t[(t > -300) & (t < 1e10)]
    np.testing.assert_allclose(w + np.log(w), tt, rtol=1e-12, atol=1e-12)


def test_lambertw_matches_jax():
    from proxmin_tpu import special as jsp
    from proxmin_tpu_torch import special as tsp

    z = np.array([0.0, 1e-300, 1e-5, 0.5, 1.0, np.e, 10.0, 1e5, 1e300])
    want = np.asarray(jsp.lambertw(z))
    got = tsp.lambertw(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, **W_TOL)
    assert got[0] == 0 and abs(float(got[4]) - 0.5671432904097838) < 1e-15
    # integer input computes in float32, as JAX's result_type does
    assert tsp.lambertw(torch.tensor([0, 1])).dtype == torch.float32
