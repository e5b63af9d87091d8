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
