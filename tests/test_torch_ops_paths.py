"""The ops entry point driven the way its users drive it, against the JAX
package driven the same way.

Three paths at C=5, K=7, N=600, 20 iterations, e_rel=0, data from one seed:
- sum-to-one abundances: nmf(prox_S=AlternatingProjections(
  [prox_unity_pallas, prox_plus_pallas])), float64;
- sparse sources: nmf(prox_S=AlternatingProjections(
  [prox_plus_pallas, partial(prox_soft_pallas, thresh=0.5)])), float64;
- K3 as the gradient: pgm([A, S], grad=fused_nmf_grad's (gA, gS),
  step=step_pgm, prox=[prox_plus] * 2), float32.
The port runs them with proxmin_tpu_torch.ops (the plain versions, on CPU
tensors), JAX with proxmin_tpu.ops (the Pallas interpreter). Tolerances
are tests/test_torch_nmf.py's: rtol 1e-9 in float64 (only the libraries'
summation orders differ, grown over 20 iterations), rtol 1e-3 with atol
1e-5 in float32 (float32 sums over the pixels in other orders)."""

import functools

import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu.ops as jops
import proxmin_tpu_torch as ptt
import proxmin_tpu_torch.ops as tops

F64 = dict(rtol=1e-9, atol=0)
F32 = dict(rtol=1e-3, atol=1e-5)
ITERS = 20

# NumPy inputs go to the card unless the caller names a device; these tests
# run on the CPU
_nmf = functools.partial(ptt.nmf.nmf, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(dtype, seed=101, C=5, K=7, N=600):
    rng = np.random.default_rng(seed)
    Y = rng.random((C, K)) @ rng.random((K, N))
    Y = Y + 0.02 * rng.standard_normal((C, N))
    return (Y.astype(dtype), rng.random((C, K)).astype(dtype),
            rng.random((K, N)).astype(dtype))


def _close(port_x, jax_x, tol):
    for t, j in zip(port_x, jax_x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def _prox_paths():
    jops_ap = pt.operators.AlternatingProjections
    return {
        "sum-to-one": (
            jops_ap([jops.prox_unity_pallas, jops.prox_plus_pallas]),
            ptt.AlternatingProjections([tops.prox_unity_pallas,
                                        tops.prox_plus_pallas]),
            ptt.prox_unity_plus),
        "sparse": (
            jops_ap([jops.prox_plus_pallas,
                     functools.partial(jops.prox_soft_pallas, thresh=0.5)]),
            ptt.AlternatingProjections(
                [tops.prox_plus_pallas,
                 functools.partial(tops.prox_soft_pallas, thresh=0.5)]),
            functools.partial(ptt.prox_soft_plus, thresh=0.5)),
    }


@pytest.mark.parametrize("path", ["sum-to-one", "sparse"])
def test_prox_path_matches_jax(path):
    j_prox, t_prox, t_plain = _prox_paths()[path]
    Y, A0, S0 = _problem(np.float64)
    kw = dict(e_rel=0, max_iter=ITERS)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=j_prox, engine="xla",
                    **kw)
    rt = _nmf(Y, A0.copy(), S0.copy(), prox_S=t_prox, **kw)
    assert rj.iterations == rt.iterations == ITERS
    assert rt.x[1].dtype == torch.float64
    _close(rt.x, rj.x, F64)
    # the plain-operator twin takes the same iterations bit for bit
    rp = _nmf(Y, A0.copy(), S0.copy(), prox_S=t_plain, **kw)
    for a, b in zip(rt.x, rp.x):
        assert torch.equal(a, b)
    S = rt.x[1]
    if path == "sum-to-one":
        torch.testing.assert_close(S.sum(0), torch.ones_like(S[0]),
                                   rtol=1e-12, atol=1e-12)
        assert bool((S >= 0).all())
    else:
        zero = float((S == 0).double().mean())
        assert 0.0 < zero < 1.0


def test_k3_gradient_path_matches_jax():
    Y, A0, S0 = _problem(np.float32)
    rj = pt.algorithms.pgm(
        [A0.copy(), S0.copy()],
        lambda A, S: tuple(jops.fused_nmf_grad(A, S, Y, tile_n=256)[:2]),
        pt.nmf.step_pgm, prox=[pt.operators.prox_plus] * 2, e_rel=0,
        max_iter=ITERS)
    Yt = torch.from_numpy(Y)
    before = tops.fused_nmf_grad.launches
    rt = ptt.algorithms.pgm(
        [torch.from_numpy(A0), torch.from_numpy(S0)],
        lambda A, S: tops.fused_nmf_grad(A, S, Yt)[:2], ptt.nmf.step_pgm,
        prox=[ptt.prox_plus] * 2, e_rel=0, max_iter=ITERS)
    assert tops.fused_nmf_grad.launches == before  # CPU: the plain version
    assert rj.iterations == rt.iterations == ITERS
    assert rt.x[1].dtype == torch.float32
    _close(rt.x, rj.x, F32)
    # the same solve through nmf(engine="torch"), whose gradient is
    # grad_likelihood
    rn = _nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=ITERS)
    for a, b in zip(rt.x, rn.x):
        torch.testing.assert_close(a, b, **F32)
