"""K3's plain version against the JAX fused_nmf_grad.

The JAX kernel runs as tests/test_pallas_ops.py runs it on the CPU, through
the Pallas interpreter, on the same seeded numpy inputs. Tolerances are
that file's (:83-89): rtol 2e-5 on gA and the Gram, rtol 2e-5 with atol
1e-5 on gS, rtol 1e-4 on the loss. Both sides compute in float32 and sum
the pixel-axis reductions in different orders.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from proxmin_tpu.ops import fused_nmf_grad as jax_grad
import proxmin_tpu_torch.ops as tops
from proxmin_tpu_torch import nmf as tnmf
from proxmin_tpu_torch.ops import nmf_kernels as kk


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(rng, C, K, N, weighted, dtype=np.float32):
    A = rng.random((C, K)).astype(dtype)
    S = rng.random((K, N)).astype(dtype)
    Y = rng.random((C, N)).astype(dtype)
    W = (0.5 + rng.random((C, N))).astype(dtype) if weighted else None
    return A, S, Y, W


def _assert_matches_jax(got, want):
    gA, gS, SSt, loss = (np.asarray(w) for w in want)
    assert all(t.dtype == torch.float32 for t in got)
    assert got[3].shape == ()
    np.testing.assert_allclose(got[0].numpy(), gA, rtol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), gS, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), SSt, rtol=2e-5)
    np.testing.assert_allclose(float(got[3]), float(loss), rtol=1e-4)


@pytest.mark.parametrize("C,K,N,tile_n", [(5, 7, 1000, 256),
                                          (8, 8, 512, 128)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_version_matches_jax_kernel(rng, C, K, N, tile_n, weighted,
                                          dtype):
    """float64 inputs are cast to float32 on both sides."""
    A, S, Y, W = _problem(rng, C, K, N, weighted, dtype)
    want = jax_grad(A, S, Y, W=W, tile_n=tile_n)
    got = tops.fused_nmf_grad(*(None if a is None else torch.from_numpy(a)
                                for a in (A, S, Y)),
                              W=None if W is None else torch.from_numpy(W),
                              tile_n=tile_n)
    _assert_matches_jax(got, want)


def test_plain_version_is_the_likelihood_gradient(rng):
    """gA and gS are nmf.grad_likelihood's, the loss its log_likelihood."""
    A, S, Y, W = (torch.from_numpy(a) for a in _problem(rng, 4, 3, 300,
                                                        True))
    gA, gS, SSt, loss = kk.fused_nmf_grad_reference(A, S, Y, W=W)
    for g, r in zip((gA, gS), tnmf.grad_likelihood(A, S, Y=Y, W=W)):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(SSt, S @ S.T)
    torch.testing.assert_close(loss, tnmf.log_likelihood(A, S, Y=Y, W=W),
                               rtol=1e-6, atol=0)


def test_cpu_tensors_take_the_plain_version(rng):
    A, S, Y, _ = (torch.from_numpy(a) if a is not None else None
                  for a in _problem(rng, 5, 7, 300, False))
    before = kk.fused_nmf_grad.launches
    got = kk.fused_nmf_grad(A, S, Y)
    ref = kk.fused_nmf_grad_reference(A, S, Y)
    assert kk.fused_nmf_grad.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("shapes", [
    ((5, 7), (6, 100), (5, 100), None),
    ((5, 7), (7, 100), (5, 99), None),
    ((5, 7), (7, 100), (5, 100), (1,)),
    ((5, 7), (7, 100), (5, 100), ()),
    ((5, 7, 1), (7, 100), (5, 100), None),
])
def test_shape_mismatch_raises(shapes):
    """W is None or (C, N), as in JAX: a scalar or broadcast W is refused."""
    A, S, Y, W = (None if s is None else torch.ones(s) for s in shapes)
    with pytest.raises(ValueError):
        kk.fused_nmf_grad(A, S, Y, W=W)


def test_wrapper_refuses_other_devices():
    A = torch.empty((5, 7), device="meta")
    S = torch.empty((7, 10), device="meta")
    Y = torch.empty((5, 10), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kk.fused_nmf_grad(A, S, Y)
