"""K1 and K2 on the card against their plain versions, and the cuda
engines on the card.

Needs an NVIDIA GPU and nvcc; every test skips elsewhere. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: rtol 2e-4, atol 1e-5 elementwise (|S' - S|^2 rtol 1e-3), as the
CPU tests hold the plain versions to the JAX kernels: both sides are float32
and sum the pixel-axis reductions in different orders. bfloat16 moment
stores: within one bfloat16 ulp (a one-ulp float32 difference in the EMA may
flip one rounding), plus atol 1e-5 where the EMA cancels to near zero.
"""

import numpy as np
import pytest
import torch

from proxmin_tpu_torch import nmf as tnmf
from proxmin_tpu_torch import operators as top
from proxmin_tpu_torch.ops import nmf_kernels as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the K1 kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _problem(dev, C, K, N, weighted=False, seed=101):
    rng = np.random.default_rng(seed)
    arrs = [rng.random((C, K)), rng.random((K, N)), rng.random((C, N)),
            0.5 + rng.random((C, N)) if weighted else None]
    return [None if a is None else
            torch.tensor(a, dtype=torch.float32, device=dev) for a in arrs]


def _assert_step_close(got, ref):
    for i, (g, r) in enumerate(zip(got, ref)):
        rtol = 1e-3 if i == 4 else 2e-4
        torch.testing.assert_close(g, r, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("C,K,N", [(5, 7, 1000), (8, 4, 4133), (16, 8, 300),
                                   (1, 1, 5), (3, 2, 10000)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("prox", ["plus", "id"])
@pytest.mark.parametrize("tile_n", [128, k1.DEFAULT_TILE_N])
def test_kernel_matches_plain_version(dev, C, K, N, weighted, prox, tile_n):
    A, S, Y, W = _problem(dev, C, K, N, weighted)
    prox_S = None if prox == "plus" else top.prox_id
    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    got = k1.fused_nmf_pgm_step(A, S, Y, sS, W=W, prox_S=prox_S,
                                tile_n=tile_n)
    ref = k1.fused_nmf_pgm_step_reference(A, S, Y, sS, W=W, prox_S=prox_S)
    torch.cuda.synchronize()
    _assert_step_close(got, ref)


def test_kernel_is_deterministic_and_counted(dev):
    A, S, Y, _ = _problem(dev, 5, 7, 100_000)
    before = k1.fused_nmf_pgm_step.launches
    one = k1.fused_nmf_pgm_step(A, S, Y, 0.01)
    two = k1.fused_nmf_pgm_step(A, S, Y, 0.01)
    torch.cuda.synchronize()
    assert k1.fused_nmf_pgm_step.launches == before + 2
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_kernel_keeps_nan(dev):
    """A NaN column stays NaN through the non-negativity prox, so the
    solver's divergence detection sees it."""
    A, S, Y, _ = _problem(dev, 5, 7, 1000)
    S[:, 17] = float("nan")
    _, S_new, _, loss, dS_sq, _ = k1.fused_nmf_pgm_step(A, S, Y, 0.01)
    assert bool(torch.isnan(S_new[:, 17]).all())
    assert bool(torch.isfinite(S_new[:, :17]).all())
    assert not bool(torch.isfinite(loss)) and not bool(torch.isfinite(dS_sq))


def test_kernel_refuses_what_it_cannot_run(dev):
    A, S, Y, _ = _problem(dev, 5, 7, 100)
    with pytest.raises(ValueError, match="prox_plus"):
        k1.fused_nmf_pgm_step(A, S, Y, 0.1, prox_S=top.prox_soft)
    with pytest.raises(TypeError, match="float32"):
        k1.fused_nmf_pgm_step(A.double(), S, Y, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        St = S.T.contiguous().T
        k1.fused_nmf_pgm_step(A, St, Y, 0.1)
    A2, S2, Y2, _ = _problem(dev, 17, 3, 100)
    with pytest.raises(ValueError, match="C <= 16"):
        k1.fused_nmf_pgm_step(A2, S2, Y2, 0.1)
    with pytest.raises(ValueError, match="share one device"):
        k1.fused_nmf_pgm_step(A, S.cpu(), Y, 0.1)


def test_cuda_engine_on_the_card(dev):
    """engine='cuda' vs engine='torch' on the card, 30 iterations; one
    launch per iteration; a 15 + 15 resume equals 30 straight."""
    A0, S0, Y, _ = _problem(dev, 5, 3, 20_000)
    Y = A0 @ torch.rand((3, 20_000), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    before = k1.fused_nmf_pgm_step.launches
    rc = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=30, engine="cuda")
    assert k1.fused_nmf_pgm_step.launches - before == rc.iterations == 30
    rt = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=30, engine="torch")
    for a, b in zip(rc.x, rt.x):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
    half = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=15, engine="cuda")
    rest = tnmf.nmf(Y, *half.x, e_rel=0, max_iter=15, state=half.state)
    for a, b in zip(rest.x, rc.x):
        assert torch.equal(a, b)
    # NumPy inputs go to the device named by device=, and come back updated
    A_np, S_np = A0.cpu().numpy(), S0.cpu().numpy()
    rn = tnmf.nmf(Y.cpu().numpy(), A_np, S_np, e_rel=0, max_iter=30,
                  engine="cuda", device=dev)
    assert rn.x[1].device == dev
    assert torch.equal(rn.x[1], rc.x[1])
    np.testing.assert_array_equal(S_np, rc.x[1].cpu().numpy())


def _adaprox_operands(dev, C, K, N, weighted=False, mdt=torch.float32,
                      seed=101):
    A, S, Y, W = _problem(dev, C, K, N, weighted, seed)
    rng = np.random.default_rng(seed + 1)
    M = torch.tensor(0.1 * rng.standard_normal((K, N)), dtype=torch.float32,
                     device=dev).to(mdt)
    V = torch.tensor(0.01 * rng.random((K, N)), dtype=torch.float32,
                     device=dev).to(mdt)
    alpha = S.sum(1, keepdim=True) / N / 10
    one, t = np.float32(1), np.float32(3)
    sc = (np.float32(0.9), one / (one - np.float32(0.9) ** t),
          one / (one - np.float32(0.999) ** t))
    return A, S, M, V, Y, alpha, sc, W


def _within_one_bf16_ulp(got, ref):
    """One bfloat16 ulp of ref, plus atol 1e-5 where the EMA cancels to
    near zero (there the float32 values already differ by more than an
    ulp of the result)."""
    g, r = got.float(), ref.float()
    _, e = torch.frexp(r)
    ulp = torch.ldexp(torch.ones_like(r), e - 8).clamp_min(2.0 ** -133)
    assert got.dtype == torch.bfloat16
    assert bool(((g - r).abs() <= ulp + 1e-5).all())


@pytest.mark.parametrize("C,K,N", [(5, 7, 1000), (8, 4, 4133), (16, 8, 300),
                                   (1, 1, 5), (3, 2, 10000)])
@pytest.mark.parametrize("mdt", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("prox", ["plus", "id"])
@pytest.mark.parametrize("tile_n", [128, k1.DEFAULT_TILE_N])
def test_adaprox_kernel_matches_plain_version(dev, C, K, N, mdt, weighted,
                                              prox, tile_n):
    mdt = torch.bfloat16 if mdt == "bf16" else torch.float32
    A, S, M, V, Y, alpha, sc, W = _adaprox_operands(dev, C, K, N, weighted,
                                                    mdt)
    prox_S = None if prox == "plus" else top.prox_id
    got = k1.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc, W=W,
                                    prox_S=prox_S, tile_n=tile_n)
    ref = k1.fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha, sc, W=W,
                                              prox_S=prox_S)
    torch.cuda.synchronize()
    for i, (g, r) in enumerate(zip(got, ref)):
        if mdt == torch.bfloat16 and i in (2, 3):
            _within_one_bf16_ulp(g, r)
        else:
            rtol = 1e-3 if i == 6 else 2e-4
            torch.testing.assert_close(g, r, rtol=rtol, atol=1e-5)


def test_adaprox_kernel_is_deterministic_and_counted(dev):
    args = _adaprox_operands(dev, 5, 7, 100_000, mdt=torch.bfloat16)
    before = k1.fused_nmf_adaprox_step.launches
    one = k1.fused_nmf_adaprox_step(*args[:7])
    two = k1.fused_nmf_adaprox_step(*args[:7])
    torch.cuda.synchronize()
    assert k1.fused_nmf_adaprox_step.launches == before + 2
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_adaprox_kernel_keeps_nan(dev):
    """A NaN column stays NaN through the Psi floor and the prox, and
    reaches the statistics."""
    A, S, M, V, Y, alpha, sc, _ = _adaprox_operands(dev, 5, 7, 1000)
    S[:, 17] = float("nan")
    out = k1.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc)
    S_new, M_new, loss, dS_sq, nS_sq = out[1], out[2], out[5], out[6], out[7]
    assert bool(torch.isnan(S_new[:, 17]).all())
    assert bool(torch.isnan(M_new[:, 17]).all())
    assert bool(torch.isfinite(S_new[:, :17]).all())
    for v in (loss, dS_sq, nS_sq):
        assert not bool(torch.isfinite(v))


def test_adaprox_kernel_refuses_what_it_cannot_run(dev):
    A, S, M, V, Y, alpha, sc, _ = _adaprox_operands(dev, 5, 7, 100)
    with pytest.raises(ValueError, match="engine='torch'"):
        k1.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc,
                                  prox_S=top.prox_soft)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k1.fused_nmf_adaprox_step(A, S, M.half(), V.half(), Y, alpha, sc)
    with pytest.raises(TypeError):
        k1.fused_nmf_adaprox_step(A, S, M, V.bfloat16(), Y, alpha, sc)
    A2, S2, M2, V2, Y2, alpha2, _, _ = _adaprox_operands(dev, 17, 3, 100)
    with pytest.raises(ValueError, match="C <= 16"):
        k1.fused_nmf_adaprox_step(A2, S2, M2, V2, Y2, alpha2, sc)


@pytest.mark.parametrize("mdt", [None, torch.bfloat16])
def test_adaprox_engines_on_the_card(dev, mdt):
    """nmf(algorithm='adaprox') engine='cuda' vs engine='torch' with
    separable_prox='auto' on the card, 30 iterations, with W; one K2 launch
    per iteration; a 15 + 15 resume equals 30 straight and also continues
    on the torch engine."""
    A0, S0, _, W = _problem(dev, 5, 3, 20_000, weighted=True)
    Y = A0 @ torch.rand((3, 20_000), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    kw = dict(algorithm="adaprox", e_rel=0, W=W)
    before = k1.fused_nmf_adaprox_step.launches
    rc = tnmf.nmf(Y, A0, S0, max_iter=30, engine="cuda", moment_dtype=mdt,
                  **kw)
    assert k1.fused_nmf_adaprox_step.launches - before == rc.iterations == 30
    rt = tnmf.nmf(Y, A0, S0, max_iter=30, engine="torch",
                  separable_prox="auto", moment_dtype=mdt, **kw)
    tol = (dict(rtol=1e-3, atol=1e-5) if mdt is None
           else dict(rtol=0, atol=0.05))
    for a, b in zip(rc.x, rt.x):
        torch.testing.assert_close(a, b, **tol)
    half = tnmf.nmf(Y, A0, S0, max_iter=15, engine="cuda", moment_dtype=mdt,
                    **kw)
    rest = tnmf.nmf(Y, *half.x, max_iter=15, engine="cuda", moment_dtype=mdt,
                    state=half.state, **kw)
    for a, b in zip(rest.x, rc.x):
        assert torch.equal(a, b)
    on_torch = tnmf.nmf(Y, *half.x, max_iter=15, engine="torch",
                        separable_prox="auto", moment_dtype=mdt,
                        state=half.state, **kw)
    for a, b in zip(on_torch.x, rc.x):
        torch.testing.assert_close(a, b, **tol)
