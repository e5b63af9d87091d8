"""K1 (float32 and the bfloat16 store), K2, K3, K4 and K5 on the card
against their plain versions, the cuda engines (exact, weighted and
strided) and the ops entry point's paths on the card.

The registered ops (K1-K4 as torch.library ops) against their wrappers bit
for bit and their fakes, K2's device-scalar entry against its by-value
entry, and exported NMF programs against their drivers bit for bit, with
the host reads of their loops.

Needs an NVIDIA GPU and nvcc; every test skips elsewhere. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: rtol 2e-4, atol 1e-5 elementwise (|S' - S|^2 rtol 1e-3), as the
CPU tests hold the plain versions to the JAX kernels: both sides are float32
and sum the pixel-axis reductions in different orders. bfloat16 moment
stores: within one bfloat16 ulp (a one-ulp float32 difference in the EMA may
flip one rounding), plus atol 1e-5 where the EMA cancels to near zero.
K3 (fused_nmf_grad): rtol 2e-4, atol 1e-5, as K1. K4 (the prox kernels):
plus, soft and hard bitwise equal (one comparison or a few separately
rounded operations per element, as in the plain version); unity rtol 1e-6
in float32 and 1e-14 in float64 (the sums are taken in another order).
K1's bfloat16 store: S' within one bfloat16 ulp (+ 1e-5) of the plain
version's; gA and the loss as K1; the Gram and the norms against the stored
S' (rtol 2e-4, |S' - S|^2 1e-3). K5 (packed_step): bit for bit equal to K2
on the same inputs (the same body), and held to the plain version as K2 is.
K2's bfloat16 store: as K1's (S' within one bfloat16 ulp, the row sums and
the norms against the stored S'), the moments as above.
The ADMM family on the card: sdmm with K4 soft as prox_g against
operators.prox_soft, and resumed solves against straight ones, bitwise.
The solvers' options on the card: blocking reads per iteration with a
callback, a trace and backtracking; a checkpoint written on the card
reloads on the CPU and back with equal bits.
The functional factories on the card: one blocking read per iteration
outside vmap and bit for bit their drivers' iterates; batched NMF lanes
against their individual solves in float64 (rtol 1e-10: vmap may batch a
product another way); the lanes controller's private torch._C._functorch
route, which must end a batch at its slowest lane on this torch; and
backtracking under vmap, which reads once per iteration and once per
halving round.
"""

import functools
import json
import time

import numpy as np
import pytest
import torch

from proxmin_tpu_torch import algorithms, linop
from proxmin_tpu_torch import nmf as tnmf
from proxmin_tpu_torch import operators as top
from proxmin_tpu_torch import ops as tops
from proxmin_tpu_torch.ops import nmf_kernels as k1
from proxmin_tpu_torch.ops import prox_kernels as pk
from proxmin_tpu_torch.ops import stream_merge as sm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
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
    """prox_soft and C = 17 run (a compiled chain, the wide body), and so
    does C = 257 (the very-wide body), matching the plain version; the
    wrapper refuses other dtypes, strided operands and mixed devices."""
    A, S, Y, _ = _problem(dev, 5, 7, 100)
    _assert_step_close(
        k1.fused_nmf_pgm_step(A, S, Y, 0.1, prox_S=top.prox_soft),
        k1.fused_nmf_pgm_step_reference(A, S, Y, 0.1, prox_S=top.prox_soft))
    with pytest.raises(TypeError, match="float32"):
        k1.fused_nmf_pgm_step(A.double(), S, Y, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        St = S.T.contiguous().T
        k1.fused_nmf_pgm_step(A, St, Y, 0.1)
    A2, S2, Y2, _ = _problem(dev, 17, 3, 100)
    _assert_step_close(k1.fused_nmf_pgm_step(A2, S2, Y2, 0.1),
                       k1.fused_nmf_pgm_step_reference(A2, S2, Y2, 0.1))
    A3, S3, Y3, _ = _problem(dev, 257, 3, 100)
    before = k1.fused_nmf_pgm_step.route_launches["very wide"]
    _assert_step_close(k1.fused_nmf_pgm_step(A3, S3, Y3, 0.1),
                       k1.fused_nmf_pgm_step_reference(A3, S3, Y3, 0.1))
    assert k1.fused_nmf_pgm_step.route_launches["very wide"] == before + 1
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


def _assert_adaprox_close(got, ref):
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.dtype == torch.bfloat16 and i in (2, 3):
            _within_one_bf16_ulp(g, r)
        else:
            torch.testing.assert_close(g, r, rtol=1e-3 if i == 6 else 2e-4,
                                       atol=1e-5)


def test_adaprox_kernel_refuses_what_it_cannot_run(dev):
    """prox_soft and C = 17 run (a compiled chain, the wide body), and so
    does K = 33 (the very-wide body), matching the plain version; the
    wrapper refuses other moment dtypes and mixed moments."""
    A, S, M, V, Y, alpha, sc, _ = _adaprox_operands(dev, 5, 7, 100)
    _assert_adaprox_close(
        k1.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc,
                                  prox_S=top.prox_soft),
        k1.fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha, sc,
                                            prox_S=top.prox_soft))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k1.fused_nmf_adaprox_step(A, S, M.half(), V.half(), Y, alpha, sc)
    with pytest.raises(TypeError):
        k1.fused_nmf_adaprox_step(A, S, M, V.bfloat16(), Y, alpha, sc)
    A2, S2, M2, V2, Y2, alpha2, _, _ = _adaprox_operands(dev, 17, 3, 100)
    _assert_adaprox_close(
        k1.fused_nmf_adaprox_step(A2, S2, M2, V2, Y2, alpha2, sc),
        k1.fused_nmf_adaprox_step_reference(A2, S2, M2, V2, Y2, alpha2, sc))
    A3, S3, M3, V3, Y3, alpha3, _, _ = _adaprox_operands(dev, 4, 33, 100)
    before = k1.fused_nmf_adaprox_step.route_launches["very wide"]
    _assert_adaprox_close(
        k1.fused_nmf_adaprox_step(A3, S3, M3, V3, Y3, alpha3, sc),
        k1.fused_nmf_adaprox_step_reference(A3, S3, M3, V3, Y3, alpha3, sc))
    assert (k1.fused_nmf_adaprox_step.route_launches["very wide"]
            == before + 1)


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


@pytest.mark.parametrize("C,K,N", [(5, 7, 1000), (8, 4, 4133), (16, 8, 300),
                                   (1, 1, 5), (5, 7, 100_000)])
@pytest.mark.parametrize("mdt", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("prox", ["plus", "id"])
@pytest.mark.parametrize("tile_n", [128, k1.DEFAULT_TILE_N])
def test_adaprox_bf16_store_kernel_matches_plain_version(dev, C, K, N, mdt,
                                                         weighted, prox,
                                                         tile_n):
    """S, Y and W in bfloat16: rows 16-byte aligned (bulk copies into the
    ring) and not (N = 4133, 300: every thread copies its column)."""
    mdt = torch.bfloat16 if mdt == "bf16" else torch.float32
    A, S, M, V, Y, alpha, sc, W = _adaprox_operands(dev, C, K, N, weighted,
                                                    mdt)
    bf = torch.bfloat16
    S, Y = S.to(bf), Y.to(bf)
    W = None if W is None else W.to(bf)
    prox_S = None if prox == "plus" else top.prox_id
    got = k1.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc, W=W,
                                    prox_S=prox_S, tile_n=tile_n)
    again = k1.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc, W=W,
                                      prox_S=prox_S, tile_n=tile_n)
    ref = k1.fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha, sc, W=W,
                                              prox_S=prox_S)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    _within_one_bf16_ulp(got[1], ref[1])
    for i in (2, 3):
        if mdt == torch.bfloat16:
            _within_one_bf16_ulp(got[i], ref[i])
        else:
            torch.testing.assert_close(got[i], ref[i], rtol=2e-4, atol=1e-5)
    for i in (0, 5):
        torch.testing.assert_close(got[i], ref[i], rtol=2e-4, atol=1e-5)
    Sn = got[1].float()
    dS = Sn - S.float()
    torch.testing.assert_close(got[4], Sn.sum(1, keepdim=True), rtol=2e-4,
                               atol=1e-5)
    torch.testing.assert_close(got[6], torch.sum(dS * dS), rtol=1e-3,
                               atol=1e-5)
    torch.testing.assert_close(got[7], torch.sum(Sn * Sn), rtol=2e-4,
                               atol=1e-5)


def test_adaprox_kernel_persistent_grid(dev):
    """Many more tiles than resident blocks, and tile_n values that are and
    are not multiples of the ring's sub-tile: two launches agree bit for bit
    and match the plain version."""
    args = _adaprox_operands(dev, 5, 7, 300_001, mdt=torch.bfloat16)
    for tile_n in (128, 1000, k1.DEFAULT_TILE_N):
        one = k1.fused_nmf_adaprox_step(*args[:7], tile_n=tile_n)
        two = k1.fused_nmf_adaprox_step(*args[:7], tile_n=tile_n)
        ref = k1.fused_nmf_adaprox_step_reference(*args[:7])
        torch.cuda.synchronize()
        for a, b in zip(one, two):
            assert torch.equal(a, b)
        for i in (0, 4, 5, 7):
            torch.testing.assert_close(one[i], ref[i], rtol=2e-4, atol=1e-5)


def test_adaprox_bf16_store_engine_on_the_card(dev):
    """nmf(algorithm='adaprox', engine='cuda', store_dtype=bfloat16) with W
    and bfloat16 moments: one K2 launch per iteration, the loss within the
    JAX suite's rule of the float32 store's, and a 15 + 15 resume equal to
    30 straight."""
    A0, S0, _, W = _problem(dev, 5, 3, 20_000, weighted=True)
    Y = A0 @ torch.rand((3, 20_000), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    kw = dict(algorithm="adaprox", engine="cuda", e_rel=0, W=W,
              moment_dtype=torch.bfloat16)
    r32 = tnmf.nmf(Y, A0, S0, max_iter=30, **kw)
    before = k1.fused_nmf_adaprox_step.launches
    r16 = tnmf.nmf(Y, A0, S0, max_iter=30, store_dtype=torch.bfloat16, **kw)
    assert k1.fused_nmf_adaprox_step.launches - before == 30

    def wloss(r):
        R = r.x[0] @ r.x[1] - Y
        return float(0.5 * torch.sum(W * R * R))

    assert r16.x[1].dtype == torch.float32
    assert wloss(r16) < max(3 * wloss(r32), wloss(r32) + 1.0)
    half = tnmf.nmf(Y, A0, S0, max_iter=15, store_dtype=torch.bfloat16, **kw)
    rest = tnmf.nmf(Y, *half.x, max_iter=15, store_dtype=torch.bfloat16,
                    state=half.state, **kw)
    for a, b in zip(rest.x, r16.x):
        assert torch.equal(a, b)


# K3: fused_nmf_grad

@pytest.mark.parametrize("C,K,N", [(5, 7, 1000), (8, 4, 4133), (16, 8, 300),
                                   (1, 1, 5), (3, 2, 10000), (5, 7, 1_000_000)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tile_n", [128, k1.DEFAULT_TILE_N])
def test_grad_kernel_matches_plain_version(dev, C, K, N, weighted, tile_n):
    A, S, Y, W = _problem(dev, C, K, N, weighted)
    got = tops.fused_nmf_grad(A, S, Y, W=W, tile_n=tile_n)
    ref = tops.fused_nmf_grad_reference(A, S, Y, W=W)
    torch.cuda.synchronize()
    assert got[3].shape == () and all(t.dtype == torch.float32 for t in got)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-5)


def test_grad_kernel_casts_inputs_to_float32(dev):
    A, S, Y, W = _problem(dev, 5, 7, 3000, weighted=True)
    got = tops.fused_nmf_grad(A.double(), S.double(), Y.double(),
                              W=W.double())
    again = tops.fused_nmf_grad(A, S, Y, W=W)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert g.dtype == torch.float32 and torch.equal(g, a)


def test_grad_kernel_is_deterministic_and_counted(dev):
    A, S, Y, W = _problem(dev, 5, 7, 200_000, weighted=True)
    before = tops.fused_nmf_grad.launches
    one = tops.fused_nmf_grad(A, S, Y, W=W)
    two = tops.fused_nmf_grad(A, S, Y, W=W)
    torch.cuda.synchronize()
    assert tops.fused_nmf_grad.launches == before + 2
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_grad_kernel_keeps_nan(dev):
    A, S, Y, _ = _problem(dev, 5, 7, 1000)
    S[:, 17] = float("nan")
    gA, gS, SSt, loss = tops.fused_nmf_grad(A, S, Y)
    assert bool(torch.isnan(gS[:, 17]).all())
    assert bool(torch.isfinite(gS[:, :17]).all())
    for v in (gA, SSt, loss):
        assert not bool(torch.isfinite(v).all())


def test_grad_kernel_refuses_what_it_cannot_run(dev):
    """C = 17 and K = 9 run on the wide body, C = 257 and K = 33 on the
    very-wide body, and match the plain version; the wrapper refuses mixed
    devices."""
    for C, K, route in ((17, 3, "wide"), (4, 9, "wide"),
                        (257, 3, "very wide"), (4, 33, "very wide")):
        A2, S2, Y2, _ = _problem(dev, C, K, 100)
        before = k1.fused_nmf_grad.route_launches[route]
        for g, r in zip(tops.fused_nmf_grad(A2, S2, Y2),
                        tops.fused_nmf_grad_reference(A2, S2, Y2)):
            torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-5)
        assert k1.fused_nmf_grad.route_launches[route] == before + 1
    A, S, Y, _ = _problem(dev, 5, 7, 100)
    with pytest.raises(ValueError, match="share one device"):
        tops.fused_nmf_grad(A, S.cpu(), Y)


# K1-K3: the compiled prox chains, the split path and the wide body

_P = functools.partial


def _chain(thresh):
    """The simplex, then an absolute soft threshold, twice."""
    return top.AlternatingProjections(
        [_P(top.prox_unity_plus, axis=0),
         _P(top.prox_soft_plus, thresh=thresh, type="absolute")], repeat=2)


# prox_S cases: a compiled chain for each code (thresholds relative to the
# step or absolute) and the split path (a user closure, a pixel-coupled
# prox, prox_max_entropy)
_PROX_CASES = {
    "zero": top.prox_zero,
    "min_rel": _P(top.prox_min, thresh=0.4),
    "max_abs": _P(top.prox_max, thresh=0.6, type="absolute"),
    "hard_rel": _P(top.prox_hard, thresh=8.0),
    "hard_plus_abs": _P(top.prox_hard_plus, thresh=0.3, type="absolute"),
    "soft_rel": _P(top.prox_soft, thresh=4.0),
    "soft_plus_abs": _P(top.prox_soft_plus, thresh=0.05, type="absolute"),
    "unity_plus": _P(top.prox_unity_plus, axis=0),
    "chain": _chain(0.05),
    "split_closure": lambda x, s: top.prox_unity_plus(x, s, axis=0),
    "split_axis1": _P(top.prox_unity_plus, axis=1),
}
# K2 applies separable proxes with the per-element step alpha / Psi
_ADAPROX_CASES = ("zero", "max_abs", "soft_rel", "soft_plus_abs",
                  "split_closure", "split_axis1")
# one shape per instance: the narrow ones (C <= 16, K <= 8) and the wide
# body's KB = 8, 16 and 32, unaligned N; then the wide body's tile edges,
# the shapes at which tests/test_torch_kernel_modes.py holds the plain
# versions against the JAX kernels: C around the chunk of 32 channels and
# the bound 256, K around the bounds 8, 16 and 32, and N = 1, a thread's 4
# columns +- 1, the sub-tile of 256 columns +- 1, the default tile_n 4096
# +- 1; 16_700 in tiles of 128 (131 units, a group each), 38_430 in tiles
# of 128 (301 units: groups of three where a block runs alone on an SM, of
# two where two do, the last group of one unit, partial) and 70_000 in
# tiles of 1000 (units of 256, 256, 256 and 232 columns; 280 units in
# groups of three or two that hold a short unit and a tile's end inside
# them)
_SHAPES = [(5, 7, 1000), (16, 8, 300), (40, 3, 1029), (100, 12, 700),
           (128, 32, 5000), (256, 17, 300),
           (17, 9, 1), (31, 17, 3), (32, 31, 5), (33, 32, 255),
           (129, 9, 257), (255, 31, 4095), (256, 32, 4097),
           (40, 12, 16_700), (40, 12, 38_430), (40, 20, 70_000)]
_WIDE_SHAPES = _SHAPES[2:]
_TILE_N = {(40, 12, 16_700): 128, (40, 12, 38_430): 128,
           (40, 20, 70_000): 1000}


def _tile_n(C, K, N):
    return _TILE_N.get((C, K, N), k1.DEFAULT_TILE_N)


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _twice(fn):
    """Two launches of a kernel: their outputs, checked equal bit for
    bit."""
    one, two = fn(), fn()
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert torch.equal(_bits(a), _bits(b))
    return one


def _cases(names):
    """(C, K, N, case) for every shape and case, but the prox over the
    pixels (axis 1) at the shapes of a few pixels, N < 256: a row with no
    positive entry divides 0 by 0, NaN in the kernel and the plain version
    alike, which no comparison of values holds."""
    return [(C, K, N, case) for C, K, N in _SHAPES for case in names
            if not (N < 256 and case == "split_axis1")]


@pytest.mark.parametrize("C,K,N,case", _cases(sorted(_PROX_CASES)))
@pytest.mark.parametrize("weighted", [False, True])
def test_k1_modes_match_plain_version(dev, C, K, N, weighted, case):
    A, S, Y, W = _problem(dev, C, K, N, weighted)
    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    prox = _PROX_CASES[case]
    routes = dict(k1.fused_nmf_pgm_step.route_launches)
    got = _twice(lambda: k1.fused_nmf_pgm_step(
        A, S, Y, sS, W=W, prox_S=prox, tile_n=_tile_n(C, K, N)))
    ref = k1.fused_nmf_pgm_step_reference(A, S, Y, sS, W=W, prox_S=prox)
    torch.cuda.synchronize()
    _assert_step_close(got, ref)
    split = k1.describe_prox(prox).split
    narrow = C <= 16 and K <= 8
    ran = {r: n - routes[r]
           for r, n in k1.fused_nmf_pgm_step.route_launches.items()}
    want = ({"split pass 1": 2, "split pass 2": 2} if split
            else {"narrow" if narrow else "wide": 2})
    assert {r: n for r, n in ran.items() if n} == want


@pytest.mark.parametrize("C,K,N", _SHAPES)
@pytest.mark.parametrize("case", ["soft_plus_abs", "unity_plus",
                                  "split_closure"])
def test_k1_bf16_store_modes(dev, C, K, N, case):
    """The bfloat16 store: S' within one bfloat16 ulp of the plain
    version's, gA and the loss as float32's, the Gram and the norms
    against the stored S'."""
    A, S, Y, W = _problem(dev, C, K, N, weighted=True)
    bf = torch.bfloat16
    S, Y, W = S.to(bf), Y.to(bf), W.to(bf)
    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    prox = _PROX_CASES[case]
    got = _twice(lambda: k1.fused_nmf_pgm_step(
        A, S, Y, sS, W=W, prox_S=prox, tile_n=_tile_n(C, K, N)))
    ref = k1.fused_nmf_pgm_step_reference(A, S, Y, sS, W=W, prox_S=prox)
    torch.cuda.synchronize()
    _within_one_bf16_ulp(got[1], ref[1])
    for i in (0, 3):
        torch.testing.assert_close(got[i], ref[i], rtol=2e-4, atol=1e-5)
    Sn = got[1].float()
    dS = Sn - S.float()
    torch.testing.assert_close(got[2], Sn @ Sn.T, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(got[4], torch.sum(dS * dS), rtol=1e-3,
                               atol=1e-5)
    torch.testing.assert_close(got[5], torch.sum(Sn * Sn), rtol=2e-4,
                               atol=1e-5)


@pytest.mark.parametrize("C,K,N,case", _cases(_ADAPROX_CASES))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
def test_k2_modes_match_plain_version(dev, C, K, N, weighted, mdt, case):
    A, S, M, V, Y, alpha, sc, W = _adaprox_operands(dev, C, K, N, weighted,
                                                    mdt)
    prox = k1.describe_prox(_PROX_CASES[case], "adaprox", True)
    got = _twice(lambda: k1.fused_nmf_adaprox_step(
        A, S, M, V, Y, alpha, sc, W=W, prox_S=prox, tile_n=_tile_n(C, K, N)))
    ref = k1.fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha, sc, W=W,
                                              prox_S=prox)
    torch.cuda.synchronize()
    _assert_adaprox_close(got, ref)


@pytest.mark.parametrize("C,K,N", _WIDE_SHAPES)
@pytest.mark.parametrize("case", ["soft_plus_abs", "split_closure"])
def test_k2_wide_bf16_store(dev, C, K, N, case):
    A, S, M, V, Y, alpha, sc, W = _adaprox_operands(dev, C, K, N, True,
                                                    torch.bfloat16)
    bf = torch.bfloat16
    S, Y, W = S.to(bf), Y.to(bf), W.to(bf)
    prox = k1.describe_prox(_PROX_CASES[case], "adaprox", True)
    got = _twice(lambda: k1.fused_nmf_adaprox_step(
        A, S, M, V, Y, alpha, sc, W=W, prox_S=prox, tile_n=_tile_n(C, K, N)))
    ref = k1.fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha, sc, W=W,
                                              prox_S=prox)
    torch.cuda.synchronize()
    for i in (1, 2, 3):
        _within_one_bf16_ulp(got[i], ref[i])
    for i in (0, 5):
        torch.testing.assert_close(got[i], ref[i], rtol=2e-4, atol=1e-5)
    Sn = got[1].float()
    torch.testing.assert_close(got[4], Sn.sum(1, keepdim=True), rtol=2e-4,
                               atol=1e-5)


@pytest.mark.parametrize("C,K,N", _WIDE_SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_k3_wide_matches_plain_version(dev, C, K, N, weighted):
    A, S, Y, W = _problem(dev, C, K, N, weighted)
    before = dict(k1.fused_nmf_grad.route_launches)
    got = _twice(lambda: tops.fused_nmf_grad(
        A, S, Y, W=W, tile_n=_TILE_N.get((C, K, N), 1000)))
    ref = tops.fused_nmf_grad_reference(A, S, Y, W=W)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-5)
    assert k1.fused_nmf_grad.route_launches["wide"] == before["wide"] + 2


def _bit_cases(dev):
    """The wide instances' modes at (128, 32, 4097) (and the narrow ones at
    (5, 7, 4097)), with W, from seeded inputs: name -> a call whose outputs
    test_wide_instances_keep_their_bits hashes."""
    cases = {}
    bf = torch.bfloat16
    for C, K in ((128, 32), (5, 7)):
        A, S, Y, W = _problem(dev, C, K, 4097, weighted=True)
        sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
        Sb, Yb, Wb = S.to(bf), Y.to(bf), W.to(bf)
        _, _, M, V, _, alpha, sc, _ = _adaprox_operands(dev, C, K, 4097,
                                                        True)
        Mb, Vb = M.to(bf), V.to(bf)
        l1 = k1.describe_prox(_PROX_CASES["soft_plus_abs"], "adaprox", True)
        clo = _PROX_CASES["split_closure"]
        tag = f"({C}, {K})"
        cases.update({
            f"K1 unity_plus {tag}": _P(k1.fused_nmf_pgm_step, A, S, Y, sS,
                                       W=W, prox_S=_PROX_CASES["unity_plus"]),
            f"K1 bf16 {tag}": _P(k1.fused_nmf_pgm_step, A, Sb, Yb, sS, W=Wb,
                                 prox_S=_PROX_CASES["soft_plus_abs"]),
            f"K1 split {tag}": _P(k1.fused_nmf_pgm_step, A, S, Y, sS, W=W,
                                  prox_S=clo),
            f"K2 {tag}": _P(k1.fused_nmf_adaprox_step, A, S, M, V, Y, alpha,
                            sc, W=W, prox_S=l1),
            f"K2 bf16 {tag}": _P(k1.fused_nmf_adaprox_step, A, Sb, Mb, Vb,
                                 Yb, alpha, sc, W=Wb, prox_S=l1),
            f"K2 split {tag}": _P(k1.fused_nmf_adaprox_step, A, S, M, V, Y,
                                  alpha, sc, W=W, prox_S=clo),
            f"K3 {tag}": _P(tops.fused_nmf_grad, A, S, Y, W=W),
        })
    return cases


def _digest(t):
    import hashlib

    b = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(b.tobytes()).hexdigest()[:16]


# The digests of _bit_cases' outputs as the wide and narrow instances gave
# them before the very-wide body was added beside them (an NVIDIA H100
# 80GB HBM3): the new tier leaves their bits as they were.
_WIDE_BITS = {
    "K1 unity_plus (128, 32)": (
        "de9805618b31d05a", "65e702dfb13f3ceb", "0b309088f8cbe811",
        "0a3e132d78b08143", "779e4cb3231d224f", "eec2a7fec70b57a6",
    ),
    "K1 bf16 (128, 32)": (
        "856a26e0bc66e169", "ce2a491eabf6cd96", "818a3e08d981b78a",
        "5572d50dfe7ec08a", "6743e48fc082aca2", "c3c634f09ad18477",
    ),
    "K1 split (128, 32)": (
        "de9805618b31d05a", "b9c1a0dcee35d30f", "7b06ade0590507fe",
        "0a3e132d78b08143", "779e4cb3231d224f", "eec2a7fec70b57a6",
    ),
    "K2 (128, 32)": (
        "de9805618b31d05a", "02a627cdb2f5e618", "f3b2554cf8bb55a5",
        "e9b81aec644dd677", "7aa1f31c4287b740", "0a3e132d78b08143",
        "5281adfb093664d8", "aef06f42812c4750",
    ),
    "K2 bf16 (128, 32)": (
        "856a26e0bc66e169", "2d162fc4f4ff7200", "abd8cade85c49f4d",
        "382350b878049c38", "6d995115bed6f03f", "5572d50dfe7ec08a",
        "8ed50838da7e1d8a", "9636ed5204ef145d",
    ),
    "K2 split (128, 32)": (
        "de9805618b31d05a", "8457f2de38ecc326", "f3b2554cf8bb55a5",
        "e9b81aec644dd677", "de638aa86ecb45c5", "0a3e132d78b08143",
        "8e7c269b27773d7a", "60a4e7ef44832467",
    ),
    "K3 (128, 32)": (
        "de9805618b31d05a", "45ad6ac389251842", "76ff2410d1daa70d",
        "0a3e132d78b08143",
    ),
    "K1 unity_plus (5, 7)": (
        "039c7e6201fc142b", "b484b0df57ae94a4", "dea4316bb5d35c41",
        "b40208acefa82f9a", "992a85dac9572184", "740547354d272aa2",
    ),
    "K1 bf16 (5, 7)": (
        "2bd45b68b5f0c7ec", "6f2a495f7eb9cfbc", "14836ed80e59c11d",
        "b06974c0e121a870", "9e9335a5949a428a", "8d66b8ccdd1df8d8",
    ),
    "K1 split (5, 7)": (
        "46da99c93805d67f", "9d3cd3c84a0f0f35", "d6df015197f8fbff",
        "b40208acefa82f9a", "1fa6b93cf1273879", "7273820971ec0e19",
    ),
    "K2 (5, 7)": (
        "46da99c93805d67f", "c66ad814bfb94dfc", "824a3e649b87af90",
        "3d444576bb47ede3", "661b0b4cadeac43d", "b40208acefa82f9a",
        "8bdbd969d92b6d29", "a04d8d9ed8c8cb7a",
    ),
    "K2 bf16 (5, 7)": (
        "47fb5a022efa5969", "90521903b1d5c53e", "9cede99528622331",
        "b49d1e1570765d75", "458331b524f0ffe6", "b06974c0e121a870",
        "e1459d3e7a7b7ab1", "57c04cc2928644ac",
    ),
    "K2 split (5, 7)": (
        "46da99c93805d67f", "a23dc113e22c4970", "824a3e649b87af90",
        "3d444576bb47ede3", "86b68eab2ceba6ba", "b40208acefa82f9a",
        "31e9553ea11d8f58", "e0539bd1c62e8b48",
    ),
    "K3 (5, 7)": (
        "039c7e6201fc142b", "800297e8d3096025", "8886737f8721fb20",
        "b40208acefa82f9a",
    ),
}


def test_wide_instances_keep_their_bits(dev):
    """The wide body's and the narrow instances' outputs at (128, 32, 4097)
    and (5, 7, 4097), every mode and store, hash to the digests they had
    before the very-wide body was added: the new tier changes none of
    their bits."""
    got = {name: [_digest(t) for t in fn()]
           for name, fn in _bit_cases(dev).items()}
    torch.cuda.synchronize()
    assert got == {k: list(v) for k, v in _WIDE_BITS.items()}


def _vwide_bit_cases(dev):
    """The very-wide tier's modes at (425, 32, 1000), (128, 64, 500),
    (600, 8, 129), (128, 96, 500), (64, 160, 300), (64, 256, 300),
    (224, 240, 300), (33, 300, 129) and (224, 498, 300), with W, from seeded
    inputs: name -> (a call, the indices of its per-column outputs) that
    test_very_wide_columns_keep_their_bits hashes: S' (K1, every mode, the
    multi-op chain and both stores), S1, M' and V' (K2, both moment types
    and stores, the device-scalar entry), split pass 1's x and step, and gS
    (K3)."""
    cases = {}
    bf = torch.bfloat16
    for C, K, N in ((425, 32, 1000), (128, 64, 500), (600, 8, 129),
                    (128, 96, 500), (64, 160, 300), (64, 256, 300),
                    (224, 240, 300), (33, 300, 129), (224, 498, 300)):
        A, S, Y, W = _problem(dev, C, K, N, weighted=True)
        sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
        Sb, Yb, Wb = S.to(bf), Y.to(bf), W.to(bf)
        _, _, M, V, _, alpha, sc, _ = _adaprox_operands(dev, C, K, N, True)
        Mb, Vb = M.to(bf), V.to(bf)
        dsc = torch.tensor([float(v) for v in sc], dtype=torch.float32,
                           device=dev)
        l1 = k1.describe_prox(_PROX_CASES["soft_plus_abs"], "adaprox", True)
        clo = _PROX_CASES["split_closure"]
        tile = k1.DEFAULT_TILE_N
        tag = f"({C}, {K})"
        cases.update({
            f"K1 unity_plus {tag}": (_P(
                k1.fused_nmf_pgm_step, A, S, Y, sS, W=W,
                prox_S=_PROX_CASES["unity_plus"]), (1,)),
            f"K1 chain {tag}": (_P(
                k1.fused_nmf_pgm_step, A, S, Y, sS, W=W,
                prox_S=_vwide_prox("chain", K)), (1,)),
            f"K1 bf16 {tag}": (_P(
                k1.fused_nmf_pgm_step, A, Sb, Yb, sS, W=Wb,
                prox_S=_PROX_CASES["soft_plus_abs"]), (1,)),
            f"K1 pass 1 {tag}": (_P(k1._pgm_pass1_cuda, A, S, Y, sS, W,
                                    tile), (0,)),
            f"K1 bf16 split {tag}": (_P(
                k1.fused_nmf_pgm_step, A, Sb, Yb, sS, W=Wb, prox_S=clo),
                (1,)),
            f"K2 {tag}": (_P(k1.fused_nmf_adaprox_step, A, S, M, V, Y, alpha,
                             sc, W=W, prox_S=l1), (1, 2, 3)),
            f"K2 bf16 moments {tag}": (_P(
                k1.fused_nmf_adaprox_step, A, S, Mb, Vb, Y, alpha, sc, W=W,
                prox_S=l1), (1, 2, 3)),
            f"K2 bf16 {tag}": (_P(
                k1.fused_nmf_adaprox_step, A, Sb, Mb, Vb, Yb, alpha, sc,
                W=Wb, prox_S=l1), (1, 2, 3)),
            f"K2 device scalars {tag}": (_P(
                k1.fused_nmf_adaprox_step, A, S, M, V, Y, alpha, dsc, W=W,
                prox_S=l1), (1, 2, 3)),
            f"K2 pass 1 {tag}": (_P(
                k1._adaprox_pass1_cuda, A, S, M, V, Y, alpha, sc, W, 0.999,
                1e-8, tile), (0, 1, 2, 3)),
            f"K3 {tag}": (_P(tops.fused_nmf_grad, A, S, Y, W=W), (1,)),
        })
    return cases


# The digests of _vwide_bit_cases' per-column outputs as the first
# very-wide body gave them (blocks of 32 components at every K, before the
# tier took the wide body's instances up to K = 32 and its own instances of
# 64 and 128 components past it; an NVIDIA H100 80GB HBM3): the redesigns
# leave every column's bits as they were. The multi-op chain's and
# (64, 160)'s are the tree's before the instances of 64 and 128
# components (the wide body's up to K = 32, blocks of 32 past it), which
# gave the others' bits; (64, 256)'s and (224, 240)'s are the tree's
# before the instance of 256 components (blocks of 32 past K = 128);
# (33, 300)'s and (224, 498)'s the tree's before the panel body (blocks of
# 32 past K = 256).
_VWIDE_BITS = {
    "K1 unity_plus (425, 32)": ("6b5fcf473824dcfa",),
    "K1 bf16 (425, 32)": ("64ca661f7f6f2433",),
    "K1 pass 1 (425, 32)": ("5f9c5f58a5bd57eb",),
    "K1 bf16 split (425, 32)": ("97ce354ce9a7c0ab",),
    "K2 (425, 32)": (
        "d2ac127baef115f6", "8debda9bc38fc2eb", "965eddc8973b96de",
    ),
    "K2 bf16 moments (425, 32)": (
        "649abb92d13a66b1", "a78d7dcef40567bb", "6a6603b16a197eac",
    ),
    "K2 bf16 (425, 32)": (
        "aa028ea4f879a49a", "bcaf362a9fd52be2", "f4a89200868aefe0",
    ),
    "K2 device scalars (425, 32)": (
        "d2ac127baef115f6", "8debda9bc38fc2eb", "965eddc8973b96de",
    ),
    "K2 pass 1 (425, 32)": (
        "9d830c0625ed28d3", "8c83d45b30e9951a", "8debda9bc38fc2eb",
        "965eddc8973b96de",
    ),
    "K3 (425, 32)": ("729d906b71b61be5",),
    "K1 unity_plus (128, 64)": ("4ebca57da84b9bc5",),
    "K1 bf16 (128, 64)": ("c008145cacbff012",),
    "K1 pass 1 (128, 64)": ("75bd1cd1af380c23",),
    "K1 bf16 split (128, 64)": ("47a3ed144988e8c1",),
    "K2 (128, 64)": (
        "bc1e9aadc8fd2810", "9292fb40a6d7c7ce", "28e87b70c3fcaceb",
    ),
    "K2 bf16 moments (128, 64)": (
        "12ce6a08fb79e9d9", "03c5c5d72462e686", "5bc44b3f8771ecfd",
    ),
    "K2 bf16 (128, 64)": (
        "2cd5a53ffeb805cb", "3b5c6422378f0ac8", "0a5bb50a75d4822d",
    ),
    "K2 device scalars (128, 64)": (
        "bc1e9aadc8fd2810", "9292fb40a6d7c7ce", "28e87b70c3fcaceb",
    ),
    "K2 pass 1 (128, 64)": (
        "bf49512b02bfdeab", "18172df3449d44f5", "9292fb40a6d7c7ce",
        "28e87b70c3fcaceb",
    ),
    "K3 (128, 64)": ("f17b93c8c0130708",),
    "K1 unity_plus (600, 8)": ("a30776c41f135a78",),
    "K1 bf16 (600, 8)": ("c616ab0677fc14ea",),
    "K1 pass 1 (600, 8)": ("4cee4e6b09d5eaa2",),
    "K1 bf16 split (600, 8)": ("011a2015657d4576",),
    "K2 (600, 8)": (
        "2218cbcde81b42b7", "291ef1f5b0e5ec42", "8bae3e02fdd80c32",
    ),
    "K2 bf16 moments (600, 8)": (
        "36b99b1f0ec71802", "c8e6d43b09ea6f26", "d64fdc7c80f26621",
    ),
    "K2 bf16 (600, 8)": (
        "589815c76a6f6cc7", "4b326a45fb9bdf17", "92c59bbd906d6672",
    ),
    "K2 device scalars (600, 8)": (
        "2218cbcde81b42b7", "291ef1f5b0e5ec42", "8bae3e02fdd80c32",
    ),
    "K2 pass 1 (600, 8)": (
        "b3af27f5ea01d2d5", "fda0dd1376f00c00", "291ef1f5b0e5ec42",
        "8bae3e02fdd80c32",
    ),
    "K3 (600, 8)": ("6ad1653f056f07a5",),
    "K1 unity_plus (128, 96)": ("10a7a517fe1f3c15",),
    "K1 bf16 (128, 96)": ("74fbc5b1a770e831",),
    "K1 pass 1 (128, 96)": ("e06fe55132e0f1eb",),
    "K1 bf16 split (128, 96)": ("f384627169155d42",),
    "K2 (128, 96)": (
        "3b02f2a2738f3d23", "88c4fba3f27d27e8", "a60eb11da55786df",
    ),
    "K2 bf16 moments (128, 96)": (
        "80525e5aee6c9996", "e1e8ca76db4be2ae", "345231bb758a6db2",
    ),
    "K2 bf16 (128, 96)": (
        "a4c9c2a22d3381fd", "3610128dcc471c3c", "c7f24b50ca59b7c7",
    ),
    "K2 device scalars (128, 96)": (
        "3b02f2a2738f3d23", "88c4fba3f27d27e8", "a60eb11da55786df",
    ),
    "K2 pass 1 (128, 96)": (
        "561f30cbf0b55720", "4ec33f7b4cbb3dd5", "88c4fba3f27d27e8",
        "a60eb11da55786df",
    ),
    "K3 (128, 96)": ("3fd214da9bfa2981",),
    "K1 chain (425, 32)": ("b7df9937d97ad3da",),
    "K1 chain (128, 64)": ("818d37f686f9a3c0",),
    "K1 chain (600, 8)": ("aa4178d80e34beca",),
    "K1 chain (128, 96)": ("06592c2ebf66b3b7",),
    "K1 unity_plus (64, 160)": ("5acac5153bfa8e06",),
    "K1 chain (64, 160)": ("eae85fb5cd4e7f05",),
    "K1 bf16 (64, 160)": ("cf358c30cc82f03a",),
    "K1 pass 1 (64, 160)": ("c86877bd1414332d",),
    "K1 bf16 split (64, 160)": ("c2a4de47528fcc8f",),
    "K2 (64, 160)": (
        "1a2a5189060b7564", "54b6eedef6af013f", "a7d65abff24d9b4a",
    ),
    "K2 bf16 moments (64, 160)": (
        "6d748ddac0cd73ac", "69dab3b6dd914d89", "a04a197aaee40e36",
    ),
    "K2 bf16 (64, 160)": (
        "7e726f0dbce4b159", "3b23fb87aa78e2ef", "7c3ca1f301813263",
    ),
    "K2 device scalars (64, 160)": (
        "1a2a5189060b7564", "54b6eedef6af013f", "a7d65abff24d9b4a",
    ),
    "K2 pass 1 (64, 160)": (
        "4690db3466bdbb25", "11a8ffd81a180ce0", "54b6eedef6af013f",
        "a7d65abff24d9b4a",
    ),
    "K3 (64, 160)": ("ececcb5c8b15821a",),
    "K1 unity_plus (64, 256)": ("5400c507b8a892dd",),
    "K1 chain (64, 256)": ("48d472f21b660003",),
    "K1 bf16 (64, 256)": ("3fb6eac13f574a38",),
    "K1 pass 1 (64, 256)": ("90785b9402eedd84",),
    "K1 bf16 split (64, 256)": ("858427b42b296846",),
    "K2 (64, 256)": (
        "99fce759a21b0c45", "c3f029d312ca85a0", "7560c645c7d5d397",
    ),
    "K2 bf16 moments (64, 256)": (
        "46930dc772340f31", "5c79c76b055c55ed", "ba469f35c315d836",
    ),
    "K2 bf16 (64, 256)": (
        "bf06a575501942f6", "0e68ff69dfa734a9", "b5bac473780ee806",
    ),
    "K2 device scalars (64, 256)": (
        "99fce759a21b0c45", "c3f029d312ca85a0", "7560c645c7d5d397",
    ),
    "K2 pass 1 (64, 256)": (
        "4408410c3a4fbaf6", "8e3aaa803a0ea167", "c3f029d312ca85a0",
        "7560c645c7d5d397",
    ),
    "K3 (64, 256)": ("5cdf8f62da87ea95",),
    "K1 unity_plus (224, 240)": ("0da2435444a84984",),
    "K1 chain (224, 240)": ("3748320d8a175bca",),
    "K1 bf16 (224, 240)": ("4608b8137dcf6f92",),
    "K1 pass 1 (224, 240)": ("196d1143a576f5f3",),
    "K1 bf16 split (224, 240)": ("57da6f7e216e1a66",),
    "K2 (224, 240)": (
        "c7a2d398c271c067", "a8cf760e90f5d423", "d4b1d7f2c3dea5e7",
    ),
    "K2 bf16 moments (224, 240)": (
        "4c760b3221d62ac4", "9ef54b26d3755e00", "5c3f2ea949b4ad99",
    ),
    "K2 bf16 (224, 240)": (
        "77decdd3a66fe1f7", "3a2fde34da802016", "1f02ad980b796b1b",
    ),
    "K2 device scalars (224, 240)": (
        "c7a2d398c271c067", "a8cf760e90f5d423", "d4b1d7f2c3dea5e7",
    ),
    "K2 pass 1 (224, 240)": (
        "7aa562990c9c8ef7", "ecd1b5ef63ef1041", "a8cf760e90f5d423",
        "d4b1d7f2c3dea5e7",
    ),
    "K3 (224, 240)": ("03278648fe3c130f",),
    "K1 unity_plus (33, 300)": ("b34bf633dfa54a62",),
    "K1 chain (33, 300)": ("b21f264fb953157b",),
    "K1 bf16 (33, 300)": ("0f89fa6d1700e7d4",),
    "K1 pass 1 (33, 300)": ("02b37bd8cd7ed186",),
    "K1 bf16 split (33, 300)": ("b55e8bb7c4b54ea0",),
    "K2 (33, 300)": (
        "770686e91ff9328d", "9d00cb9539aed995", "b8dfaabd6941bd43",
    ),
    "K2 bf16 moments (33, 300)": (
        "492db18552fe312b", "5551d8d437b23f60", "db4570a238bda364",
    ),
    "K2 bf16 (33, 300)": (
        "4d942b6fe2d54e74", "0e71472c7031c804", "0dbd41669444a7a5",
    ),
    "K2 device scalars (33, 300)": (
        "770686e91ff9328d", "9d00cb9539aed995", "b8dfaabd6941bd43",
    ),
    "K2 pass 1 (33, 300)": (
        "dd6a5cc22fe83d1b", "40716ec0e35534a3", "9d00cb9539aed995",
        "b8dfaabd6941bd43",
    ),
    "K3 (33, 300)": ("b247989147042bb7",),
    "K1 unity_plus (224, 498)": ("8a74c54687f6af45",),
    "K1 chain (224, 498)": ("e3c64c29afe8bd0d",),
    "K1 bf16 (224, 498)": ("d69b95a90eeead72",),
    "K1 pass 1 (224, 498)": ("3929bbd53694c3f9",),
    "K1 bf16 split (224, 498)": ("3d5dba2018a61f25",),
    "K2 (224, 498)": (
        "cbe1e48cf39af1d5", "0e001c8dbedcdba6", "cf48f32a588276d7",
    ),
    "K2 bf16 moments (224, 498)": (
        "f35a1a43ef26ac50", "f8deba499955f39b", "808ec05c526d75ff",
    ),
    "K2 bf16 (224, 498)": (
        "342c3c5e49a295b1", "62db87fa5c09cf69", "d624357ffd21264b",
    ),
    "K2 device scalars (224, 498)": (
        "cbe1e48cf39af1d5", "0e001c8dbedcdba6", "cf48f32a588276d7",
    ),
    "K2 pass 1 (224, 498)": (
        "f974584740c0bf8e", "9106ca47f18038ec", "0e001c8dbedcdba6",
        "cf48f32a588276d7",
    ),
    "K3 (224, 498)": ("efc31f7eb0356c8e",),
}


def test_very_wide_columns_keep_their_bits(dev):
    """The very-wide tier's per-column outputs (S', M', V', x and the
    step, gS) at (425, 32, 1000), (128, 64, 500), (600, 8, 129),
    (128, 96, 500), (64, 160, 300), (64, 256, 300), (224, 240, 300),
    (33, 300, 129) and (224, 498, 300), every mode, store and moment type,
    hash to the digests of the first very-wide body: the redesigns change
    no column's bits (gA, the Gram, the row sums and the statistics may sum
    in another order)."""
    got = {}
    for name, (fn, idx) in _vwide_bit_cases(dev).items():
        out = fn()
        got[name] = [_digest(out[i]) for i in idx]
    torch.cuda.synchronize()
    assert got == {k: list(v) for k, v in _VWIDE_BITS.items()}


# K1-K3 on the very-wide tier (C > 256 or K > 32): the shapes at which
# tests/test_torch_kernel_modes.py holds the plain versions against the JAX
# kernels, across the bounds C = 256 and K = 32, the component blocks of 8
# and 16 (K = 3, 8, 12; K = 20 in a block of 32), past K = 32 the
# instances of 64, 128 and 256 components (K = 33, 64, 65, 96, 128, 129,
# 160, 192, 256), past K = 256 K1's and K3's panel body up to K = 512 (K =
# 257, 300, 512; K2 the body of blocks of 32) and the body of blocks of 32
# past it (K = 513), with ragged N around a thread's 4 columns and the
# sub-tiles of 64, 128 and 256
_VWIDE_SHAPES = [(257, 3, 300), (300, 33, 257), (425, 32, 1000),
                 (64, 33, 4097), (17, 64, 255), (128, 64, 500),
                 (600, 8, 129), (300, 12, 257), (257, 20, 300),
                 (64, 96, 300), (300, 65, 257), (33, 128, 129),
                 (33, 129, 129), (64, 160, 300), (33, 192, 129),
                 (17, 256, 65), (33, 257, 129), (33, 300, 129),
                 (17, 512, 65), (17, 513, 65)]
_VWIDE_CASES = ("zero", "soft_plus_abs", "unity_plus", "chain",
                "split_closure")


def _vwide_prox(case, K):
    """_PROX_CASES[case], but past K = 64 the chain's threshold is 0.5 / K:
    its simplex leaves every entry near 1 / K, and a threshold of 0.05 would
    zero whole columns, whose second simplex divides 0 by 0 (the plain
    version's S' all NaN at (33, 128, 129))."""
    return _chain(0.5 / K) if case == "chain" and K > 64 else _PROX_CASES[case]


@pytest.mark.parametrize("C,K,N", _VWIDE_SHAPES)
@pytest.mark.parametrize("case", _VWIDE_CASES)
@pytest.mark.parametrize("weighted", [False, True])
def test_very_wide_k1_matches_plain_version(dev, C, K, N, case, weighted):
    A, S, Y, W = _problem(dev, C, K, N, weighted)
    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    prox = _vwide_prox(case, K)
    routes = dict(k1.fused_nmf_pgm_step.route_launches)
    got = _twice(lambda: k1.fused_nmf_pgm_step(A, S, Y, sS, W=W,
                                               prox_S=prox))
    ref = k1.fused_nmf_pgm_step_reference(A, S, Y, sS, W=W, prox_S=prox)
    torch.cuda.synchronize()
    _assert_step_close(got, ref)
    ran = {r: n - routes[r]
           for r, n in k1.fused_nmf_pgm_step.route_launches.items()}
    want = ({"split pass 1": 2, "split pass 2": 2}
            if k1.describe_prox(prox).split else {"very wide": 2})
    assert {r: n for r, n in ran.items() if n} == want


@pytest.mark.parametrize("C,K,N", _VWIDE_SHAPES)
@pytest.mark.parametrize("case", ["soft_plus_abs", "split_closure"])
def test_very_wide_k1_bf16_store(dev, C, K, N, case):
    """As test_k1_bf16_store_modes, on the very-wide body."""
    A, S, Y, W = _problem(dev, C, K, N, weighted=True)
    bf = torch.bfloat16
    S, Y, W = S.to(bf), Y.to(bf), W.to(bf)
    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    prox = _PROX_CASES[case]
    got = _twice(lambda: k1.fused_nmf_pgm_step(A, S, Y, sS, W=W,
                                               prox_S=prox))
    ref = k1.fused_nmf_pgm_step_reference(A, S, Y, sS, W=W, prox_S=prox)
    torch.cuda.synchronize()
    _within_one_bf16_ulp(got[1], ref[1])
    for i in (0, 3):
        torch.testing.assert_close(got[i], ref[i], rtol=2e-4, atol=1e-5)
    Sn = got[1].float()
    dS = Sn - S.float()
    torch.testing.assert_close(got[2], Sn @ Sn.T, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(got[4], torch.sum(dS * dS), rtol=1e-3,
                               atol=1e-5)
    torch.testing.assert_close(got[5], torch.sum(Sn * Sn), rtol=2e-4,
                               atol=1e-5)


@pytest.mark.parametrize("C,K,N", _VWIDE_SHAPES)
@pytest.mark.parametrize("case", ["zero", "soft_plus_abs", "split_closure"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
def test_very_wide_k2_matches_plain_version(dev, C, K, N, case, weighted,
                                            mdt):
    A, S, M, V, Y, alpha, sc, W = _adaprox_operands(dev, C, K, N, weighted,
                                                    mdt)
    prox = k1.describe_prox(_PROX_CASES[case], "adaprox", True)
    routes = dict(k1.fused_nmf_adaprox_step.route_launches)
    got = _twice(lambda: k1.fused_nmf_adaprox_step(
        A, S, M, V, Y, alpha, sc, W=W, prox_S=prox))
    ref = k1.fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha, sc, W=W,
                                              prox_S=prox)
    torch.cuda.synchronize()
    _assert_adaprox_close(got, ref)
    ran = {r: n - routes[r]
           for r, n in k1.fused_nmf_adaprox_step.route_launches.items()}
    want = ({"split pass 1": 2, "split pass 2": 2} if prox.split
            else {"very wide": 2})
    assert {r: n for r, n in ran.items() if n} == want


@pytest.mark.parametrize("C,K,N", _VWIDE_SHAPES)
@pytest.mark.parametrize("case", ["soft_plus_abs", "split_closure"])
def test_very_wide_k2_bf16_store(dev, C, K, N, case):
    """As test_k2_wide_bf16_store, on the very-wide body; and the
    device-scalar entry gives the by-value entry's bits."""
    A, S, M, V, Y, alpha, sc, W = _adaprox_operands(dev, C, K, N, True,
                                                    torch.bfloat16)
    bf = torch.bfloat16
    S, Y, W = S.to(bf), Y.to(bf), W.to(bf)
    prox = k1.describe_prox(_PROX_CASES[case], "adaprox", True)
    got = _twice(lambda: k1.fused_nmf_adaprox_step(
        A, S, M, V, Y, alpha, sc, W=W, prox_S=prox))
    ref = k1.fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha, sc, W=W,
                                              prox_S=prox)
    dsc = torch.tensor([float(v) for v in sc], dtype=torch.float32,
                       device=dev)
    before = k1.fused_nmf_adaprox_step.device_scalar_launches
    on_card = k1.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, dsc, W=W,
                                        prox_S=prox)
    torch.cuda.synchronize()
    assert k1.fused_nmf_adaprox_step.device_scalar_launches == before + 1
    for a, b in zip(on_card, got):
        assert torch.equal(_bits(a), _bits(b))
    for i in (1, 2, 3):
        _within_one_bf16_ulp(got[i], ref[i])
    for i in (0, 5):
        torch.testing.assert_close(got[i], ref[i], rtol=2e-4, atol=1e-5)
    Sn = got[1].float()
    torch.testing.assert_close(got[4], Sn.sum(1, keepdim=True), rtol=2e-4,
                               atol=1e-5)


@pytest.mark.parametrize("C,K,N", _VWIDE_SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_very_wide_k3_matches_plain_version(dev, C, K, N, weighted):
    A, S, Y, W = _problem(dev, C, K, N, weighted)
    before = dict(k1.fused_nmf_grad.route_launches)
    got = _twice(lambda: tops.fused_nmf_grad(A, S, Y, W=W))
    ref = tops.fused_nmf_grad_reference(A, S, Y, W=W)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-5)
    assert (k1.fused_nmf_grad.route_launches["very wide"]
            == before["very wide"] + 2)


def _residual_kernels(names):
    """(kernel, its first template argument) of the K1-K3 kernels of the
    kwide, vwide, panel and post bodies among a trace's kernel names
    (demangled or mangled), in launch order."""
    import re

    out = []
    for n in names:
        m = re.search(r"(pgm|adaprox|nmf_grad)_([kv]wide|post|panel)_kernel"
                      r"(?:<|ILi)?(\d+)?", n)
        if m:
            kb = int(m.group(3)) if m.group(2) == "kwide" else None
            out.append((f"{m.group(1)}_{m.group(2)}_kernel", kb))
    return out


@pytest.mark.parametrize("C,K,N,body,k2_body", [
    (64, 160, 300, "kwide", "kwide"), (64, 256, 300, "kwide", "kwide"),
    (33, 257, 129, "panel", "vwide"), (33, 300, 129, "panel", "vwide"),
    (17, 512, 65, "panel", "vwide"), (17, 513, 65, "vwide", "vwide")])
def test_residual_passes_past_k128_take_their_body(dev, tmp_path, C, K, N,
                                                   body, k2_body):
    """Past K = 128 the passes with a residual (K1's and K2's compiled
    chains, K2's device-scalar entry, both split passes 1, K3) launch
    kwide_pass.cuh's instance of 256 components up to K = 256; past it K1's
    and K3's launch panel_pass.cuh's column pass up to K = 512 and K2's
    vwide_pass.cuh's body, as every kernel's past 512; the second passes
    launch post_pass.cuh's: the route counts, and the kernels of a profiler
    trace of each call."""
    A, S, Y, W = _problem(dev, C, K, N, weighted=True)
    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    _, _, M, V, _, alpha, sc, _ = _adaprox_operands(dev, C, K, N, True)
    dsc = torch.tensor([float(v) for v in sc], dtype=torch.float32,
                       device=dev)
    l1 = k1.describe_prox(_PROX_CASES["soft_plus_abs"], "adaprox", True)
    clo = _PROX_CASES["split_closure"]
    pgm, ada, grad = (k1.fused_nmf_pgm_step, k1.fused_nmf_adaprox_step,
                      k1.fused_nmf_grad)
    one = {"very wide": 1}
    split = {"split pass 1": 1, "split pass 2": 1}
    calls = (
        (pgm, one, ["pgm"], lambda: pgm(
            A, S, Y, sS, W=W, prox_S=_PROX_CASES["unity_plus"])),
        (pgm, split, ["pgm", "pgm post"], lambda: pgm(
            A, S, Y, sS, W=W, prox_S=clo)),
        (ada, one, ["adaprox"], lambda: ada(
            A, S, M, V, Y, alpha, sc, W=W, prox_S=l1)),
        (ada, one, ["adaprox"], lambda: ada(
            A, S, M, V, Y, alpha, dsc, W=W, prox_S=l1)),
        (ada, split, ["adaprox", "adaprox post"], lambda: ada(
            A, S, M, V, Y, alpha, sc, W=W, prox_S=k1.describe_prox(
                clo, "adaprox", True))),
        (grad, one, ["nmf_grad"], lambda: tops.fused_nmf_grad(A, S, Y,
                                                               W=W)),
    )
    for counter, routes, kernels, fn in calls:
        fn()  # built and warm
        before = dict(counter.route_launches)
        names = _kernels_in(fn, tmp_path / "t.json")
        ran = {r: n - before[r] for r, n in counter.route_launches.items()
               if n != before[r]}
        on = k2_body if counter is ada else body
        want = [(f"{k.replace(' ', '_')}_kernel", None) if " " in k
                else (f"{k}_{on}_kernel", 256 if on == "kwide" else None)
                for k in kernels]
        assert ran == routes, (kernels, ran)
        assert _residual_kernels(names) == want, names


def _offset(t, by):
    """A contiguous copy of t whose storage starts `by` elements into a
    buffer: rows no longer 16-byte aligned."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    out = buf[by:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("K", [33, 64, 65, 128, 129, 160, 240, 256, 257,
                               300])
@pytest.mark.parametrize("N", [1, 255, 4097])
@pytest.mark.parametrize("tile_n", [4096, 1000])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_second_pass_matches_plain_version(dev, kernel, store, tile_n, N,
                                           K):
    """Split pass 2 past K = 32 (post_pass.cuh: K1's Gram of tile pairs,
    K2's streaming row sums) alone on random P: S' is P's bits (the
    bfloat16 store: P.to(bfloat16)'s), K1's Gram is within the split tests'
    tolerance of the plain version's and exactly symmetric, K2's row sums
    and both norms within it, two launches give the same bits, and so do
    rows offset by one element (the element copies and loads instead of the
    16-byte ones)."""
    g = torch.Generator(device=dev).manual_seed(10_000 * K + N)
    S = torch.rand((K, N), generator=g, device=dev).to(store)
    P = 0.5 * torch.randn((K, N), generator=g, device=dev) + 0.2
    if kernel == "K1":
        run, plain = k1._pgm_pass2_cuda, k1._pgm_pass2_reference
        counter = k1.fused_nmf_pgm_step
    else:
        run, plain = k1._adaprox_pass2_cuda, k1._adaprox_pass2_reference
        counter = k1.fused_nmf_adaprox_step
    before = counter.route_launches["split pass 2"]
    got = run(S, P, tile_n)
    again = run(S, P, tile_n)
    moved = run(_offset(S, 1), _offset(P, 1), tile_n)
    ref = plain(S, P, store)
    torch.cuda.synchronize()
    assert counter.route_launches["split pass 2"] == before + 3

    def outs(r):
        return r[0], r[1], r[2][1:]

    assert torch.equal(_bits(got[0]), _bits(P.to(store)))
    for a, b in zip(outs(got), outs(again)):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(outs(got), outs(moved)):
        assert torch.equal(_bits(a), _bits(b))
    if kernel == "K1":
        assert torch.equal(got[1], got[1].T)
    torch.testing.assert_close(got[1], ref[1], rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(got[2][1], ref[2], rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(got[2][2], ref[3], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("C,K,N,tile_n", [(300, 33, 4097, 1000),
                                          (425, 32, 1001, 333),
                                          (64, 40, 2048, 300)])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_very_wide_copy_paths_give_the_same_bits(dev, C, K, N, tile_n,
                                                 store):
    """Ragged N, a tile_n that starts groups off 16 bytes and operands at
    an odd offset take the element copies and W's one-by-one loads instead
    of the 16-byte ones: the same bits, and the plain version's values."""
    A, S, Y, W = _problem(dev, C, K, N, weighted=True)
    S, Y, W = S.to(store), Y.to(store), W.to(store)
    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    prox = _PROX_CASES["unity_plus"]
    want = k1.fused_nmf_pgm_step(A, S, Y, sS, W=W, prox_S=prox,
                                 tile_n=tile_n)
    So, Yo, Wo = (_offset(t, 1) for t in (S, Y, W))
    got = k1.fused_nmf_pgm_step(A, So, Yo, sS, W=Wo, prox_S=prox,
                                tile_n=tile_n)
    g_want = tops.fused_nmf_grad(A, S.float(), Y.float(), W=W.float(),
                                 tile_n=tile_n)
    g_got = tops.fused_nmf_grad(A, _offset(S.float(), 1),
                                _offset(Y.float(), 3), W=_offset(W.float(), 2),
                                tile_n=tile_n)
    torch.cuda.synchronize()
    for a, b in zip(got + g_got, want + g_want):
        assert torch.equal(_bits(a), _bits(b))
    if store == torch.float32:
        _assert_step_close(got, k1.fused_nmf_pgm_step_reference(
            A, S, Y, sS, W=W, prox_S=prox))


def test_very_wide_split_passes_equal_their_ops(dev):
    """The registered ops of the chain and of the split passes launch the
    very-wide body, bit for bit with the wrappers."""
    A, S, Y, W = _problem(dev, 300, 33, 3000, weighted=True)
    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    ops = torch.ops.proxmin_torch
    for case in ("chain", "split_closure"):
        prox = k1.describe_prox(_PROX_CASES[case])
        want = k1.fused_nmf_pgm_step(A, S, Y, sS, W=W, prox_S=prox)
        if prox.split:
            X, gA, loss = ops.fused_nmf_pgm_pass1(A, S, Y, sS, W, 4096)
            P = prox(X, sS).to(torch.float32)
            S_new, SSt, norms = ops.fused_nmf_pgm_pass2(S, P, 4096)
            got = (gA, S_new, SSt, loss, norms[0], norms[1])
        else:
            gA, S_new, SSt, st = ops.fused_nmf_pgm_step(
                A, S, Y, sS, W, *prox.op_args(), 4096)
            got = (gA, S_new, SSt, st[0], st[1], st[2])
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))
    got = ops.fused_nmf_grad(A, S, Y, W, 4096)
    want = tops.fused_nmf_grad(A, S, Y, W=W)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["chain", "split_closure"])
def test_modes_are_deterministic(dev, case):
    """Two launches of each wide mode and of the split path give the same
    bits (per-unit partial rows, a fixed-order finalize, no atomics)."""
    A, S, Y, W = _problem(dev, 128, 32, 300_001, weighted=True)
    prox = _PROX_CASES[case]
    for tile_n in (1000, k1.DEFAULT_TILE_N):
        one = k1.fused_nmf_pgm_step(A, S, Y, 1e-3, W=W, prox_S=prox,
                                    tile_n=tile_n)
        two = k1.fused_nmf_pgm_step(A, S, Y, 1e-3, W=W, prox_S=prox,
                                    tile_n=tile_n)
        torch.cuda.synchronize()
        for a, b in zip(one, two):
            assert torch.equal(a, b)
    A, S, M, V, Y, alpha, sc, W = _adaprox_operands(dev, 40, 12, 300_001,
                                                    True, torch.bfloat16)
    prox = k1.describe_prox(prox, "adaprox", True)
    one = k1.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc, W=W,
                                    prox_S=prox)
    two = k1.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc, W=W,
                                    prox_S=prox)
    g1 = tops.fused_nmf_grad(A, S, Y, W=W)
    g2 = tops.fused_nmf_grad(A, S, Y, W=W)
    torch.cuda.synchronize()
    for a, b in zip(one + g1, two + g2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algorithm,case", [
    ("pgm", "unity_plus"), ("pgm", "split_closure"),
    ("adaprox", "soft_plus_abs"), ("adaprox", "split_closure")])
@pytest.mark.parametrize("weighted", [False, True])
def test_wide_resume_is_bitwise(dev, algorithm, case, weighted):
    """engine='cuda' at C=128, K=32: a 10 + 15 resume equals 25 straight
    iterations bit for bit, and the solve agrees with engine='torch'."""
    C, K, N = 128, 32, 50_000
    A0, S0, _, W = _problem(dev, C, K, N, weighted=True, seed=5)
    S_true = torch.rand((K, N), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    S_true = S_true / S_true.sum(0, keepdim=True)
    Y = A0 @ S_true
    kw = dict(prox_S=_PROX_CASES[case], e_rel=0, engine="cuda",
              W=W if weighted else 1)
    if algorithm == "adaprox":
        kw.update(algorithm="adaprox", separable_prox=True)
    else:
        kw.update(step_stride=10 if weighted else None)
    full = tnmf.nmf(Y, A0, S0, max_iter=25, **kw)
    half = tnmf.nmf(Y, A0, S0, max_iter=10, **kw)
    rest = tnmf.nmf(Y, *half.x, max_iter=15, state=half.state, **kw)
    for a, b in zip(rest.x, full.x):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(x).all()) for x in full.x)


@pytest.mark.parametrize("case", ["chain", "split_closure"])
def test_split_and_chain_ops_equal_their_wrappers(dev, case):
    """The registered ops of the chain and of the split passes launch the
    wrappers' kernels, bit for bit."""
    A, S, Y, W = _problem(dev, 40, 12, 3000, weighted=True)
    sS = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    prox = k1.describe_prox(_PROX_CASES[case])
    want = k1.fused_nmf_pgm_step(A, S, Y, sS, W=W, prox_S=prox)
    ops = torch.ops.proxmin_torch
    if prox.split:
        X, gA, loss = ops.fused_nmf_pgm_pass1(A, S, Y, sS, W, 4096)
        S_new, SSt, norms = ops.fused_nmf_pgm_pass2(S, prox(X, sS), 4096)
        got = (gA, S_new, SSt, loss, norms[0], norms[1])
    else:
        gA, S_new, SSt, stats = ops.fused_nmf_pgm_step(
            A, S, Y, sS, W, *prox.op_args(), 4096)
        got = (gA, S_new, SSt, stats[0], stats[1], stats[2])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# K4: the prox kernels

_ELEMENTWISE = [("plus", {}), ("soft", {"thresh": 0.3}),
                ("soft", {"thresh": 0.3, "type": "absolute"}),
                ("hard", {"thresh": 0.3}),
                ("hard", {"thresh": 0.3, "type": "absolute"})]
_IDS = [f"{op}-{kw.get('type', 'relative')}" for op, kw in _ELEMENTWISE]


def _prox(op):
    return (getattr(tops, f"prox_{op}_pallas"),
            getattr(pk, f"prox_{op}_reference"))


def _x(dev, shape, dtype, seed=7, positive=False):
    rng = np.random.default_rng(seed)
    a = 0.1 + rng.random(shape) if positive else rng.normal(size=shape)
    return torch.tensor(a, dtype=dtype, device=dev)


@pytest.mark.parametrize("op,kw", _ELEMENTWISE, ids=_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 7), (5, 129), (13, 1000), (8, 128),
                                   (7, 1_000_000), (3, 1)])
def test_prox_kernel_equals_plain_version(dev, op, kw, dtype, shape):
    kernel, plain = _prox(op)
    X = _x(dev, shape, dtype)
    got = kernel(X, 0.5, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == X.shape
    assert got.data_ptr() != X.data_ptr()
    assert torch.equal(got, plain(X, 0.5, **kw))


@pytest.mark.parametrize("op,kw", _ELEMENTWISE, ids=_IDS)
def test_prox_kernel_unaligned_view_and_bfloat16(dev, op, kw):
    """An input at an odd offset takes the scalar path; bfloat16 computes
    in float32 and is cast back, as the plain version does."""
    kernel, plain = _prox(op)
    base = _x(dev, (7, 1001), torch.float32)
    X = base.reshape(-1)[1:1 + 7 * 1000].reshape(7, 1000)
    assert X.data_ptr() % 16 != 0
    assert torch.equal(kernel(X, 0.5, **kw), plain(X, 0.5, **kw))
    Xb = base.to(torch.bfloat16)
    got = kernel(Xb, 0.5, **kw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, plain(Xb, 0.5, **kw))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 7), (5, 129), (13, 1000), (8, 128),
                                   (7, 1_000_000), (3, 5000)])
def test_unity_kernel_matches_plain_version(dev, axis, dtype, shape):
    X = _x(dev, shape, dtype, positive=True)
    got = tops.prox_unity_pallas(X, 0.5, axis=axis)
    ref = pk.prox_unity_reference(X, 0.5, axis=axis)
    again = tops.prox_unity_pallas(X, 0.5, axis=axis)
    torch.cuda.synchronize()
    rtol = 1e-6 if dtype == torch.float32 else 1e-14
    torch.testing.assert_close(got, ref, rtol=rtol, atol=0)
    assert torch.equal(got, again)


def test_unity_kernel_zero_sum_gives_nan_and_inf(dev):
    X = torch.tensor([[0.0, 1.0, 2.0], [0.0, -1.0, 3.0]], device=dev)
    got = tops.prox_unity_pallas(X, 1.0, axis=0)
    assert bool(torch.isnan(got[:, 0]).all())
    assert bool(torch.isinf(got[:, 1]).all())
    torch.testing.assert_close(got[:, 2], torch.tensor([0.4, 0.6],
                                                       device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prox_kernels_keep_nan(dev, dtype):
    X = torch.tensor([[float("nan"), -1.0, 0.2, 2.0],
                      [0.0, float("nan"), -0.1, -3.0]], dtype=dtype,
                     device=dev)
    for op, kw in _ELEMENTWISE:
        kernel, plain = _prox(op)
        got = kernel(X, 0.5, **kw)
        assert bool(torch.isnan(got[0, 0])) and bool(torch.isnan(got[1, 1]))
        assert _same(got, plain(X, 0.5, **kw))
    # a NaN threshold: soft gives NaN everywhere, hard keeps X
    for op in ("soft", "hard"):
        kernel, plain = _prox(op)
        got = kernel(X, 1.0, thresh=float("nan"))
        assert _same(got, plain(X, 1.0, thresh=float("nan")))
        if op == "soft":
            assert bool(torch.isnan(got).all())
        else:
            assert _same(got, X)


def _same(a, b):
    """Equal, with NaN in the same places."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))


def test_prox_kernels_make_no_host_sync(dev):
    """A 0-d step on the card reaches the kernel as a device pointer: no
    call syncs with the host."""
    X = _x(dev, (7, 100_000), torch.float32)
    step = torch.tensor(0.37, device=dev)
    soft = functools.partial(tops.prox_soft_pallas, thresh=0.5)
    hard = functools.partial(tops.prox_hard_pallas, thresh=0.5)
    tops.prox_soft_pallas(X, step)  # build and load outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [soft(X, step), hard(X, step), tops.prox_plus_pallas(X, step),
                tops.prox_unity_pallas(X.abs(), step, axis=0),
                tops.prox_unity_pallas(X.abs(), step, axis=1),
                tops.fused_nmf_grad(X[:5, :7].contiguous(), X, X[:5])]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], pk.prox_soft_reference(X, step, thresh=0.5))
    assert torch.equal(outs[1], pk.prox_hard_reference(X, step, thresh=0.5))


def test_prox_kernels_are_deterministic_and_counted(dev):
    X = _x(dev, (7, 300_000), torch.float32, positive=True)
    counts = {op: _prox(op)[0].launches for op in
              ("plus", "soft", "hard", "unity")}
    one = [tops.prox_plus_pallas(X, 1.0), tops.prox_soft_pallas(X, 1.0, 0.2),
           tops.prox_hard_pallas(X, 1.0, 0.2),
           tops.prox_unity_pallas(X, 1.0, axis=1)]
    two = [tops.prox_plus_pallas(X, 1.0), tops.prox_soft_pallas(X, 1.0, 0.2),
           tops.prox_hard_pallas(X, 1.0, 0.2),
           tops.prox_unity_pallas(X, 1.0, axis=1)]
    torch.cuda.synchronize()
    for op in counts:
        assert _prox(op)[0].launches == counts[op] + 2
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    empty = torch.empty((0, 5), device=dev)
    assert tops.prox_plus_pallas(empty, 1.0).shape == (0, 5)
    assert tops.prox_plus_pallas.launches == counts["plus"] + 2


def _kernels_in(fn, path, attempts=3):
    """CUDA kernels that one call of fn runs, from a torch.profiler trace
    (kernel events only: no memcpy or memset): those between the last two
    marker kernels (torch.cuda._sleep's spin_kernel) of three launched
    around the call, two before it and one after. The profiler drops device
    events that its clock conversion places outside the capture window, so
    the markers keep a margin from the trace's start and stop, and the
    spare first marker leaves the window whole when the first device event
    is dropped (one host dropped it in every take of ten calls running). A
    trace whose last event is not a marker, or with fewer than two, is
    taken again."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            torch.cuda._sleep(1000)
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.05)
        prof.export_chrome_trace(str(path))
        events = sorted((e for e in json.loads(path.read_text())[
            "traceEvents"] if e.get("cat") == "kernel"),
            key=lambda e: e["ts"])
        names = [e["name"] for e in events]
        marks = [i for i, n in enumerate(names) if "spin_kernel" in n]
        if len(marks) >= 2 and marks[-1] == len(names) - 1:
            return names[marks[-2] + 1:marks[-1]]
    raise AssertionError(f"no trace held the markers: {names}")


@pytest.mark.parametrize("op,kw", _ELEMENTWISE + [("unity", {"axis": 0}),
                                                  ("unity", {"axis": 1})])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prox_kernel_is_one_launch(dev, tmp_path, op, kw, dtype):
    """One CUDA kernel per call with the step on the card (for unity along
    axis 1 too: the chunk sums and the divide in one cooperative launch),
    bitwise equal to the plain version for plus, soft and hard."""
    kernel, plain = _prox(op)
    X = _x(dev, (7, 100_000), dtype, positive=op == "unity")
    step = torch.tensor(0.37, device=dev)
    kernel(X, step, **kw)
    names = _kernels_in(lambda: kernel(X, step, **kw), tmp_path / "t.json")
    assert len(names) == 1, names
    if op != "unity":
        assert torch.equal(kernel(X, step, **kw), plain(X, step, **kw))


@pytest.mark.parametrize("op", ["soft", "hard"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sdt", [torch.float32, torch.float64, torch.bfloat16,
                                 torch.float16])
def test_prox_kernel_forms_the_threshold(dev, op, dtype, sdt):
    """A relative threshold from a step on the card of each dtype, and an
    absolute one from a tensor on the card, bitwise as the plain version."""
    kernel, plain = _prox(op)
    X = _x(dev, (5, 1001), dtype)
    step = torch.tensor(0.37, device=dev, dtype=sdt)
    for args, kw in (((X, step), {"thresh": 0.3}),
                     ((X, 1.0), {"thresh": step, "type": "absolute"}),
                     ((X, 0.37), {"thresh": 0.3})):
        assert torch.equal(kernel(*args, **kw), plain(*args, **kw))


def test_ops_paths_on_the_card(dev):
    """The three paths of the ops entry point for 30 iterations: each
    launches its kernels once per iteration and agrees with its
    plain-operator twin."""
    A0, S0, _, _ = _problem(dev, 5, 7, 50_000)
    Y = A0 @ torch.rand((7, 50_000), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    kw = dict(e_rel=0, max_iter=30)
    AP = top.AlternatingProjections
    pairs = (
        (AP([tops.prox_unity_pallas, tops.prox_plus_pallas]),
         top.prox_unity_plus, ("unity", "plus")),
        (AP([tops.prox_plus_pallas,
             functools.partial(tops.prox_soft_pallas, thresh=0.5)]),
         functools.partial(top.prox_soft_plus, thresh=0.5),
         ("plus", "soft")),
    )
    for prox, twin, ops in pairs:
        before = {op: _prox(op)[0].launches for op in ops}
        r = tnmf.nmf(Y, A0, S0, prox_S=prox, **kw)
        for op in ops:
            assert _prox(op)[0].launches - before[op] == r.iterations == 30
        rp = tnmf.nmf(Y, A0, S0, prox_S=twin, **kw)
        for a, b in zip(r.x, rp.x):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
    before = tops.fused_nmf_grad.launches
    rg = algorithms.pgm([A0, S0],
                        lambda A, S: tops.fused_nmf_grad(A, S, Y)[:2],
                        tnmf.step_pgm, prox=[top.prox_plus] * 2, e_rel=0,
                        max_iter=30)
    # once per iteration, and once for the final gradient pgm reports
    assert tops.fused_nmf_grad.launches - before == rg.iterations + 1 == 31
    rn = tnmf.nmf(Y, A0, S0, **kw)
    for a, b in zip(rg.x, rn.x):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)



# K1's bfloat16 store

@pytest.mark.parametrize("C,K,N", [(5, 7, 1000), (8, 4, 4133), (16, 8, 300),
                                   (1, 1, 5), (3, 2, 10000)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tile_n", [128, k1.DEFAULT_TILE_N])
def test_bf16_store_kernel_matches_plain_version(dev, C, K, N, weighted,
                                                 tile_n):
    A, S, Y, W = _problem(dev, C, K, N, weighted)
    bf = torch.bfloat16
    S, Y = S.to(bf), Y.to(bf)
    W = None if W is None else W.to(bf)
    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    got = k1.fused_nmf_pgm_step(A, S, Y, sS, W=W, tile_n=tile_n)
    ref = k1.fused_nmf_pgm_step_reference(A, S, Y, sS, W=W)
    torch.cuda.synchronize()
    _within_one_bf16_ulp(got[1], ref[1])
    for i in (0, 3):
        torch.testing.assert_close(got[i], ref[i], rtol=2e-4, atol=1e-5)
    Sn = got[1].float()
    dS = Sn - S.float()
    torch.testing.assert_close(got[2], Sn @ Sn.T, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(got[4], torch.sum(dS * dS), rtol=1e-3,
                               atol=1e-5)
    torch.testing.assert_close(got[5], torch.sum(Sn * Sn), rtol=2e-4,
                               atol=1e-5)


def _assert_k1_matches_plain(got, S, ref):
    """K1's result against its plain version: float32 as
    _assert_step_close; the bfloat16 store with S' within one bfloat16 ulp
    and the Gram and the norms against the stored S'."""
    if S.dtype != torch.bfloat16:
        _assert_step_close(got, ref)
        return
    _within_one_bf16_ulp(got[1], ref[1])
    for i in (0, 3):
        torch.testing.assert_close(got[i], ref[i], rtol=2e-4, atol=1e-5)
    Sn = got[1].float()
    dS = Sn - S.float()
    torch.testing.assert_close(got[2], Sn @ Sn.T, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(got[4], torch.sum(dS * dS), rtol=1e-3,
                               atol=1e-5)
    torch.testing.assert_close(got[5], torch.sum(Sn * Sn), rtol=2e-4,
                               atol=1e-5)


def _k1_operands(dev, C, K, N, weighted, store):
    A, S, Y, W = _problem(dev, C, K, N, weighted)
    if store == "bf16":
        S, Y = S.to(torch.bfloat16), Y.to(torch.bfloat16)
        W = None if W is None else W.to(torch.bfloat16)
    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    return A, S, Y, W, sS


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_persistent_grid(dev, store, weighted):
    """K1 over many more work units than resident blocks, with tile_n that
    is (4096) and is not (128, 1000) a multiple of the ring's sub-tile and
    of a unit's part: two launches agree bit for bit and match the plain
    version. N = 300_001 rows are not 16-byte aligned, so every stage is
    filled by per-thread copies."""
    A, S, Y, W, sS = _k1_operands(dev, 5, 7, 300_001, weighted, store)
    ref = k1.fused_nmf_pgm_step_reference(A, S, Y, sS, W=W)
    for tile_n in (128, 1000, k1.DEFAULT_TILE_N):
        one = k1.fused_nmf_pgm_step(A, S, Y, sS, W=W, tile_n=tile_n)
        two = k1.fused_nmf_pgm_step(A, S, Y, sS, W=W, tile_n=tile_n)
        torch.cuda.synchronize()
        for a, b in zip(one, two):
            assert torch.equal(a, b)
        _assert_k1_matches_plain(one, S, ref)


@pytest.mark.parametrize("weighted", [False, True])
def test_grad_kernel_persistent_grid(dev, weighted):
    """K3 as test_kernel_persistent_grid holds K1."""
    A, S, Y, W = _problem(dev, 5, 7, 300_001, weighted)
    ref = tops.fused_nmf_grad_reference(A, S, Y, W=W)
    for tile_n in (128, 1000, k1.DEFAULT_TILE_N):
        one = tops.fused_nmf_grad(A, S, Y, W=W, tile_n=tile_n)
        two = tops.fused_nmf_grad(A, S, Y, W=W, tile_n=tile_n)
        torch.cuda.synchronize()
        for a, b in zip(one, two):
            assert torch.equal(a, b)
        for g, r in zip(one, ref):
            torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-5)


# N: rows 16-byte aligned in both stores, so stages are bulk copies (and
# with tile_n = 1000 the last sub-tile of every unit is ragged); odd, so
# bfloat16 rows are not aligned either; the flagship plus 37 columns.
_RING_N = [100_000, 100_001, 1_000_037]


@pytest.mark.parametrize("N", _RING_N)
@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("tile_n", [1000, k1.DEFAULT_TILE_N])
def test_kernel_ring_fill_paths(dev, N, store, tile_n):
    """Bulk copies and the per-thread-copy fallback give results that
    match the plain version, with W."""
    A, S, Y, W, sS = _k1_operands(dev, 5, 7, N, True, store)
    got = k1.fused_nmf_pgm_step(A, S, Y, sS, W=W, tile_n=tile_n)
    ref = k1.fused_nmf_pgm_step_reference(A, S, Y, sS, W=W)
    torch.cuda.synchronize()
    _assert_k1_matches_plain(got, S, ref)


@pytest.mark.parametrize("N", _RING_N)
@pytest.mark.parametrize("tile_n", [1000, k1.DEFAULT_TILE_N])
def test_grad_kernel_ring_fill_paths(dev, N, tile_n):
    A, S, Y, W = _problem(dev, 5, 7, N, True)
    got = tops.fused_nmf_grad(A, S, Y, W=W, tile_n=tile_n)
    ref = tops.fused_nmf_grad_reference(A, S, Y, W=W)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("C,K", [(16, 8), (9, 8), (16, 1)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kernel", ["K1 f32", "K1 bf16", "K3"])
def test_wide_instance_on_the_ring(dev, C, K, weighted, kernel):
    """The C <= 16 instances (two blocks per SM, three rows a warp) at a
    size that fills the card, bulk copies and W included; two launches
    bitwise equal."""
    N = 200_000
    if kernel == "K3":
        A, S, Y, W = _problem(dev, C, K, N, weighted)
        got = tops.fused_nmf_grad(A, S, Y, W=W)
        again = tops.fused_nmf_grad(A, S, Y, W=W)
        ref = tops.fused_nmf_grad_reference(A, S, Y, W=W)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-5)
    else:
        A, S, Y, W, sS = _k1_operands(dev, C, K, N, weighted,
                                      kernel.split()[1])
        got = k1.fused_nmf_pgm_step(A, S, Y, sS, W=W)
        again = k1.fused_nmf_pgm_step(A, S, Y, sS, W=W)
        ref = k1.fused_nmf_pgm_step_reference(A, S, Y, sS, W=W)
        torch.cuda.synchronize()
        _assert_k1_matches_plain(got, S, ref)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["K1 f32", "K1 bf16", "K3"])
@pytest.mark.parametrize("N", [100_000, 100_001])
def test_nan_survives_the_ring(dev, kernel, N):
    """A NaN column of S, in a bulk-copied stage (N = 100_000) and a
    per-thread-copied one, stays NaN in S' (K1) or gS (K3), leaves its
    neighbours finite, and reaches the sums."""
    j = 54_321
    if kernel == "K3":
        A, S, Y, _ = _problem(dev, 5, 7, N)
        S[:, j] = float("nan")
        gA, col, SSt, loss = tops.fused_nmf_grad(A, S, Y)
        sums = (gA, SSt, loss)
    else:
        A, S, Y, _, _ = _k1_operands(dev, 5, 7, N, False,
                                     kernel.split()[1])
        S[:, j] = float("nan")
        gA, col, SSt, loss, dS_sq, nS_sq = k1.fused_nmf_pgm_step(A, S, Y,
                                                                 0.01)
        sums = (gA, SSt, loss, dS_sq, nS_sq)
    torch.cuda.synchronize()
    assert bool(torch.isnan(col[:, j]).all())
    assert bool(torch.isfinite(col[:, :j]).all())
    assert bool(torch.isfinite(col[:, j + 1:]).all())
    for v in sums:
        assert not bool(torch.isfinite(v).all())


def test_bf16_store_kernel_refuses_mixed_stores(dev):
    A, S, Y, _ = _problem(dev, 5, 3, 1000)
    with pytest.raises(TypeError):
        k1.fused_nmf_pgm_step(A, S.to(torch.bfloat16), Y, 0.01)
    with pytest.raises(TypeError):
        k1.fused_nmf_pgm_step(A, S.half(), Y.half(), 0.01)


# K5: packed_step

@pytest.mark.parametrize("C,K,N", [(5, 7, 1000), (8, 4, 4133), (1, 1, 5),
                                   (3, 2, 10000), (9, 9, 1000),
                                   (16, 12, 300), (300, 40, 1001)])
@pytest.mark.parametrize("layout", ["smv", "mv"])
@pytest.mark.parametrize("tile_n", [128, k1.DEFAULT_TILE_N])
def test_packed_kernel_matches_plain_version_and_k2(dev, C, K, N, layout,
                                                    tile_n):
    """Beyond C, K <= 8 (K2's wide and very-wide bodies on the packed
    arrays' row blocks) as within: K2's bits and the plain version."""
    mdt = torch.float32 if layout == "smv" else torch.bfloat16
    A, S, M, V, Y, alpha, sc, _ = _adaprox_operands(dev, C, K, N, mdt=mdt)
    if layout == "smv":
        args, kw = (A, torch.cat([S, M, V]), Y, alpha, sc), {}
    else:
        args, kw = (A, S, Y, alpha, sc), {"MV": torch.cat([M, V])}
    before = sm.packed_step.launches
    route = "packed" if C <= 8 and K <= 8 else k1.tier(C, K)
    routes = sm.packed_step.route_launches[route]
    got = sm.packed_step(*args, tile_n=tile_n, **kw)
    assert sm.packed_step.launches == before + 1
    assert sm.packed_step.route_launches[route] == routes + 1
    ref = sm.packed_step_reference(*args, **kw)
    base = k1.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc,
                                     tile_n=tile_n)
    torch.cuda.synchronize()
    if layout == "smv":
        unpack = [lambda o, i=i: o[1][i * K:(i + 1) * K] for i in range(3)]
    else:
        unpack = [lambda o: o[1], lambda o: o[2][:K], lambda o: o[2][K:]]
    parts = [(f(got), f(ref)) for f in unpack]
    g_rs, r_rs = got[-2], ref[-2]
    g_st, r_st = got[-1], ref[-1]
    want = (got[0], parts[0][0], parts[1][0], parts[2][0], g_rs, g_st[0],
            g_st[1], g_st[2])
    for a, b in zip(want, base):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[0], ref[0], rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(parts[0][0], parts[0][1], rtol=2e-4,
                               atol=1e-5)
    for g, r in parts[1:]:
        if mdt == torch.bfloat16:
            _within_one_bf16_ulp(g, r)
        else:
            torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(g_rs, r_rs, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(g_st, r_st, rtol=1e-3, atol=1e-5)


def test_packed_kernel_refuses_what_it_cannot_run(dev):
    """The wrong layouts raise; C = 9 runs (K2's wide body) as K2 does."""
    A, S, M, V, Y, alpha, sc, _ = _adaprox_operands(dev, 5, 3, 1000)
    with pytest.raises(ValueError):
        sm.packed_step(A, S, Y, alpha, sc)                  # not (3K, N)
    with pytest.raises(TypeError):
        sm.packed_step(A, S, Y, alpha, sc, MV=torch.cat([M, V]))  # f32 MV
    A9 = torch.rand((9, 3), device=dev)
    Y9 = torch.rand((9, 1000), device=dev)
    got = sm.packed_step(A9, torch.cat([S, M, V]), Y9, alpha, sc)
    base = k1.fused_nmf_adaprox_step(A9, S, M, V, Y9, alpha, sc)
    torch.cuda.synchronize()
    assert torch.equal(got[1], torch.cat(base[1:4]))
    assert torch.equal(got[0], base[0])


def test_stream_merge_loops_on_the_card(dev):
    A, S, M, V, Y, alpha, _, _ = _adaprox_operands(dev, 5, 7, 20_000)
    base, packed_smv, packed_mv = sm.build_loops()
    before = sm.packed_step.launches
    SMV = packed_smv(A, torch.cat([S, M, V]), Y, alpha, 10)
    Mb, Vb = M.to(torch.bfloat16), V.to(torch.bfloat16)
    S_p, MV = packed_mv(A, S, torch.cat([Mb, Vb]), Y, alpha, 10)
    assert sm.packed_step.launches == before + 20
    assert torch.equal(SMV, torch.cat(base(A, S, M, V, Y, alpha, 10)))
    S_b, M_b, V_b = base(A, S, Mb, Vb, Y, alpha, 10)
    assert torch.equal(S_p, S_b) and torch.equal(MV, torch.cat([M_b, V_b]))


# the weighted and strided cuda engines

@pytest.mark.parametrize("policy,weighted", [
    ({"step_stride": 10}, True), ({"step_stride": 10, "step_adapt": True},
                                  True),
    ({}, True), ({"step_adapt": True}, False), ({"step_stride": 5}, False)])
def test_weighted_and_strided_engines_on_the_card(dev, policy, weighted):
    """engine='cuda' vs engine='torch' on the card, 30 iterations; one K1
    launch per iteration and no other kernel; resumed at 15 (mid-segment)
    and at 10 (a refresh boundary with stride 10 or 5) equal 30 straight."""
    A0, S0, _, W = _problem(dev, 5, 3, 20_000, weighted=True)
    Y = A0 @ torch.rand((3, 20_000), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    kw = dict(e_rel=0, W=W if weighted else 1, **policy)
    before = (k1.fused_nmf_pgm_step.launches,
              k1.fused_nmf_adaprox_step.launches, tops.fused_nmf_grad.launches)
    rc = tnmf.nmf(Y, A0, S0, max_iter=30, engine="cuda", **kw)
    assert k1.fused_nmf_pgm_step.launches - before[0] == rc.iterations == 30
    assert (k1.fused_nmf_adaprox_step.launches,
            tops.fused_nmf_grad.launches) == before[1:]
    rt = tnmf.nmf(Y, A0, S0, max_iter=30, engine="torch", **kw)
    for a, b in zip(rc.x, rt.x):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
    for split in (15, 10):
        half = tnmf.nmf(Y, A0, S0, max_iter=split, engine="cuda", **kw)
        rest = tnmf.nmf(Y, *half.x, max_iter=30 - split, engine="cuda",
                        state=half.state, **kw)
        for a, b in zip(rest.x, rc.x):
            assert torch.equal(a, b)


def test_bf16_store_engine_on_the_card(dev):
    """The weighted adaptive solve with the bfloat16 store: the weighted
    loss within the JAX suite's rule of the float32 solve's, and a 15 + 15
    resume equal to 30 straight."""
    A0, S0, _, W = _problem(dev, 5, 3, 20_000, weighted=True)
    Y = A0 @ torch.rand((3, 20_000), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    kw = dict(e_rel=0, W=W, step_stride=10, step_adapt=True, engine="cuda")
    r32 = tnmf.nmf(Y, A0, S0, max_iter=30, **kw)
    r16 = tnmf.nmf(Y, A0, S0, max_iter=30, store_dtype=torch.bfloat16, **kw)

    def wloss(r):
        R = r.x[0] @ r.x[1] - Y
        return float(0.5 * torch.sum(W * R * R))

    assert r16.x[1].dtype == torch.float32
    assert wloss(r16) < max(3 * wloss(r32), wloss(r32) + 1.0)
    half = tnmf.nmf(Y, A0, S0, max_iter=15, store_dtype=torch.bfloat16,
                    **kw)
    rest = tnmf.nmf(Y, *half.x, max_iter=15, store_dtype=torch.bfloat16,
                    state=half.state, **kw)
    for a, b in zip(rest.x, r16.x):
        assert torch.equal(a, b)


def test_numpy_inputs_go_to_the_card(dev):
    A0, S0, Y, _ = (None if a is None else a.cpu().numpy()
                    for a in _problem(dev, 5, 3, 2000))
    r = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=3)
    assert r.x[1].device.type == "cuda"


def _tv(dev, H=96, lam=0.4):
    """A small total-variation denoising problem on the card: the noisy
    image's prox, both difference operators and the zero start."""
    rng = np.random.default_rng(11)
    truth = np.zeros((H, H), np.float32)
    truth[H // 8: H // 2, H // 6: H // 2] = 1.0
    y = torch.from_numpy(
        truth + 0.3 * rng.standard_normal((H, H)).astype(np.float32)).to(dev)

    def dh_T(v):
        return torch.cat([-v[:, :1], v[:, :-1] - v[:, 1:], v[:, -1:]], dim=1)

    def dv_T(v):
        return torch.cat([-v[:1, :], v[:-1, :] - v[1:, :], v[-1:, :]], dim=0)

    Dh = linop.FunctionOperator(lambda x: x[:, 1:] - x[:, :-1], dh_T, (H, H),
                                norm_sq=4.0)
    Dv = linop.FunctionOperator(lambda x: x[1:, :] - x[:-1, :], dv_T, (H, H),
                                norm_sq=4.0)
    return (lambda x, s: (x + s * y) / (1.0 + s)), Dh, Dv, torch.zeros_like(y)


def test_sdmm_with_the_soft_kernel_equals_the_plain_operator(dev):
    """K4 soft as sdmm's prox_g: launched twice per iteration, and the
    iterates equal operators.prox_soft's bit for bit."""
    prox_f, Dh, Dv, x0 = _tv(dev)
    kw = dict(Ls=[Dh, Dv], e_rel=0, e_abs=0, max_iter=30)
    plain = algorithms.sdmm(x0, prox_f, 0.5, proxs_g=[functools.partial(
        top.prox_soft, thresh=0.4)] * 2, **kw)
    before = tops.prox_soft_pallas.launches
    k4 = algorithms.sdmm(x0, prox_f, 0.5, proxs_g=[functools.partial(
        tops.prox_soft_pallas, thresh=0.4)] * 2, **kw)
    assert tops.prox_soft_pallas.launches - before == 2 * 30
    assert k4.x.is_cuda and k4.iterations == 30
    assert torch.equal(k4.x, plain.x) and k4.errors == plain.errors
    assert bool(torch.isfinite(k4.x).all())


@pytest.mark.parametrize("adapt", [False, True])
def test_admm_resume_on_the_card_is_bit_exact(dev, adapt):
    prox_f, Dh, _, x0 = _tv(dev)
    kw = dict(prox_g=functools.partial(top.prox_soft, thresh=0.4), L=Dh,
              e_rel=0, e_abs=0, adapt_step=adapt)
    step = 50.0 if adapt else 0.5
    full = algorithms.admm(x0, prox_f, step, max_iter=40, **kw)
    half = algorithms.admm(x0, prox_f, step, max_iter=15, **kw)
    rest = algorithms.admm(half.x, prox_f, step, max_iter=25,
                           state=half.state, **kw)
    assert rest.iterations == 25 and rest.state["total_it"] == 40
    assert torch.equal(rest.x, full.x) and rest.errors == full.errors
    for k in ("z", "u", "r_prev"):
        assert torch.equal(rest.state[k], full.state[k])


def test_admm_family_reads_the_host_once_per_iteration(dev):
    """One blocking read per admm/sdmm iteration and per bsdmm sweep (with
    steps that need none themselves): twice the iterations add exactly that
    many synchronizing calls."""
    import warnings

    prox_f, Dh, Dv, x0 = _tv(dev)
    soft = functools.partial(top.prox_soft, thresh=0.4)

    def syncs(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(w.message) for w in caught)

    def block_prox(x, s, Xs=None, j=None):
        return prox_f(x, s)

    solves = {
        "admm": lambda n: algorithms.admm(x0, prox_f, 0.5, prox_g=soft, L=Dh,
                                          e_rel=0, e_abs=0, max_iter=n),
        "sdmm": lambda n: algorithms.sdmm(x0, prox_f, 0.5, proxs_g=[soft] * 2,
                                          Ls=[Dh, Dv], e_rel=0, e_abs=0,
                                          max_iter=n),
        "bsdmm": lambda n: algorithms.bsdmm(
            [x0, x0], block_prox, lambda Xs, j=None: 0.5,
            proxs_g=[[soft], None], Ls=[[Dh], None], e_rel=0, max_iter=n),
    }
    for name, solve in solves.items():
        solve(2)
        lo, hi = syncs(lambda: solve(10)), syncs(lambda: solve(20))
        assert lo >= 10, (name, lo)
        assert hi - lo == 10, (name, lo, hi)


def test_admm_family_numpy_inputs_go_to_the_card(dev):
    """NumPy blocks and a NumPy or scipy operator, with no device=."""
    import scipy.sparse as sp

    n = 12
    y = np.cumsum(np.random.default_rng(3).normal(size=n))
    D = np.eye(n)[1:] - np.eye(n)[:-1]
    yt = torch.from_numpy(y).to(dev)

    def prox_f(x, s):
        return (x + s * yt) / (1.0 + s)

    soft = functools.partial(top.prox_soft, thresh=0.5)
    for L in (D, sp.csr_matrix(D)):
        res = algorithms.admm(y.copy(), prox_f, 0.5, prox_g=soft, L=L,
                              max_iter=5)
        assert res.x.is_cuda and res.x.dtype == torch.float64
    res = algorithms.sdmm(y.copy(), prox_f, 0.5, proxs_g=[soft, top.prox_plus],
                          Ls=[D, None], max_iter=5)
    assert res.x.is_cuda
    res = algorithms.bsdmm([y.copy()], lambda x, s, Xs=None, j=None:
                           prox_f(x, s), lambda Xs, j=None: 0.5,
                           proxs_g=[[soft]], Ls=[[D]], max_iter=5)
    assert res.x[0].is_cuda
    assert linop.MatrixOperator(D).L.is_cuda
    assert linop.SparseOperator(sp.csr_matrix(D)).L.is_cuda


@pytest.mark.parametrize("policy", [{}, {"step_stride": 4},
                                    {"step_stride": 4, "step_adapt": True}])
def test_nmf_bsdmm_on_the_card(dev, policy):
    """nmf(algorithm="bsdmm") weighted on the card: the loss falls and a
    resumed solve equals the straight one bit for bit."""
    A, S, Y, W = _problem(dev, 5, 3, 2000, weighted=True)
    Y = A @ S + 0.01
    rng = np.random.default_rng(7)
    A0, S0 = (torch.tensor(rng.random(tuple(t.shape)), dtype=torch.float32,
                           device=dev) for t in (A, S))
    kw = dict(W=W, algorithm="bsdmm", e_rel=0, **policy)
    full = tnmf.nmf(Y, A0, S0, max_iter=20, **kw)
    half = tnmf.nmf(Y, A0, S0, max_iter=8, **kw)
    rest = tnmf.nmf(Y, *half.x, max_iter=12, state=half.state, **kw)
    assert rest.state["it"] == 20
    for a, b in zip(rest.x, full.x):
        assert a.is_cuda and torch.equal(a, b)
    loss = lambda A_, S_: float(tnmf.log_likelihood(A_, S_, Y=Y, W=W))  # noqa
    assert np.isfinite(loss(*full.x)) and loss(*full.x) < loss(A0, S0)


def _syncs(fn):
    """Synchronizing CUDA calls (blocking host reads) that ``fn`` makes."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def _reads_per_10(solve):
    """Blocking reads that 10 more iterations of ``solve(n)`` add. The
    first counted call of a process was seen to show one stray wait, so one
    is counted and dropped first."""
    _syncs(lambda: solve(10))
    return _syncs(lambda: solve(20)) - _syncs(lambda: solve(10))


def _nmf_pgm_problem(dev, N=3000):
    A, S, Y, _ = _problem(dev, 5, 3, N)
    Y = A @ S + 0.01
    rng = np.random.default_rng(7)
    A0, S0 = (torch.tensor(rng.random(tuple(t.shape)), dtype=torch.float32,
                           device=dev) for t in (A, S))
    return Y, A0, S0


@pytest.mark.parametrize("algorithm", ["pgm", "adaprox"])
@pytest.mark.parametrize("case", ["unity_plus", "soft_plus_abs",
                                  "split_closure"])
@pytest.mark.parametrize("C,K", [(5, 3), (40, 12)])
def test_prox_modes_add_no_blocking_read(dev, algorithm, case, C, K):
    """A compiled chain and the split path read the host as often as the
    kernels' builtin non-negativity: the split path adds launches and no
    read."""
    A0, S0, Y, _ = _problem(dev, C, K, 3000, seed=9)
    Y = Y + A0 @ S0
    kw = dict(e_rel=0, engine="cuda")
    if algorithm == "adaprox":
        kw.update(algorithm="adaprox", separable_prox=True)

    def solve(prox):
        return lambda n: tnmf.nmf(Y, A0, S0, prox_S=prox, max_iter=n, **kw)

    base = _reads_per_10(solve(top.prox_plus))
    assert _reads_per_10(solve(_PROX_CASES[case])) == base


@pytest.mark.parametrize("option", ["none", "callback", "trace",
                                    "callback and trace", "grad=None"])
def test_callback_and_trace_add_no_blocking_read(dev, option):
    """pgm with constant steps reads the host once per iteration (the stop
    flags); a callback that does not look at its tensors, a trace and the
    autodiff gradient add none."""
    from proxmin_tpu_torch import utils as tu

    Y, A0, S0 = _nmf_pgm_problem(dev)
    kw = {}
    if "callback" in option:
        kw["callback"] = tu.NullCallback()
    if "trace" in option:
        kw["trace"] = True
    grad = functools.partial(tnmf.grad_likelihood, Y=Y)
    if option == "grad=None":
        grad, kw["f"] = None, functools.partial(tnmf.log_likelihood, Y=Y)

    def solve(n):
        return algorithms.pgm([A0, S0], grad, (1e-5, 1e-3),
                              prox=[top.prox_plus] * 2, e_rel=0, max_iter=n,
                              **kw)

    assert _reads_per_10(solve) == 10, option
    res = solve(6)
    assert res.iterations == 6 and res.x[1].is_cuda
    if "trace" in option:
        assert res.history.shape == (6, 2)


def test_adaprox_callback_and_trace_add_no_blocking_read(dev):
    from proxmin_tpu_torch import utils as tu

    Y, A0, S0 = _nmf_pgm_problem(dev)

    def solve(n, **kw):
        return tnmf.nmf(Y, A0, S0, algorithm="adaprox", e_rel=0, max_iter=n,
                        separable_prox="auto", **kw)

    assert _reads_per_10(solve) == 10
    assert _reads_per_10(functools.partial(
        solve, callback=tu.NullCallback(), trace=True)) == 10
    # the fused engine too reads the host once per iteration
    assert _reads_per_10(lambda n: tnmf.nmf(
        Y, A0, S0, algorithm="adaprox", engine="cuda", e_rel=0,
        max_iter=n)) == 10


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_backtracking_blocking_reads(dev, n_blocks):
    """An iteration without a halving reads the host once; h halvings add
    h reads, and with several blocks one more for the block to halve."""
    c = torch.tensor([1.0, 0.5], device=dev)

    def f(*X):
        return sum(0.5 * torch.sum((x - c) ** 2) for x in X)

    def grad(*X):
        return tuple(x - c for x in X)

    x0 = [torch.tensor([-1.0, -1.0], device=dev) for _ in range(n_blocks)]

    def solve(n, step, state=None, x=None):
        return algorithms.pgm(x or x0, grad, step, backtracking=True, f=f,
                              e_rel=0, max_iter=n, state=state)


    ok = 0.5
    long = 6.0 if n_blocks == 1 else (6.0, 0.5)
    # steps that need no halving
    assert _reads_per_10(lambda n: solve(n, ok)) == 10
    # the first block's step 6 times too long: the first iteration halves
    # it 3 times (to 0.75 of the Lipschitz step), the later ones never
    first = solve(1, long)
    assert first.state["T"].tolist() == [0.125, 1.0][:n_blocks]
    one = _syncs(lambda: solve(1, long)) - _syncs(lambda: solve(0, long))
    assert one == 1 + 3 + (1 if n_blocks > 1 else 0)
    later = (_syncs(lambda: solve(11, long, first.state, list(first.x)))
             - _syncs(lambda: solve(1, long, first.state, list(first.x))))
    assert later == 10


def test_backtracking_argmax_on_a_zero_block(dev):
    """max|S G| / max|x| is inf or NaN for a block at zero: the card's
    argmax picks the block the CPU's does."""
    for rel in ([1.0, np.inf], [np.nan, np.inf], [np.inf, np.nan],
                [np.inf, np.inf], [np.nan, np.nan], [0.0, np.nan, 5.0]):
        t = torch.tensor(rel)
        assert int(torch.argmax(t.to(dev))) == int(torch.argmax(t))


def test_traceback_copies_every_block_to_the_host(dev):
    from proxmin_tpu_torch import utils as tu

    Y, A0, S0 = _nmf_pgm_problem(dev)
    tb = tu.Traceback()
    res = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=5, callback=tb)
    assert len(tb.trace) == 5
    assert all(type(b) is np.ndarray for b in tb.trace[0])
    np.testing.assert_array_equal(tb.trace[0][1], S0.cpu().numpy())
    rest = tnmf.nmf(Y, *res.x, e_rel=0, max_iter=1, state=res.state,
                    callback=tb)
    np.testing.assert_array_equal(tb.trace[5][1], res.x[1].cpu().numpy())
    assert rest.iterations == 1


@pytest.mark.parametrize("case", ["pgm cuda weighted adaptive bf16 store",
                                  "adaprox cuda bf16 store and moments",
                                  "torch fista backtracking",
                                  "bsdmm weighted adaptive"])
def test_checkpoint_from_the_card_to_the_cpu_and_back(dev, tmp_path, case):
    """A checkpoint written on the card loads on ``device="cpu"`` with equal
    bits, goes back through a second file onto the card, and the resumed
    solve equals the straight one bit for bit."""
    from proxmin_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    A, S, Y, W = _problem(dev, 5, 3, 3000, weighted=True)
    Y = A @ S + 0.01
    rng = np.random.default_rng(7)
    A0, S0 = (torch.tensor(rng.random(tuple(t.shape)), dtype=torch.float32,
                           device=dev) for t in (A, S))
    kw = {
        "pgm cuda weighted adaptive bf16 store": dict(
            W=W, engine="cuda", step_stride=4, step_adapt=True,
            store_dtype="bfloat16", tile_n=1024),
        "adaprox cuda bf16 store and moments": dict(
            algorithm="adaprox", engine="cuda", store_dtype="bfloat16",
            moment_dtype="bfloat16", tile_n=1024),
        "torch fista backtracking": dict(
            accelerated=True, backtracking=True,
            f=functools.partial(tnmf.log_likelihood, Y=Y),
            step=lambda *X, it=None: tuple(
                6 * s for s in tnmf.step_pgm(*X))),
        "bsdmm weighted adaptive": dict(
            W=W, algorithm="bsdmm", step_stride=4, step_adapt=True),
    }[case]
    full = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=20, **kw)
    half = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=8, **kw)
    p1 = save_checkpoint(str(tmp_path / "card"), x=half.x,
                         solver_state=half.state)
    on_cpu = load_checkpoint(p1, device="cpu")

    def leaves(tree):
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (tuple, list)):
            return [v for t in tree for v in leaves(t)]
        return [tree]

    flat_card, flat_cpu = leaves(half.state), leaves(on_cpu["solver_state"])
    assert len(flat_card) == len(flat_cpu)
    n_tensors = 0
    for a, b in zip(flat_card, flat_cpu):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            n_tensors += 1
            assert a.is_cuda and not b.is_cuda and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b)
    assert n_tensors >= 2
    p2 = save_checkpoint(str(tmp_path / "host"), **on_cpu)
    back = load_checkpoint(p2)
    assert all(t.is_cuda for t in back["x"])
    rest = tnmf.nmf(Y, *back["x"], e_rel=0, max_iter=12,
                    state=back["solver_state"], **kw)
    assert rest.iterations == 12
    for a, b in zip(rest.x, full.x):
        assert a.is_cuda and torch.equal(a, b)


# --- the functional factories on the card --------------------------------

def test_functional_factories_read_the_host_once_per_iteration(dev):
    """Outside vmap each factory runs its driver's host loop: one blocking
    read per iteration (per sweep for bsdmm), with steps that need none
    themselves; and it equals its driver bit for bit."""
    from proxmin_tpu_torch import functional as tfn

    Y, A0, S0 = _nmf_pgm_problem(dev)
    prox_f, Dh, Dv, x0 = _tv(dev)
    soft = functools.partial(top.prox_soft, thresh=0.4)

    def grad(A_, S_):
        return tnmf.grad_likelihood(A_, S_, Y=Y)

    def block_prox(x, s, Xs=None, j=None):
        return prox_f(x, s)

    factories = {
        "pgm": (lambda n: tfn.make_pgm_solver(
            grad, (1e-3, 1e-4), prox=top.prox_plus, e_rel=0,
            max_iter=n)(A0, S0)[0],
            lambda n: algorithms.pgm([A0, S0], grad, (1e-3, 1e-4),
                                     prox=top.prox_plus, e_rel=0,
                                     max_iter=n).x),
        "adaprox": (lambda n: tfn.make_adaprox_solver(
            grad, 1e-3, prox=top.prox_plus, separable_prox=True, e_rel=0,
            max_iter=n)(A0, S0)[0],
            lambda n: algorithms.adaprox([A0, S0], grad, 1e-3,
                                         prox=top.prox_plus,
                                         separable_prox=True, e_rel=0,
                                         max_iter=n).x),
        "admm": (lambda n: tfn.make_admm_solver(
            prox_f, 0.5, prox_g=soft, L=Dh, e_rel=0, max_iter=n)(x0)[0],
            lambda n: algorithms.admm(x0, prox_f, 0.5, prox_g=soft, L=Dh,
                                      e_rel=0, max_iter=n).x),
        "sdmm": (lambda n: tfn.make_sdmm_solver(
            prox_f, 0.5, [soft] * 2, Ls=[Dh, Dv], e_rel=0,
            max_iter=n)(x0)[0],
            lambda n: algorithms.sdmm(x0, prox_f, 0.5, proxs_g=[soft] * 2,
                                      Ls=[Dh, Dv], e_rel=0,
                                      max_iter=n).x),
        "bsdmm": (lambda n: tfn.make_bsdmm_solver(
            block_prox, lambda Xs, j=None: 0.5, proxs_g=[[soft], None],
            Ls=[[Dh], None], e_rel=0, max_iter=n)(x0, x0)[0],
            lambda n: algorithms.bsdmm(
                [x0, x0], block_prox, lambda Xs, j=None: 0.5,
                proxs_g=[[soft], None], Ls=[[Dh], None], e_rel=0,
                max_iter=n).x),
    }
    for name, (factory, driver) in factories.items():
        assert _reads_per_10(factory) == 10, name
        for a, b in zip(factory(15), driver(15)):
            assert a.is_cuda and torch.equal(a, b), name


def test_functional_nmf_solver_reads_once_and_batches_on_the_card(dev):
    """make_nmf_solver reads the host once per iteration outside vmap, and
    under vmap every lane equals its individual solve on the card, with
    iteration counts that differ across the weighted lanes."""
    from proxmin_tpu_torch import functional as tfn

    rng = np.random.default_rng(3)
    B, C, K, N = 6, 4, 2, 64
    t = functools.partial(torch.tensor, dtype=torch.float64, device=dev)
    Ys = t(rng.random((B, C, K)) @ rng.random((B, K, N)))
    Ws = t(0.5 + rng.random((B, C, N)))
    A0s, S0s = t(rng.random((B, C, K))), t(rng.random((B, K, N)))
    for weighted in (False, True):
        args = (A0s, S0s, Ys) + ((Ws,) if weighted else ())
        fixed = tfn.make_nmf_solver(e_rel=0, max_iter=40, weighted=weighted)
        assert _reads_per_10(
            lambda n: tfn.make_nmf_solver(e_rel=0, max_iter=n,
                                          weighted=weighted)(
                *(a[0] for a in args))) == 10
        assert int(fixed(*(a[0] for a in args))[2]) == 40
        solve = tfn.make_nmf_solver(e_rel=1e-4, max_iter=300,
                                    weighted=weighted)
        As, Ss, its, convs = torch.func.vmap(solve)(*args)
        # the weighted lanes stop between 119 and 231 iterations (the
        # unweighted ones run to the cap, as JAX's do)
        assert As.is_cuda and (len(set(its.tolist())) > 1 or not weighted)
        for b in range(B):
            Ab, Sb, itb, convb = solve(*(a[b] for a in args))
            torch.testing.assert_close(As[b], Ab, rtol=1e-10, atol=1e-12)
            torch.testing.assert_close(Ss[b], Sb, rtol=1e-10, atol=1e-12)
            assert int(its[b]) == int(itb) and bool(convs[b]) == bool(convb)


def test_lanes_controller_ends_at_the_slowest_lane(dev):
    """The lanes controller reads every lane's stop flag through
    torch._C._functorch (a private interface): on this torch it must see
    through vmap's wrappers on the card, so a batch stops at its slowest
    lane, not at max_iter, and one read serves all the lanes."""
    from proxmin_tpu_torch import functional as tfn
    from proxmin_tpu_torch.solvers.common import any_lane, under_vmap

    calls = []

    def solve_one(x0, c):
        def grad(x):
            calls.append(under_vmap())
            return x - c
        return tfn.make_pgm_solver(grad, 0.3, e_rel=1e-6, max_iter=1000)(x0)

    cs = torch.tensor([[1.0, 2.0], [0.1, 0.0], [30.0, -5.0]],
                      dtype=torch.float32, device=dev)
    # starts at different distances: the lanes stop at different iterations
    x0s = cs + torch.tensor([[1.0, 1.0], [1e-3, 0.0], [100.0, 0.0]],
                            device=dev)
    xs, its, convs, _ = torch.func.vmap(solve_one)(x0s, cs)
    assert convs.all() and len(set(its.tolist())) > 1
    assert int(its.max()) < 1000 and all(calls)
    # the body ran once per iteration of the slowest lane
    assert len(calls) == int(its.max())

    seen = []

    def probe(f):
        seen.append((under_vmap(), any_lane(f > 25), any_lane(f > 99)))
        return f

    torch.func.vmap(probe)(cs)
    assert seen == [(True, True, False)] and not under_vmap()


def test_vmapped_backtracking_reads_once_per_iteration_and_round(
        dev, monkeypatch):
    """Under torch.func.vmap backtracking's halvings run as rounds over the
    lanes, one read of every lane's test a round (the last of an iteration
    finds no lane failing): the batch reads the host once per iteration
    (the stop flags) and once per halving round, and no more, by the sync
    debug mode and by the profiler's device-to-host copies. What a solve
    reads before its loop (the carry's scalars) is the same at max_iter=1
    and drops out."""
    import gc
    import importlib

    from proxmin_tpu_torch import functional as tfn

    pgm_mod = importlib.import_module("proxmin_tpu_torch.solvers.pgm")
    rounds = [0]
    real = pgm_mod.any_lane

    def counted(flag):
        rounds[0] += 1
        return real(flag)

    monkeypatch.setattr(pgm_mod, "any_lane", counted)
    f64 = torch.float64
    # curvatures that halve step 1 zero, one, two and five times
    cs = torch.tensor([0.5, 1.5, 3.0, 20.0], dtype=f64, device=dev)
    ys = torch.linspace(-1.0, 2.0, 4 * 64, dtype=f64,
                        device=dev).reshape(4, 64)
    x0s = torch.full((4, 64), 0.1, dtype=f64, device=dev)

    def solve(n):
        def lane(x0, c, y):
            return tfn.make_pgm_solver(
                lambda x: c * (x - y), 1.0, prox=top.prox_plus,
                backtracking=True, f=lambda x: 0.5 * c * torch.sum(
                    (x - y) ** 2), e_rel=1e-8, max_iter=n)(x0)
        return torch.func.vmap(lane)(x0s, cs, ys)

    def quiet(count, fn):
        # no collection inside the count: a finalizer could read
        gc.collect()
        gc.disable()
        try:
            return count(fn)
        finally:
            gc.enable()

    solve(200)
    counts = {}
    for n in (1, 200):
        rounds[0] = 0
        reads = quiet(_syncs, lambda: solve(n))
        r_syncs = rounds[0]
        rounds[0] = 0
        copies = quiet(_dtoh_copies, lambda: solve(n))
        assert rounds[0] == r_syncs
        counts[n] = (reads, copies, r_syncs)
    x, its, conv, div = solve(200)
    it = int(its.max())
    assert bool(conv.all()) and not bool(div.any())
    assert 1 < it < 200 and len(set(its.tolist())) > 1
    (r1, c1, h1), (r, c, h) = counts[1], counts[200]
    assert h > h1 >= 6
    assert r - r1 == (it - 1) + (h - h1)
    assert c - c1 == (it - 1) + (h - h1)


# ---------------------------------------------------------------------------
# The registered ops and the exported programs (torch.export) on the card


def _op_cases(dev):
    """``{case: (op call, wrapper call returning the op's layout, inputs,
    op)}`` for every registered op."""
    A, S, Y, W = _problem(dev, 5, 7, 3000, weighted=True)
    bf = torch.bfloat16
    sS = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    M = torch.rand_like(S) * 1e-2
    V = torch.rand_like(S) * 1e-4
    al = torch.sum(S, dim=1, keepdim=True) / S.shape[1] / 10
    sc = (np.float32(0.9), np.float32(1 / (1 - 0.9 ** 3)),
          np.float32(1 / (1 - 0.999 ** 3)))
    sc_t = torch.tensor([float(v) for v in sc], device=dev)
    ops = torch.ops.proxmin_torch
    X = torch.randn(7, 3000, device=dev)

    def stats(out, k):
        return (*out[:k], torch.stack(out[k:]))

    return {
        "K1": (ops.fused_nmf_pgm_step, (A, S, Y, sS, None, [2], [0.0], 1,
                                        4096),
               lambda: stats(k1.fused_nmf_pgm_step(A, S, Y, sS), 3)),
        "K1 W bf16 store": (
            ops.fused_nmf_pgm_step,
            (A, S.to(bf), Y.to(bf), sS, W.to(bf), [], [], 1, 4096),
            lambda: stats(k1.fused_nmf_pgm_step(
                A, S.to(bf), Y.to(bf), sS, W=W.to(bf), prox_S=top.prox_id),
                3)),
        "K2": (ops.fused_nmf_adaprox_step,
               (A, S, M, V, Y, al, sc_t, None, [2], [0.0], 1, 0.999, 1e-8,
                4096),
               lambda: stats(k1.fused_nmf_adaprox_step(A, S, M, V, Y, al,
                                                       sc), 5)),
        "K2 W bf16 moments": (
            ops.fused_nmf_adaprox_step,
            (A, S, M.to(bf), V.to(bf), Y, al, sc_t, W, [2], [0.0], 1, 0.999,
             1e-8, 128),
            lambda: stats(k1.fused_nmf_adaprox_step(
                A, S, M.to(bf), V.to(bf), Y, al, sc, W=W, tile_n=128), 5)),
        "K3": (ops.fused_nmf_grad, (A, S, Y, W, 4096),
               lambda: k1.fused_nmf_grad(A, S, Y, W=W)),
        "K4 plus": (ops.prox_plus, (X,),
                    lambda: (tops.prox_plus_pallas(X, 1.0),)),
        "K4 soft": (ops.prox_soft, (X, sS, True, 0.0, 0.4),
                    lambda: (tops.prox_soft_pallas(X, sS, thresh=0.4),)),
        "K4 hard": (ops.prox_hard, (X, None, False, 1.0, 1.0),
                    lambda: (tops.prox_hard_pallas(X, 0.3, thresh=1.0,
                                                   type="absolute"),)),
        "K4 unity": (ops.prox_unity, (X.abs() + 0.1, 1),
                     lambda: (tops.prox_unity_pallas(X.abs() + 0.1, 1.0,
                                                     axis=1),)),
    }


@pytest.mark.parametrize("case", ["K1", "K1 W bf16 store", "K2",
                                  "K2 W bf16 moments", "K3", "K4 plus",
                                  "K4 soft", "K4 hard", "K4 unity"])
def test_registered_op_equals_its_wrapper_and_its_fake(dev, case):
    """Each op launches its wrapper's kernel (bit for bit, counted), and
    its fake gives the real outputs' shapes, dtypes and devices."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, wrapper = _op_cases(dev)[case]
    before = sum(f.launches for f in (k1.fused_nmf_pgm_step,
                                      k1.fused_nmf_adaprox_step,
                                      k1.fused_nmf_grad,
                                      tops.prox_plus_pallas,
                                      tops.prox_soft_pallas,
                                      tops.prox_hard_pallas,
                                      tops.prox_unity_pallas))
    got = op(*args)
    got = got if isinstance(got, tuple) else (got,)
    after = sum(f.launches for f in (k1.fused_nmf_pgm_step,
                                     k1.fused_nmf_adaprox_step,
                                     k1.fused_nmf_grad,
                                     tops.prox_plus_pallas,
                                     tops.prox_soft_pallas,
                                     tops.prox_hard_pallas,
                                     tops.prox_unity_pallas))
    assert after == before + 1
    want = wrapper()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
        fake = op(*fake_args)
    fake = fake if isinstance(fake, tuple) else (fake,)
    for f, g in zip(fake, got):
        assert (f.shape, f.dtype, f.device) == (g.shape, g.dtype, g.device)


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 7, 500])
def test_adaprox_device_scalar_entry_equals_the_by_value_entry(dev, store,
                                                               mdt, t):
    """K2 reading (b1_t, bc1, bc2) from a device buffer equals K2 taking
    them by value, bit for bit; the buffer computed on the card from a
    counter (as an exported loop does) holds the host's numbers."""
    A, S, Y, W = _problem(dev, 5, 7, 20000, weighted=True)
    S, Y, W = (a.to(store) for a in (S, Y, W))
    M = (torch.rand(S.shape, device=dev) * 1e-2).to(mdt)
    V = (torch.rand(S.shape, device=dev) * 1e-4).to(mdt)
    al = torch.sum(S.float(), dim=1, keepdim=True) / S.shape[1] / 10
    host = tnmf._bias_corrections(0.9, 0.999, t)
    dev_sc = tnmf._bias_corrections_tensor(
        tnmf._bias_decays(0.9, 0.999, dev),
        torch.tensor(t, dtype=torch.int32, device=dev))
    assert dev_sc.tolist() == [float(v) for v in host]
    by_value = k1.fused_nmf_adaprox_step(A, S, M, V, Y, al, host, W=W)
    on_card = k1.fused_nmf_adaprox_step(A, S, M, V, Y, al, dev_sc, W=W)
    for a, b in zip(by_value, on_card):
        assert torch.equal(a, b)
    assert _syncs(lambda: k1.fused_nmf_adaprox_step(A, S, M, V, Y, al,
                                                    dev_sc, W=W)) == 0


@pytest.mark.parametrize("kind,kw", [
    ("pgm", {}),
    ("pgm", {"weighted": True, "step_stride": 5, "step_adapt": True}),
    ("pgm", {"store_dtype": torch.bfloat16}),
    ("adaprox", {}),
    ("adaprox", {"weighted": True, "moment_dtype": torch.bfloat16}),
], ids=str)
def test_exported_nmf_program_equals_its_driver(dev, kind, kw):
    """A small NMF program exported on the card runs K1/K2 as registered
    ops, launched once per iteration, and ends where its driver does, bit
    for bit."""
    from proxmin_tpu_torch import export as tex

    C, K, N = 5, 7, 20000
    A, S, Y, W = _problem(dev, C, K, N, weighted=True, seed=7)
    weighted = kw.get("weighted", False)
    data = (A, S, Y) + ((W,) if weighted else ())
    if kind == "pgm":
        prog = tex.load_solver(tex.export_nmf_solver(C, K, N, e_rel=0, **kw))
        counter = k1.fused_nmf_pgm_step
        res = tnmf.nmf_pgm_fused(Y, A, S, W=W if weighted else None, e_rel=0,
                                 max_iter=30, **{k: v for k, v in kw.items()
                                                 if k != "weighted"})
    else:
        prog = tex.load_solver(tex.export_nmf_adaprox_solver(C, K, N,
                                                             e_rel=0, **kw))
        counter = k1.fused_nmf_adaprox_step
        res = tnmf.nmf_adaprox_fused(Y, A, S, W=W if weighted else None,
                                     e_rel=0, max_iter=30,
                                     moment_dtype=kw.get("moment_dtype"))
    before = counter.launches
    before_ds = k1.fused_nmf_adaprox_step.device_scalar_launches
    out = prog(*data, 30)
    torch.cuda.synchronize()
    assert counter.launches - before == 30 and int(out[2]) == 30
    # K2 runs in a program through its device-scalar entry only
    assert (k1.fused_nmf_adaprox_step.device_scalar_launches - before_ds
            == (30 if kind == "adaprox" else 0))
    assert torch.equal(out[0], res.x[0]) and torch.equal(out[1], res.x[1])
    assert float(out[5]) == res.loss


@pytest.mark.parametrize("case", ["stride 3", "relative",
                                  "weighted stride 4", "weighted adaptive"])
def test_exported_bsdmm_program_with_carried_steps(dev, case):
    """A bsdmm program whose steps carry across sweeps (the stride test a
    torch.cond and the stepper's refreshes on the host clock, the relative
    rescale a torch.where on the card) equals its driver bit for bit on
    the card after 30 sweeps, and reads the host once per sweep by the
    sync debug mode: its loop's stop test (the refresh tests read nothing;
    the captured eigensolves skip the driver's error check)."""
    from proxmin_tpu_torch import export as tex

    C, K, N = 5, 3, 3000
    A0, S0, Y, W = _problem(dev, C, K, N, weighted=True, seed=9)
    plus = (top.prox_plus, top.prox_plus)
    shapes = [(C, K), (K, N)]
    if case == "relative":
        def prox_f(Xj, step, Xs=None, j=None):
            A, S = Xs
            D = A @ S - Y
            return top.prox_plus(
                Xj - step * (D @ S.T if j == 0 else A.T @ D), step)

        def steps(Xs, j=None):
            return tnmf.step_A(*Xs) if j == 0 else tnmf.step_S(*Xs)

        sg = torch.full((), 0.5, device=dev)
        kw = dict(proxs_g=[None, [functools.partial(top.prox_unity,
                                                     axis=0)]],
                  steps_g=[None, [sg]], steps_g_update="relative", e_rel=0)

        def program(n):
            return tex.load_solver(tex.export_bsdmm_solver(
                shapes, prox_f, steps, max_iter=n, **kw))

        def driver(n):
            return algorithms.bsdmm([A0, S0], prox_f, steps, max_iter=n,
                                    **kw)
    else:
        weighted = case.startswith("weighted")
        Wc = W if weighted else 1
        prox_f = functools.partial(tnmf._bsdmm_prox_f, Y=Y, W=Wc, prox=plus)
        if weighted:
            adapt = case.endswith("adaptive")
            opts = dict(W=W, step_stride=4, step_adapt=adapt)
            ex = dict(steps_f_cb=tnmf.WeightedBSDMMStepper(W, stride=4,
                                                           adapt=adapt))
        else:
            opts = dict(step_stride=3)
            ex = dict(steps_f_cb=functools.partial(tnmf._bsdmm_step_default,
                                                   W=1), steps_f_stride=3)

        def program(n):
            return tex.load_solver(tex.export_bsdmm_solver(
                shapes, prox_f, e_rel=0, max_iter=n, **ex))

        def driver(n):
            return tnmf.nmf(Y, A0, S0, algorithm="bsdmm", e_rel=0,
                            max_iter=n, **opts)

    xs, it, _ = program(30)(A0, S0)
    res = driver(30)
    assert int(it) == res.iterations == 30
    for a, b in zip(xs, res.x):
        assert a.is_cuda and torch.equal(a, b)
    made = {n: program(n) for n in (10, 20)}
    assert _reads_per_10(lambda n: made[n](A0, S0)) == 10


@pytest.mark.parametrize("kind", ["pgm", "adaprox"])
def test_exported_split_program_counts_each_step_once(dev, kind):
    """A program whose prox_S takes the split path runs the two pass ops
    around the traced prox; each step adds one to the kernel's
    ``launches`` (at pass 1, as the eager driver counts it) and one to
    each pass's route, and the program ends where its driver does."""
    from proxmin_tpu_torch import export as tex

    C, K, N = 40, 12, 20000
    A, S, Y, _ = _problem(dev, C, K, N, seed=7)
    if kind == "pgm":
        prox = _PROX_CASES["split_closure"]
        prog = tex.load_solver(tex.export_nmf_solver(C, K, N, prox_S=prox,
                                                     e_rel=0))
        counter = k1.fused_nmf_pgm_step
        res = tnmf.nmf_pgm_fused(Y, A, S, prox_S=prox, e_rel=0, max_iter=30)
    else:
        prox = _P(top.prox_max_entropy, gamma=0.1)
        prog = tex.load_solver(tex.export_nmf_adaprox_solver(
            C, K, N, prox_S=prox, e_rel=0))
        counter = k1.fused_nmf_adaprox_step
        res = tnmf.nmf_adaprox_fused(Y, A, S, prox_S=prox, e_rel=0,
                                     max_iter=30)
    assert k1.describe_prox(prox, kind).split
    before, routes = counter.launches, dict(counter.route_launches)
    out = prog(A, S, Y, 30)
    torch.cuda.synchronize()
    ran = {r: n - routes[r] for r, n in counter.route_launches.items()}
    assert counter.launches - before == 30 and int(out[2]) == 30
    assert {r: n for r, n in ran.items() if n} == {"split pass 1": 30,
                                                   "split pass 2": 30}
    assert torch.equal(out[0], res.x[0]) and torch.equal(out[1], res.x[1])


def _dtoh_copies(fn):
    """Device-to-host copies that ``fn`` makes, counted in a
    ``torch.profiler`` trace of the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "memcpy" in e.key.lower() and "dtoh" in e.key.lower())


@pytest.mark.parametrize("kw", [{}, {"step_stride": 5},
                                {"step_stride": 5, "step_adapt": True}],
                         ids=str)
def test_program_reads_the_host_once_per_iteration(dev, kw, monkeypatch):
    """A program's loop reads the host once per iteration by the sync
    debug mode, its stop test (a fixed stride's refresh clock lives on the
    host; the captured eigensolves skip the error check that makes the
    driver read after each): the exact driver reads three times per
    iteration (the stop flags and two eigensolves), a weighted strided
    driver once plus at least once per refresh. The device-to-host copies
    in a profiler trace also show what that mode misses: the weighted
    refresh's own copy, which the driver makes too, and the adaptive
    program's copy of its grown stride to the host clock, so a weighted
    program copies once per iteration and once (fixed stride) or twice
    (adaptive) per refresh, and never more than its driver plus one per
    refresh. Counted between 10 and 60 iterations, a window that holds
    refreshes."""
    from proxmin_tpu_torch import export as tex

    C, K, N = 5, 7, 20000
    lo, hi = 10, 60
    A, S, Y, W = _problem(dev, C, K, N, weighted=True, seed=8)
    weighted = bool(kw)
    prog = tex.load_solver(tex.export_nmf_solver(C, K, N, e_rel=0,
                                                 weighted=weighted, **kw))
    data = (A, S, Y, W) if weighted else (A, S, Y)
    refreshes = []
    steps = tnmf._weighted_steps

    def counted(*args, **kwargs):
        refreshes.append(1)
        return steps(*args, **kwargs)

    def driver(n):
        return tnmf.nmf_pgm_fused(Y, A, S, W=W if weighted else None,
                                  e_rel=0, max_iter=n, **kw)

    # warm both window ends of the program and the driver, under the sync
    # debug mode too, so that no one-time wait of the process (the first
    # counted call, an allocation at the longer run) falls into one end
    for n in (lo, hi):
        _syncs(lambda n=n: prog(*data, n))
        _syncs(lambda n=n: driver(n))
    p_lo, p_hi = (_syncs(lambda n=n: prog(*data, n)) for n in (lo, hi))
    c_lo, c_hi = (_dtoh_copies(lambda n=n: prog(*data, n))
                  for n in (lo, hi))
    d_lo, d_hi = (_syncs(lambda n=n: driver(n)) for n in (lo, hi))
    e_lo, e_hi = (_dtoh_copies(lambda n=n: driver(n)) for n in (lo, hi))
    monkeypatch.setattr(tnmf, "_weighted_steps", counted)
    driver(lo)
    r_lo = len(refreshes)
    driver(hi)
    r_window = len(refreshes) - 2 * r_lo
    assert p_hi - p_lo == hi - lo
    assert c_hi - c_lo <= e_hi - e_lo + r_window
    if weighted:
        assert r_window >= 1
        per_refresh = 2 if kw.get("step_adapt") else 1
        assert c_hi - c_lo == hi - lo + per_refresh * r_window
    assert d_hi - d_lo == 3 * (hi - lo) if not weighted \
        else d_hi - d_lo >= hi - lo + r_window
