"""K5, the packed-state AdaProx step: the port's plain version against the
stream-merge experiment's Pallas kernel (benchmarks/stream_merge.py, run in
interpret mode) and against K2's plain version.

Tolerances and their reasons:
- smv (float32): rtol 1e-6 on S', M', V', gA and the row sums, with atol
  1e-7 where an element cancels to near zero: both sides compute in float32
  and sum the K- and C-axis products in other orders.
- mv (bfloat16 moments): M' and V' within one bfloat16 ulp plus 1e-5, the
  rule PR 2 set for K2's bfloat16 moments. The benchmark's own check
  (atol 1e-6) does not hold for this layout: one element of 131072
  differs by one bfloat16 ulp in [0.5, 1) at N=16384.
- the packed plain step against K2's plain step: bitwise (the same
  operations on views of the packed arrays).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxmin_tpu_torch.ops import nmf_kernels as kk
from proxmin_tpu_torch.ops import stream_merge as sm

REPO = Path(__file__).resolve().parents[1]
TILE = 128
SMV_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jsm():
    """benchmarks/stream_merge.py, loaded by path (it is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "stream_merge_benchmark", REPO / "benchmarks" / "stream_merge.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(C, K, N, seed=5):
    rng = np.random.default_rng(seed)
    A = rng.random((C, K)).astype(np.float32)
    S = rng.random((K, N)).astype(np.float32)
    Y = rng.random((C, N)).astype(np.float32)
    M = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    V = (0.01 * rng.random((K, N))).astype(np.float32)
    alpha = (0.01 + 0.01 * rng.random((K, 1))).astype(np.float32)
    one, t = np.float32(1), np.float32(3)
    scalars = (np.float32(0.9), one / (one - np.float32(0.9) ** t),
               one / (one - np.float32(0.999) ** t))
    return A, S, Y, M, V, alpha, scalars


def _pad(x, rows, cols):
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])))


def _sublanes(n):
    """n padded to the TPU kernel's sublane of 8 (the benchmark's Cp, Kp)."""
    return -(-n // 8) * 8


def _bf16_ulp_close(got, want, atol):
    _, e = np.frexp(want)
    ulp = np.maximum(np.ldexp(1.0, e - 8), 2.0 ** -133)
    assert np.all(np.abs(got - want) <= ulp + atol)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("C,K,N", [(5, 4, 300), (6, 3, 1024), (1, 1, 130),
                                   (9, 9, 1000), (16, 12, 300)])
def test_smv_plain_matches_pallas(jsm, C, K, N):
    """Within C, K <= 8 (the packed kernel on the card) and beyond (K2's
    wide body on the packed arrays' row blocks)."""
    A, S, Y, M, V, alpha, sc = _operands(C, K, N)
    Np = -(-N // TILE) * TILE
    Cp, P = _sublanes(C), _sublanes(K)
    SMV_p = np.concatenate([_pad(x, P, Np) for x in (S, M, V)])
    gA_j, SMV1_j, rs_j, st_j = jsm.packed_step(
        jnp.asarray(_pad(A, Cp, P)), jnp.asarray(SMV_p),
        jnp.asarray(_pad(Y, Cp, Np)), jnp.asarray(_pad(alpha, P, 1)),
        jnp.asarray(sc, jnp.float32), tile_n=TILE, interpret=True)
    SMV1_j = np.asarray(SMV1_j)
    At, St, Yt, Mt, Vt, alt = _t(A, S, Y, M, V, alpha)
    gA, SMV1, rs, st = sm.packed_step(At, torch.cat([St, Mt, Vt]), Yt, alt,
                                      sc)
    assert SMV1.shape == (3 * K, N) and SMV1.dtype == torch.float32
    for i in range(3):
        np.testing.assert_allclose(SMV1[i * K:(i + 1) * K].numpy(),
                                   SMV1_j[i * P:i * P + K, :N], **SMV_TOL)
    np.testing.assert_allclose(gA.numpy(), np.asarray(gA_j)[:C, :K],
                               rtol=1e-6)
    np.testing.assert_allclose(rs.numpy(), np.asarray(rs_j)[:K], rtol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=1e-5)


@pytest.mark.parametrize("C,K,N", [(5, 4, 300), (6, 3, 1024), (9, 9, 1000),
                                   (16, 12, 300)])
def test_mv_plain_matches_pallas(jsm, C, K, N):
    A, S, Y, M, V, alpha, sc = _operands(C, K, N)
    Np = -(-N // TILE) * TILE
    Cp, P = _sublanes(C), _sublanes(K)
    bf = jnp.bfloat16
    Mb, Vb = jnp.asarray(M, bf), jnp.asarray(V, bf)
    MV_p = jnp.concatenate([jnp.asarray(_pad(np.asarray(x, np.float32), P,
                                             Np), bf) for x in (Mb, Vb)])
    gA_j, S1_j, MV1_j, rs_j, st_j = jsm.packed_step(
        jnp.asarray(_pad(A, Cp, P)), jnp.asarray(_pad(S, P, Np)),
        jnp.asarray(_pad(Y, Cp, Np)), jnp.asarray(_pad(alpha, P, 1)),
        jnp.asarray(sc, jnp.float32), MV=MV_p, tile_n=TILE, interpret=True)
    MV1_j = np.asarray(MV1_j.astype(jnp.float32))
    At, St, Yt, alt = _t(A, S, Y, alpha)
    MV = torch.cat(_t(np.asarray(Mb.astype(jnp.float32)),
                      np.asarray(Vb.astype(jnp.float32)))).to(torch.bfloat16)
    gA, S1, MV1, rs, st = sm.packed_step(At, St, Yt, alt, sc, MV=MV)
    assert MV1.dtype == torch.bfloat16 and MV1.shape == (2 * K, N)
    np.testing.assert_allclose(S1.numpy(), np.asarray(S1_j)[:K, :N],
                               **SMV_TOL)
    for i in range(2):
        _bf16_ulp_close(MV1[i * K:(i + 1) * K].float().numpy(),
                        MV1_j[i * P:i * P + K, :N], 1e-5)
    np.testing.assert_allclose(gA.numpy(), np.asarray(gA_j)[:C, :K],
                               rtol=1e-6)
    np.testing.assert_allclose(rs.numpy(), np.asarray(rs_j)[:K], rtol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=1e-5)


@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,K", [(5, 4), (16, 12)])
def test_packed_plain_equals_k2_plain(mdt, C, K):
    A, S, Y, M, V, alpha, sc = _operands(C, K, 700)
    At, St, Yt, Mt, Vt, alt = _t(A, S, Y, M, V, alpha)
    Mt, Vt = Mt.to(mdt), Vt.to(mdt)
    want = kk.fused_nmf_adaprox_step(At, St, Mt, Vt, Yt, alt, sc)
    if mdt == torch.float32:
        gA, SMV1, rs, st = sm.packed_step(At, torch.cat([St, Mt, Vt]), Yt,
                                          alt, sc)
        S1, M1, V1 = SMV1[:K], SMV1[K:2 * K], SMV1[2 * K:]
    else:
        gA, S1, MV1, rs, st = sm.packed_step(At, St, Yt, alt, sc,
                                             MV=torch.cat([Mt, Vt]))
        M1, V1 = MV1[:K], MV1[K:]
    for got, w in zip((gA, S1, M1, V1, rs, st[0], st[1], st[2]), want):
        assert torch.equal(got, w)


def test_loops_run_and_agree_on_the_cpu():
    """The four loops of build_loops: the packed ones equal the base ones
    (plain versions here, so launch counts stay untouched)."""
    A, S, Y, M, V, alpha, _ = _operands(5, 4, 500)
    At, St, Yt, Mt, Vt, alt = _t(A, S, Y, M, V, alpha)
    base, packed_smv, packed_mv = sm.build_loops(tile_n=TILE)
    before = sm.packed_step.launches
    S3, M3, V3 = base(At, St, Mt, Vt, Yt, alt, 3)
    SMV3 = packed_smv(At, torch.cat([St, Mt, Vt]), Yt, alt, 3)
    assert torch.equal(SMV3, torch.cat([S3, M3, V3]))
    Mb, Vb = Mt.to(torch.bfloat16), Vt.to(torch.bfloat16)
    S3b, M3b, V3b = base(At, St, Mb, Vb, Yt, alt, 3)
    S3p, MV3 = packed_mv(At, St, torch.cat([Mb, Vb]), Yt, alt, 3)
    assert torch.equal(S3p, S3b) and torch.equal(MV3, torch.cat([M3b, V3b]))
    assert sm.packed_step.launches == before
    assert not torch.equal(S3, St)
