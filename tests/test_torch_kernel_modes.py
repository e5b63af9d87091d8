"""K1-K3's prox modes and wide shapes: the plain versions against the JAX
kernels, and the prox descriptor.

- The descriptor (``ops.nmf_kernels.describe_prox``) sends every library
  operator and keyword combination that acts on a pixel column alone to its
  compiled codes, and everything else to the split path.
- K1's, K2's and K3's plain versions (each code, the split path, the wide
  shapes C=40, K=12, N=700 and C=100, K=3, N=50, examples/unmixing.py's,
  the wide body's tile edges EDGE_SHAPES and the very-wide body's shapes
  VWIDE_SHAPES, at which tests/test_torch_cuda.py runs the kernels)
  against the Pallas kernels in
  interpret mode on the same seeded NumPy inputs, as
  tests/test_pallas_ops.py runs them on the CPU.
- ``nmf(engine="cuda", device="cpu")`` against JAX's ``engine="pallas"``
  for the proxes JAX takes there (PGM) and the separable ones (AdaProx).
- JAX's K1 applies a prox_S that couples pixels to each pixel tile
  separately (a fault of the reference, outside its documented contract);
  the port applies it to the whole S, as JAX's ``engine="xla"`` does.

Tolerances. JAX's kernels switch the residual product to the bfloat16x3
"split3" scheme once the padded C K exceeds 512
(proxmin_tpu/ops/nmf_kernels.py:55-59, :71-72); the tight cases set
``RESIDUAL_IMPL = "fma"`` (an exact float32 FMA over k, as the port's
kernels compute it) after ``jax.clear_caches()`` and hold float32 results
to rtol 1e-5 (atol 1e-6): both sides sum the pixel-axis reductions in
other orders. ||S' - S||^2 cancels (S' - S is small against S) and gets
rtol 1e-4. The "auto" case (split3 at C=40, K=12) is held to rtol 1e-4:
bfloat16x3 products lose a few float32 ulps. Whole solves compound those
differences over their iterations: rtol 1e-4 after 10 iterations.

The CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import contextlib
import functools
import types

import jax
import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu.ops.nmf_kernels as jk
import proxmin_tpu_torch as ptt
from proxmin_tpu_torch.ops import nmf_kernels as kk

RTOL, ATOL, DS_RTOL = 1e-5, 1e-6, 1e-4
AUTO_RTOL = 1e-4
SOLVE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fma(monkeypatch):
    """The JAX kernels' residual as an exact float32 FMA over k."""
    jax.clear_caches()
    monkeypatch.setattr(jk, "RESIDUAL_IMPL", "fma")
    yield
    jax.clear_caches()


def _closure(ops):
    """tests/test_pallas_ops.py:166-182's prox_S: the simplex over K."""
    def proxS(x, s):
        return ops.prox_unity_plus(x, s, axis=0)
    return proxS


P = functools.partial
# name -> prox_S made from an operators module (either package's)
PROXES = {
    "plus": lambda o: o.prox_plus,
    "id": lambda o: o.prox_id,
    "zero": lambda o: o.prox_zero,
    "min_rel": lambda o: P(o.prox_min, thresh=0.4),
    "min_abs": lambda o: P(o.prox_min, thresh=0.2, type="absolute"),
    "max_rel": lambda o: P(o.prox_max, thresh=10.0),
    "max_abs": lambda o: P(o.prox_max, thresh=0.6, type="absolute"),
    "hard_rel": lambda o: P(o.prox_hard, thresh=8.0),
    "hard_abs": lambda o: P(o.prox_hard, thresh=0.3, type="absolute"),
    "hard_plus": lambda o: P(o.prox_hard_plus, thresh=0.3, type="absolute"),
    "soft_rel": lambda o: P(o.prox_soft, thresh=4.0),
    "soft_abs": lambda o: P(o.prox_soft, thresh=0.1, type="absolute"),
    "soft_plus": lambda o: P(o.prox_soft_plus, thresh=2.0),
    "unity_plus": lambda o: P(o.prox_unity_plus, axis=0),
    "chain": lambda o: o.AlternatingProjections(
        [P(o.prox_unity_plus, axis=0), P(o.prox_soft_plus, thresh=0.05,
                                         type="absolute")], repeat=2),
    "split_closure": _closure,
}
SPLIT = {"split_closure"}
# K2 applies separable proxes only (the closed form of the scaled prox)
SEPARABLE = ("plus", "id", "zero", "min_abs", "max_abs", "soft_rel",
             "soft_plus")


# The wide body's tile edges (tests/test_torch_cuda.py runs the kernels at
# the same shapes): C around the chunk of 32 channels and the bound 256, K
# around the instances' bounds 8, 16 and 32, and N = 1, a thread's 4 columns
# +- 1, the sub-tile of 256 columns +- 1, the default tile_n 4096 +- 1;
# 16_700 in tiles of 128 on the card (131 units, a group each), 38_430 in
# tiles of 128 (301 units: groups of three where a block runs alone on an
# SM, of two where two do, the last group of one unit, partial) and 70_000
# in tiles of 1000 (units of 256, 256, 256 and 232 columns; 280 units in
# groups of three or two that hold a short unit and a tile's end inside
# them). Each with a few of PROXES' cases (EDGE_NAMES, EDGE_K2).
EDGE_SHAPES = [(17, 9, 1), (31, 17, 3), (32, 31, 5), (33, 32, 255),
               (129, 9, 257), (255, 31, 4095), (256, 32, 4097),
               (40, 12, 16_700), (40, 12, 38_430), (40, 20, 70_000)]
EDGE_NAMES = ("unity_plus", "soft_plus", "split_closure")
EDGE_K2 = ("soft_plus", "min_abs", "split_closure")
# The very-wide tier's shapes (C > 256 or K > 32; tests/test_torch_cuda.py
# runs the kernels at the same shapes): across the bounds C = 256 and
# K = 32, its component blocks of 8 and 16 (K = 3, 8, 12) and of 32 (K =
# 20, 32), past K = 32 the instances of 64, 128 and 256 components (K =
# 33, 64, 65, 96, 128: ragged blocks past 64, with 300 channels and with
# 33; K = 129, 160, 192, 256 on the instance of 256, its sub-tiles of 64
# columns ragged at N = 65 and 129), past K = 256 K1's and K3's panel body
# up to K = 512 (K = 257, 512; K2 the body of blocks of 32) and the body of
# blocks of 32 past it (K = 513), ragged N, and AVIRIS-NG's 425 channels;
# each with EDGE_NAMES' and EDGE_K2's cases.
VWIDE_SHAPES = [(257, 3, 300), (300, 33, 257), (425, 32, 1000),
                (64, 33, 4097), (17, 64, 255), (128, 64, 500),
                (600, 8, 129), (300, 12, 257), (257, 20, 300),
                (64, 96, 300), (300, 65, 257), (33, 128, 129),
                (33, 129, 129), (64, 160, 300), (33, 192, 129),
                (17, 256, 65), (33, 257, 129), (17, 512, 65), (9, 513, 33)]


def _shape_id(shape):
    return "x".join(map(str, shape))


def _problem(C, K, N, weighted=False, seed=101):
    rng = np.random.default_rng(seed)
    A = rng.random((C, K)).astype(np.float32)
    S = rng.random((K, N)).astype(np.float32)
    Y = rng.random((C, N)).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32) if weighted else None
    return A, S, Y, W


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, rtol=RTOL, ds_at=None):
    for i, (g, w) in enumerate(zip(got, want)):
        r = DS_RTOL if i == ds_at else rtol
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=r,
                                   atol=ATOL)


def _jax_k1(A, S, Y, W, sS, prox):
    C, K = A.shape
    N = S.shape[1]
    A_p, S_p, Y_p, W_p, dims, tile = jk.pad_nmf_problem(A, S, Y, W,
                                                        tile_n=256)
    out = jk.fused_nmf_pgm_step(A_p, S_p, Y_p, sS, W=W_p, prox_S=prox,
                                tile_n=tile, dims=dims)
    return (np.asarray(out[0])[:C, :K], np.asarray(out[1])[:K, :N],
            np.asarray(out[2])[:K, :K], *(float(v) for v in out[3:]))


# ---------------------------------------------------------------------------
# the descriptor

R = kk._RELATIVE
MAPPING = [
    (None, (kk._PLUS,), (0.0,), 1),
    (ptt.operators.prox_id, (), (), 1),
    (ptt.operators.prox_zero, (kk._ZERO,), (0.0,), 1),
    (ptt.operators.prox_plus, (kk._PLUS,), (0.0,), 1),
    (ptt.operators.prox_min, (kk._MIN | R,), (0.0,), 1),
    (P(ptt.operators.prox_min, thresh=0.5), (kk._MIN | R,), (0.5,), 1),
    (P(ptt.operators.prox_max, thresh=2, type="absolute"), (kk._MAX,),
     (2.0,), 1),
    (P(ptt.operators.prox_hard, thresh=0.3), (kk._HARD | R,), (0.3,), 1),
    (P(ptt.operators.prox_hard, type="absolute"), (kk._HARD,), (0.0,), 1),
    (P(ptt.operators.prox_hard_plus, thresh=0.3, type="absolute"),
     (kk._HARD, kk._PLUS), (0.3, 0.0), 1),
    (P(ptt.operators.prox_soft, thresh=True), (kk._SOFT | R,), (1.0,), 1),
    (P(ptt.operators.prox_soft_plus, thresh=0.1),
     (kk._SOFT | R, kk._PLUS), (0.1, 0.0), 1),
    (ptt.operators.prox_unity, (kk._UNITY,), (0.0,), 1),
    (P(ptt.operators.prox_unity_plus, axis=0), (kk._PLUS, kk._UNITY),
     (0.0, 0.0), 1),
    (ptt.operators.AlternatingProjections(
        [ptt.operators.prox_plus, P(ptt.operators.prox_soft, thresh=0.2)],
        repeat=3), (kk._SOFT | R, kk._PLUS), (0.2, 0.0), 3),
    (ptt.operators.AlternatingProjections(
        [ptt.operators.AlternatingProjections([ptt.operators.prox_plus],
                                              repeat=2),
         ptt.operators.prox_zero]), (kk._ZERO, kk._PLUS, kk._PLUS),
     (0.0, 0.0, 0.0), 1),
    (ptt.operators.AlternatingProjections([ptt.operators.prox_plus],
                                          repeat=0), (kk._PLUS,), (0.0,), 0),
]
SPLIT_PROXES = [
    lambda x, s: x,
    P(ptt.operators.prox_unity_plus, axis=1),
    P(ptt.operators.prox_unity, axis=-2),
    ptt.operators.prox_max_entropy,
    P(ptt.operators.prox_soft, thresh=np.float64(0.1)),
    P(ptt.operators.prox_soft, thresh=np.float32(0.1)),
    P(ptt.operators.prox_soft, thresh=torch.tensor(0.1)),
    P(ptt.operators.prox_min, thresh=np.full((3, 1), 0.1)),
    P(ptt.operators.prox_hard, thresh=0.1, type="bogus"),
    P(ptt.operators.prox_plus, unknown=1),
    P(ptt.operators.prox_soft, 0.1),
    P(ptt.operators.prox_soft, thresh=[0.1]),
    ptt.operators.AlternatingProjections([ptt.operators.prox_plus,
                                          lambda x, s: x]),
    ptt.operators.AlternatingProjections([ptt.operators.prox_plus] * 9),
    ptt.operators.AlternatingProjections([ptt.operators.prox_plus],
                                         repeat=2.0),
]


@pytest.mark.parametrize("case", range(len(MAPPING)))
def test_descriptor_maps_library_operators_to_codes(case):
    prox, ops, thresh, repeat = MAPPING[case]
    d = kk.describe_prox(prox)
    assert not d.split
    assert (d.ops, d.thresh, d.repeat) == (ops, thresh, repeat)
    assert kk.describe_prox(d) is d
    # the registered ops carry the chain and rebuild it, and the rebuilt
    # codes compute the operator itself, bit for bit
    again = kk.ProxDescriptor.from_codes(*d.op_args())
    assert (again.ops, again.thresh, again.repeat) == (ops, thresh, repeat)
    X = torch.from_numpy(np.random.default_rng(case).standard_normal(
        (5, 40)).astype(np.float32))
    step = torch.tensor(0.05)
    want = (prox or ptt.operators.prox_plus)(X, step)
    torch.testing.assert_close(again(X, step), want, rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(d(X, step), want, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("case", range(len(SPLIT_PROXES)))
def test_descriptor_sends_everything_else_to_the_split_path(case):
    prox = SPLIT_PROXES[case]
    d = kk.describe_prox(prox)
    assert d.split and d.prox is prox
    assert kk.describe_prox(prox, "adaprox", True).split


@pytest.mark.parametrize("prox,sep,split", [
    (ptt.operators.prox_plus, "auto", False),
    (P(ptt.operators.prox_soft, thresh=0.1), "auto", False),
    (P(ptt.operators.prox_soft_plus, thresh=0.1), "auto", False),
    (P(ptt.operators.prox_soft, thresh=0.1, type="absolute"), "auto", True),
    (P(ptt.operators.prox_min, thresh=0.1), "auto", True),
    (P(ptt.operators.prox_min, thresh=0.1, type="absolute"), "auto", False),
    (ptt.operators.prox_hard, "auto", True),
    (ptt.operators.prox_hard, True, False),
    (P(ptt.operators.prox_unity_plus, axis=0), "auto", True),
    (P(ptt.operators.prox_unity_plus, axis=0), True, False),
    (ptt.operators.prox_plus, False, True),
])
def test_k2_codes_only_separable_proxes(prox, sep, split):
    """K2 compiles a chain where separable_when holds, or with
    separable_prox=True, as in JAX; the split path applies the same prox
    with the same per-element step otherwise."""
    assert kk.describe_prox(prox, "adaprox", sep).split == split
    assert not kk.describe_prox(prox).split


@pytest.mark.parametrize("name", sorted(PROXES))
def test_chain_equals_its_operators(name):
    """The plain versions apply the prox itself; a registered op's codes,
    rebuilt from the chain alone, apply it bit for bit."""
    rng = np.random.default_rng(7)
    X = torch.from_numpy(rng.standard_normal((6, 50)).astype(np.float32))
    step = torch.tensor(0.05)
    prox = PROXES[name](ptt.operators)
    d = kk.describe_prox(prox)
    assert d.split == (name in SPLIT)
    assert d.prox is prox
    if not d.split:
        # a column with no positive entry divides 0 by 0 in both
        torch.testing.assert_close(
            kk.ProxDescriptor.from_codes(*d.op_args())(X, step),
            prox(X, step), rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# K1

@pytest.mark.parametrize("name,shape", [
    *((name, (40, 12, 700)) for name in sorted(PROXES)),
    *((name, shape) for shape in EDGE_SHAPES + VWIDE_SHAPES
      for name in EDGE_NAMES)],
    ids=lambda v: v if isinstance(v, str) else _shape_id(v))
def test_k1_codes_against_jax_wide(name, shape, fma):
    """Every code (and the split path) at C=40, K=12, N=700 (unaligned);
    three of them at each of the wide body's tile edges and the very-wide
    body's shapes."""
    A, S, Y, W = _problem(*shape, weighted=True)
    sS = 0.8 / float(np.linalg.eigvalsh(A.T @ A)[-1])
    want = _jax_k1(A, S, Y, W, sS, PROXES[name](pt.operators))
    got = kk.fused_nmf_pgm_step(_t(A), _t(S), _t(Y), torch.tensor(sS),
                                W=_t(W), prox_S=PROXES[name](ptt.operators))
    _close([g.numpy() for g in got[:3]] + [float(v) for v in got[3:]], want,
           ds_at=4)


@pytest.mark.parametrize("name", ["plus", "soft_plus", "chain",
                                  "split_closure"])
@pytest.mark.parametrize("C,K,N", [(5, 7, 700), (100, 3, 50)])
def test_k1_flagship_and_unmixing_shapes(name, C, K, N, fma):
    A, S, Y, _ = _problem(C, K, N)
    sS = 0.8 / float(np.linalg.eigvalsh(A.T @ A)[-1])
    want = _jax_k1(A, S, Y, None, sS, PROXES[name](pt.operators))
    got = kk.fused_nmf_pgm_step(_t(A), _t(S), _t(Y), sS,
                                prox_S=PROXES[name](ptt.operators))
    _close([g.numpy() for g in got[:3]] + [float(v) for v in got[3:]], want,
           ds_at=4)


def test_k1_bf16_store_chain_against_jax(fma):
    """The bfloat16 store with a compiled chain: S' within one bfloat16 ulp
    (a one-ulp float32 difference may flip a rounding), the rest as the
    float32 store's."""
    A, S, Y, _ = _problem(48, 12, 700)  # C a multiple of 16 for JAX
    sS = 0.8 / float(np.linalg.eigvalsh(A.T @ A)[-1])
    bf = jax.numpy.bfloat16
    S16, Y16 = (jax.numpy.asarray(a).astype(bf) for a in (S, Y))
    A_p, S_p, Y_p, _, dims, tile = jk.pad_nmf_problem(A, S, Y, tile_n=256)
    S_p, Y_p = S_p.astype(bf), Y_p.astype(bf)
    want = jk.fused_nmf_pgm_step(A_p, S_p, Y_p, sS, prox_S=PROXES[
        "soft_plus"](pt.operators), tile_n=tile, dims=dims)
    got = kk.fused_nmf_pgm_step(
        _t(A), torch.from_numpy(np.array(S16.astype(np.float32))).to(
            torch.bfloat16),
        torch.from_numpy(np.array(Y16.astype(np.float32))).to(
            torch.bfloat16), sS, prox_S=PROXES["soft_plus"](ptt.operators))
    S_j = np.asarray(want[1].astype(np.float32))[:12, :700]
    S_g = got[1].float().numpy()
    ulp = np.spacing(np.abs(S_j).astype(np.float32)) * 2.0 ** 16
    assert np.all(np.abs(S_g - S_j) <= ulp + 1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0])[:48, :12],
                               rtol=RTOL, atol=ATOL)


def test_k1_auto_residual_against_jax():
    """JAX's default residual (split3 at padded C K = 640) against the
    port's exact float32 one, at the looser AUTO_RTOL."""
    jax.clear_caches()
    A, S, Y, W = _problem(40, 12, 700, weighted=True)
    sS = 0.8 / float(np.linalg.eigvalsh(A.T @ A)[-1])
    want = _jax_k1(A, S, Y, W, sS, PROXES["soft_plus"](pt.operators))
    got = kk.fused_nmf_pgm_step(_t(A), _t(S), _t(Y), sS, W=_t(W),
                                prox_S=PROXES["soft_plus"](ptt.operators))
    for g, w in zip([g.numpy() for g in got[:3]], want[:3]):
        np.testing.assert_allclose(g, w, rtol=AUTO_RTOL, atol=1e-5)


# ---------------------------------------------------------------------------
# K2

def _k2_inputs(C, K, N, weighted=False):
    A, S, Y, W = _problem(C, K, N, weighted)
    rng = np.random.default_rng(5)
    M = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    V = (0.01 * rng.random((K, N))).astype(np.float32)
    alpha = (S.sum(1, keepdims=True) / N / 10).astype(np.float32)
    one, t = np.float32(1), np.float32(3)
    sc = (np.float32(0.9), one / (one - np.float32(0.9) ** t),
          one / (one - np.float32(0.999) ** t))
    return A, S, M, V, Y, W, alpha, sc


def _jax_k2(A, S, M, V, Y, W, alpha, sc, prox):
    C, K = A.shape
    N = S.shape[1]
    A_p, S_p, Y_p, W_p, dims, tile = jk.pad_nmf_problem(A, S, Y, W,
                                                        tile_n=256)
    pad = [(0, S_p.shape[0] - K), (0, S_p.shape[1] - N)]
    M_p, V_p = (np.pad(a, pad) for a in (M, V))
    al_p = np.pad(alpha, [(0, S_p.shape[0] - K), (0, 0)])
    out = jk.fused_nmf_adaprox_step(
        A_p, S_p, M_p, V_p, Y_p, al_p, np.asarray(sc, np.float32), W=W_p,
        prox_S=prox, tile_n=tile, dims=dims)
    return (np.asarray(out[0])[:C, :K], np.asarray(out[1])[:K, :N],
            np.asarray(out[2])[:K, :N], np.asarray(out[3])[:K, :N],
            np.asarray(out[4])[:K], *(float(v) for v in out[5:]))


@pytest.mark.parametrize("name,shape", [
    *((name, (40, 12, 700)) for name in SEPARABLE + ("split_closure",)),
    *((name, shape) for shape in EDGE_SHAPES + VWIDE_SHAPES
      for name in EDGE_K2)],
    ids=lambda v: v if isinstance(v, str) else _shape_id(v))
def test_k2_codes_against_jax_wide(name, shape, fma):
    """Every separable code with the per-element step alpha / Psi, and the
    split path, at C=40, K=12, N=700 with W; three of them at each of the
    wide body's tile edges and the very-wide body's shapes."""
    A, S, M, V, Y, W, alpha, sc = _k2_inputs(*shape, weighted=True)
    want = _jax_k2(A, S, M, V, Y, W, alpha, sc, PROXES[name](pt.operators))
    got = kk.fused_nmf_adaprox_step(
        *(_t(a) for a in (A, S, M, V, Y)), _t(alpha), sc, W=_t(W),
        prox_S=kk.describe_prox(PROXES[name](ptt.operators), "adaprox",
                                True))
    _close([g.numpy() for g in got[:5]] + [float(v) for v in got[5:]], want,
           ds_at=6)


@pytest.mark.parametrize("C,K,N", [(5, 7, 700), (100, 3, 50)])
def test_k2_flagship_and_unmixing_shapes(C, K, N, fma):
    A, S, M, V, Y, W, alpha, sc = _k2_inputs(C, K, N)
    want = _jax_k2(A, S, M, V, Y, W, alpha, sc,
                   PROXES["soft_plus"](pt.operators))
    got = kk.fused_nmf_adaprox_step(
        *(_t(a) for a in (A, S, M, V, Y)), _t(alpha), sc,
        prox_S=PROXES["soft_plus"](ptt.operators))
    _close([g.numpy() for g in got[:5]] + [float(v) for v in got[5:]], want,
           ds_at=6)


# ---------------------------------------------------------------------------
# K3

@pytest.mark.parametrize("C,K,N", [(40, 12, 700), (100, 3, 50),
                                   (128, 32, 300), *EDGE_SHAPES,
                                   *VWIDE_SHAPES])
@pytest.mark.parametrize("weighted", [False, True])
def test_k3_wide_against_jax(C, K, N, weighted, fma):
    A, S, Y, W = _problem(C, K, N, weighted)
    want = pt.ops.fused_nmf_grad(A, S, Y, W=W, tile_n=256)
    got = ptt.ops.fused_nmf_grad(_t(A), _t(S), _t(Y), W=_t(W), tile_n=256)
    _close([g.numpy() for g in got[:3]] + [float(got[3])],
           [np.asarray(w) for w in want[:3]] + [float(want[3])])


# ---------------------------------------------------------------------------
# whole solves: nmf(engine="cuda") on CPU tensors against engine="pallas"

def _solve_problem(C, K, N, seed=3):
    rng = np.random.default_rng(seed)
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    return Y, A0, S0


@pytest.mark.parametrize("name", ["soft_plus", "unity_plus", "chain",
                                  "hard_plus", "split_closure"])
@pytest.mark.parametrize("C,K,N", [(4, 3, 300), (40, 12, 400)])
def test_pgm_engine_against_jax_pallas(name, C, K, N, fma):
    Y, A0, S0 = _solve_problem(C, K, N)
    jr = pt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=PROXES[name](
        pt.operators), e_rel=0, max_iter=10, engine="pallas", tile_n=128)
    tr = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=PROXES[name](
        ptt.operators), e_rel=0, max_iter=10, engine="cuda", device="cpu",
        tile_n=128)
    assert tr.iterations == jr.iterations == 10
    for g, w in zip(tr.x, jr.x):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=SOLVE_RTOL, atol=1e-5)


@pytest.mark.parametrize("name", ["plus", "soft_plus", "min_abs"])
@pytest.mark.parametrize("C,K,N", [(4, 3, 300), (40, 12, 400)])
def test_adaprox_engine_against_jax_pallas(name, C, K, N, fma):
    Y, A0, S0 = _solve_problem(C, K, N)
    kw = dict(algorithm="adaprox", e_rel=0, max_iter=10, tile_n=128)
    jr = pt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=PROXES[name](
        pt.operators), engine="pallas", **kw)
    tr = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=PROXES[name](
        ptt.operators), engine="cuda", device="cpu", **kw)
    assert tr.iterations == jr.iterations == 10
    for g, w in zip(tr.x, jr.x):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=SOLVE_RTOL, atol=1e-5)


def test_pixel_coupled_prox_is_applied_to_the_whole_s():
    """A prox that couples pixels (the sum over N, axis 1) with tile_n=128
    at N=300: JAX's Pallas K1 normalizes each of the three pixel tiles
    (row sums 3.0), its engine="xla" and the port's engine="cuda" the whole
    S (row sums 1.0), and the two agree."""
    Y, A0, S0 = _solve_problem(4, 3, 300, seed=11)
    kw = dict(e_rel=0, max_iter=3)
    jp = pt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=P(
        pt.operators.prox_unity_plus, axis=1), engine="pallas", tile_n=128,
        **kw)
    jx = pt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=P(
        pt.operators.prox_unity_plus, axis=1), engine="xla", **kw)
    tr = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), prox_S=P(
        ptt.operators.prox_unity_plus, axis=1), engine="cuda", device="cpu",
        tile_n=128, **kw)
    np.testing.assert_allclose(np.asarray(jp.x[1]).sum(1), 3.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(jx.x[1]).sum(1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(tr.x[1].numpy().sum(1), 1.0, rtol=1e-5)
    for g, w in zip(tr.x, jx.x):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SOLVE_RTOL,
                                   atol=1e-6)


def test_cuda_refusal_names_the_ceiling():
    """No width is refused any more: every C >= 1, K >= 1 has its tier of
    instances, the narrow ones up to C = 16, K = 8, the wide body up to
    C = WIDE_C = 256, K = WIDE_K = 32, the very-wide body beyond, with no
    upper bound (the C side picks the same, nmf_*_partials_width)."""
    assert kk.tier(1, 1) == kk.tier(16, 8) == "narrow"
    for C, K in ((17, 8), (16, 9), (256, 32), (1, 32), (256, 1)):
        assert kk.tier(C, K) == "wide"
    for C, K in ((257, 3), (4, 33), (425, 32), (128, 64), (257, 33),
                 (100_000, 1), (1, 1_000)):
        assert kk.tier(C, K) == "very wide"
    assert (kk.WIDE_C, kk.WIDE_K) == (256, 32)
    # the route a step on the wide or very-wide body counts in, also where
    # K2 runs a narrow shape's chain on the wide body
    assert kk._wide_route(5, 7) == kk._wide_route(256, 32) == "wide"
    assert kk._wide_route(257, 3) == kk._wide_route(4, 33) == "very wide"


class _RecordingLibrary:
    """Stands in for a kernel library where there is no card: answers the
    partial buffer's queries and records each launch's entry and mode."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, entry):
        if entry.endswith("_partials_width"):
            return lambda mode, C, K: 1
        if entry.endswith("_partials_rows"):
            return lambda N, tile_n: 1
        if entry.endswith("_scratch_floats"):
            return lambda *shape: 1

        def launch(mode, *args):
            self.calls.append((self.name, entry, mode))
            return 0
        return launch


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("K,library,body", [
    (32, "nmf_adaprox_wide", "wide_pass.cuh KB=32"),
    (33, "nmf_adaprox_vwide", "post_pass.cuh"),
    (256, "nmf_adaprox_vwide", "post_pass.cuh"),
    (257, "nmf_adaprox_vwide", "post_pass.cuh")])
def test_second_pass_routes_on_the_host(K, library, body, chip_smoke,
                                        monkeypatch):
    """Split pass 2 of K1 launches nmf_pgm_wide's mode 2 and K2's the
    library _adaprox_library names (the wide one up to K = 32, the very-wide
    one, which holds post_pass.cuh's body, past it), each counted once as
    "split pass 2" and nowhere else; chip_smoke.py's kernels line names the
    body (csrc/tiers.cuh: the wide body up to K = 32, post_pass.cuh's at any
    K past it). The launches go to a recording stand-in: no card here."""
    calls = []
    monkeypatch.setattr(kk, "_library",
                        lambda name: _RecordingLibrary(name, calls))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    counters = (kk.fused_nmf_pgm_step, kk.fused_nmf_adaprox_step)
    before = [dict(c.route_launches) for c in counters]
    S, P = torch.rand((K, 5)), torch.rand((K, 5))
    kk._pgm_pass2_cuda(S, P, 4096)
    kk._adaprox_pass2_cuda(S, P, 4096)
    assert calls == [("nmf_pgm_wide", "nmf_pgm_wide", 2),
                     (library, "nmf_adaprox_wide", 2)]
    assert kk._adaprox_library(2, 1, K) == library
    for c, b in zip(counters, before):
        ran = {r: n - b[r] for r, n in c.route_launches.items() if n != b[r]}
        assert ran == {"split pass 2": 1}
    assert chip_smoke.body_instance(kk, K, False, "K1") == body


@pytest.mark.parametrize("K,k1_k3,k2", [
    (256, "kwide_pass.cuh KB=256", "kwide_pass.cuh KB=256"),
    (257, "panel_pass.cuh", "vwide_pass.cuh"),
    (512, "panel_pass.cuh", "vwide_pass.cuh"),
    (513, "vwide_pass.cuh", "vwide_pass.cuh")])
def test_residual_passes_past_k256_name_their_body(K, k1_k3, k2, chip_smoke):
    """Past K = KWIDE_K = 256 the passes with a residual of K1 and K3 run
    csrc/panel_pass.cuh's body up to K = PANEL_K = 512 and K2's run
    vwide_pass.cuh's, as every kernel's does past 512 (csrc/tiers.cuh, whose
    bounds test_torch_ops.py::test_tier_bounds_match_the_kernels holds to
    these): chip_smoke.py's kernels line names the body by kernel."""
    assert (kk.KWIDE_K, kk.PANEL_K) == (256, 512)
    for kernel, body in (("K1", k1_k3), ("K2", k2), ("K3", k1_k3)):
        assert chip_smoke.body_instance(kk, K, True, kernel) == body
    assert chip_smoke.body_instance(kk, K, False, "K2") == "post_pass.cuh"
