"""Weighted and strided PGM-NMF, and K1's bfloat16 store, in the port
against proxmin_tpu.

Tolerances and their reasons:
- the weighted bounds, weighted steps and engine="torch" vs engine="xla",
  f64: rtol 1e-9. The same operations in the same order; only the BLAS
  libraries' summation orders differ (grown by the nonconvex iteration).
- engine="cuda" (K1's plain version on CPU tensors) vs engine="pallas" in
  interpret mode, f32: rtol 2e-4, atol 1e-6, the JAX suite's own bound
  between its fused and XLA engines (test_pallas_ops.py:392 and :1124):
  float32 pixel-axis sums in other orders, and the Pallas runner's power
  iteration starts from a vector normalized over the padded components.
- the bfloat16-store plain K1 vs the Pallas K1: S' within one bfloat16 ulp
  (a one-ulp float32 difference in the residual may flip one rounding), the
  float32 outputs rtol 2e-4, atol 1e-5, as K1's float32 store is held.
- a bfloat16-store solve vs the Pallas one: atol 1e-2 after 8 iterations,
  a few bfloat16 ulps of values in [0, 2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu_torch as ptt
from proxmin_tpu.ops.nmf_kernels import fused_nmf_pgm_step as jax_k1
from proxmin_tpu_torch.interop import state_from_numpy
from proxmin_tpu_torch.ops import nmf_kernels as kk

F64 = dict(rtol=1e-9, atol=0)
F32 = dict(rtol=2e-4, atol=1e-6)
STEP = dict(rtol=2e-4, atol=1e-5)

# NumPy inputs go to the card unless the caller names a device; these tests
# run on the CPU
_nmf = functools.partial(ptt.nmf.nmf, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(seed=101, C=5, K=3, N=300, dtype=np.float64, masked=False):
    rng = np.random.default_rng(seed)
    Y = (rng.random((C, K)) @ rng.random((K, N))
         + 0.01 * rng.standard_normal((C, N)))
    W = 0.5 + rng.random((C, N))
    if masked:
        W[:, : N // 4] = 0.0
    A0, S0 = rng.random((C, K)), rng.random((K, N))
    return tuple(a.astype(dtype) for a in (Y, A0, S0, W))


def _numpy_state(state):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, state)


def _close(port_x, jax_x, tol):
    for t, j in zip(port_x, jax_x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("masked", [False, True])
def test_weighted_bounds_and_steps_match_jax(masked):
    """Both weighted bounds, the warm-started power iteration with its next
    iterate, and weighted step_pgm; a fully masked pixel gives 0, not NaN."""
    Y, A, S, W = _problem(masked=masked)
    At, St, Wt = (torch.from_numpy(a) for a in (A, S, W))
    np.testing.assert_allclose(
        float(ptt.nmf._weighted_lipschitz_A(St, Wt)),
        float(pt.nmf._weighted_lipschitz_A(S, W)), **F64)
    np.testing.assert_allclose(
        float(ptt.nmf._weighted_lipschitz_S(At, Wt)),
        float(pt.nmf._weighted_lipschitz_S(A, W)), **F64)
    v0 = pt.nmf._weighted_lipschitz_S_v0(S.shape[1], A.shape[1], np.float64)
    np.testing.assert_allclose(
        ptt.nmf._weighted_lipschitz_S_v0(S.shape[1], A.shape[1],
                                         torch.float64, "cpu").numpy(),
        np.asarray(v0), **F64)
    lj, vj = pt.nmf._weighted_lipschitz_S(A, W, 12, v0=v0, return_v=True)
    lt, vt = ptt.nmf._weighted_lipschitz_S(At, Wt, 12,
                                           v0=torch.from_numpy(
                                               np.array(v0)),
                                           return_v=True)
    np.testing.assert_allclose(float(lt), float(lj), **F64)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-9,
                               atol=1e-15)
    assert np.isfinite(vt.numpy()).all()
    if masked:
        assert (vt[: S.shape[1] // 4] == 0).all()
    for s, w in zip(ptt.nmf.step_pgm(At, St, W=Wt),
                    pt.nmf.step_pgm(A, S, W=W)):
        np.testing.assert_allclose(float(s), float(w), **F64)


def test_weighted_stepper_matches_jax():
    """WeightedPGMStepper's refreshes (cold, then warm) and its state."""
    Y, A, S, W = _problem()
    X = (torch.from_numpy(A), torch.from_numpy(S))
    sj = pt.nmf.WeightedPGMStepper(jnp.asarray(W), stride=4, adapt=True)
    st = ptt.nmf.WeightedPGMStepper(torch.from_numpy(W), stride=4,
                                    adapt=True)
    state_j, state_t = sj.init_state((A, S), None), st.init_state(X, None)
    for it in (0, 4):
        steps_j, state_j = sj(state_j, (A, S), jnp.int32(it), None)
        steps_t, state_t = st(state_t, X, it, None)
        for a, b in zip(steps_t, steps_j):
            np.testing.assert_allclose(float(a), float(b), **F64)
        np.testing.assert_allclose(state_t[1].numpy(),
                                   np.asarray(state_j[1]), rtol=1e-9,
                                   atol=1e-15)
        assert (state_t[2], state_t[3]) == (int(state_j[2]),
                                            int(state_j[3]))
    assert st.segmentable and st.segment_end(state_t, 4) == state_t[3]
    assert st.state_steps(state_t) is state_t[0]


# (the unweighted exact solve is test_torch_nmf.py's)
_POLICIES = [(p, w) for w in (True, False) for p in (
    {}, {"step_stride": 3}, {"step_adapt": True},
    {"step_stride": 4, "step_adapt": True}, {"step_stride": 1})
    if w or p]


@pytest.mark.parametrize("policy,weighted", _POLICIES)
def test_torch_engine_matches_xla(policy, weighted):
    Y, A0, S0, W = _problem()
    kw = dict(e_rel=0, max_iter=25, W=W if weighted else 1, **policy)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw)
    rt = _nmf(Y, A0.copy(), S0.copy(), **kw)
    assert rj.iterations == rt.iterations == 25
    _close(rt.x, rj.x, F64)


@pytest.mark.parametrize("policy", [{}, {"step_stride": 5},
                                    {"step_adapt": True}])
def test_weighted_solve_stops_on_the_xla_iteration(policy):
    Y, A0, S0, W = _problem(seed=0)
    kw = dict(e_rel=1e-4, max_iter=3000, W=W, **policy)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw)
    rt = _nmf(Y, A0.copy(), S0.copy(), **kw)
    assert rj.status == rt.status == "converged"
    assert rj.iterations == rt.iterations
    _close(rt.x, rj.x, F64)


def test_broadcast_and_scalar_weights():
    """A per-channel (C, 1) weight and a scalar weight broadcast as in the
    JAX package (the scalar 1 is the unweighted solve)."""
    Y, A0, S0, W = _problem()
    for w in (W[:, :1].copy(), 2.0):
        rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=w, e_rel=0, max_iter=10,
                        step_stride=3)
        rt = _nmf(Y, A0.copy(), S0.copy(), W=w, e_rel=0, max_iter=10,
                  step_stride=3)
        _close(rt.x, rj.x, F64)


@pytest.mark.parametrize("policy,weighted", [
    (p, w) for p, w in _POLICIES if "step_stride" not in p
    or not p.get("step_adapt")])
def test_cuda_engine_matches_pallas_engine(policy, weighted):
    Y, A0, S0, W = _problem(dtype=np.float32)
    kw = dict(e_rel=0, max_iter=8, tile_n=128, W=W if weighted else None,
              **policy)
    rj = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), **kw)
    rt = ptt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), device="cpu", **kw)
    assert rj.iterations == rt.iterations == 8
    _close(rt.x, rj.x, F32)
    np.testing.assert_allclose(rt.loss, rj.loss, rtol=1e-4)
    steps_j, steps_t = rj.state["steps"], rt.state["steps"]
    assert [int(v) for v in steps_j[3:]] == list(steps_t[3:])
    for key in ("weighted", "stride_config", "store_dtype", "tile_n", "it"):
        assert rt.state[key] == rj.state[key]


def test_weighted_strided_cuda_engine_descends():
    """test_pallas_ops.py:416 on the port's cuda engine."""
    Y, A0, S0, W = _problem(C=6, N=256, dtype=np.float32)
    Y = (np.random.default_rng(1).random((6, 3))
         @ S0).astype(np.float32)
    l0 = float(ptt.nmf.log_likelihood(torch.from_numpy(A0),
                                      torch.from_numpy(S0),
                                      Y=torch.from_numpy(Y),
                                      W=torch.from_numpy(W)))
    res = _nmf(Y, A0, S0, W=W, e_rel=0, max_iter=100, engine="cuda",
               step_stride=10)
    l1 = float(ptt.nmf.log_likelihood(*res.x, Y=torch.from_numpy(Y),
                                      W=torch.from_numpy(W)))
    assert np.isfinite(l1) and l1 < 0.05 * l0


def test_masked_pixels_stay_finite_on_the_cuda_engine():
    Y, A0, S0, W = _problem(dtype=np.float32, masked=True)
    res = _nmf(Y, A0, S0, W=W, e_rel=0, max_iter=20, engine="cuda")
    for a in res.x:
        assert torch.isfinite(a).all()


def _bf16_ulp_close(got, want, atol=0.0):
    m, e = np.frexp(want)
    ulp = np.maximum(np.ldexp(1.0, e - 8), 2.0 ** -133)
    assert np.all(np.abs(got - want) <= ulp + atol)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("C,K,N", [(5, 3, 300), (6, 4, 1024)])
def test_bf16_store_plain_k1_matches_pallas(weighted, C, K, N):
    """K1's plain version with bfloat16 S, Y and W against the Pallas K1
    in interpret mode (padded to the bfloat16 sublane tile of 16)."""
    rng = np.random.default_rng(3)
    A = rng.random((C, K)).astype(np.float32)
    S, Y = rng.random((K, N)), rng.random((C, N))
    W = 0.5 + rng.random((C, N)) if weighted else None
    bf = jnp.bfloat16
    Sb, Yb = jnp.asarray(S, bf), jnp.asarray(Y, bf)
    Wb = None if W is None else jnp.asarray(W, bf)
    sS = 0.05
    tile, P = 128, 16
    Np = -(-N // tile) * tile

    def pad(x, rows, cols):
        return jnp.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])))

    want = jax_k1(pad(jnp.asarray(A), P, P), pad(Sb, P, Np), pad(Yb, P, Np),
                  sS, W=None if Wb is None else pad(Wb, P, Np),
                  tile_n=tile, dims=(C, K, N), interpret=True)
    want = (want[0][:C, :K], want[1][:K, :N], want[2][:K, :K], *want[3:])

    def t(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)

    got = kk.fused_nmf_pgm_step(torch.from_numpy(A), t(Sb), t(Yb), sS,
                                W=None if Wb is None else t(Wb))
    assert got[1].dtype == torch.bfloat16
    _bf16_ulp_close(got[1].float().numpy(),
                    np.asarray(want[1].astype(jnp.float32)))
    for i in (0, 2, 3, 4, 5):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-3 if i == 4 else STEP["rtol"],
                                   atol=STEP["atol"])


def test_bf16_store_solve_matches_pallas_and_f32():
    """The weighted strided bfloat16-store solve on the cuda engine: close
    to the Pallas one after 8 iterations, and within the JAX suite's rule
    of the float32 solve after 50 (test_pallas_ops.py:787)."""
    C, K, N = 6, 4, 512
    rng = np.random.default_rng(101)
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    kw = dict(W=W, e_rel=0, tile_n=128, step_stride=5)
    rj = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), max_iter=8,
                              store_dtype=jnp.bfloat16, **kw)
    rt = ptt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), max_iter=8,
                               store_dtype=torch.bfloat16, device="cpu",
                               **kw)
    assert rt.state["store_dtype"] == rj.state["store_dtype"] == "bfloat16"
    assert rt.x[1].dtype == torch.float32
    _close(rt.x, rj.x, dict(rtol=0, atol=1e-2))

    def wloss(r):
        D = Y - r.x[0].numpy() @ r.x[1].numpy()
        return 0.5 * np.sum(W * D * D)

    r32 = ptt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), max_iter=50,
                                device="cpu", **kw)
    r16 = _nmf(Y, A0.copy(), S0.copy(), max_iter=50, engine="cuda",
               store_dtype="bfloat16", **{k: v for k, v in kw.items()
                                          if k not in ("step_stride",)},
               step_stride=5)
    l32, l16 = wloss(r32), wloss(r16)
    assert l16 < max(3 * l32, l32 + 1.0)
    # a full-width store_dtype is the default layout
    r = ptt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), max_iter=3,
                              store_dtype=torch.float32, device="cpu", **kw)
    assert r.state["store_dtype"] is None


@pytest.mark.parametrize("split", [4, 5])
@pytest.mark.parametrize("policy,weighted", [
    ({"step_stride": 5}, True), ({"step_adapt": True}, True),
    ({}, True), ({"step_stride": 5}, False), ({"step_adapt": True}, False)])
def test_cuda_engine_resume_is_bit_exact(split, policy, weighted):
    """Stride 5: a stop at 4 lands mid-segment, at 5 on a boundary."""
    Y, A0, S0, W = _problem(dtype=np.float32)
    kw = dict(e_rel=0, engine="cuda", W=W if weighted else 1, **policy)
    full = _nmf(Y, A0.copy(), S0.copy(), max_iter=12, **kw)
    half = _nmf(Y, A0.copy(), S0.copy(), max_iter=split, **kw)
    rest = _nmf(Y, *half.x, max_iter=12 - split, state=half.state, **kw)
    assert rest.state["it"] == 12
    for a, b in zip(rest.x, full.x):
        assert torch.equal(a, b)
    assert rest.loss == full.loss
    assert rest.state["steps"][3:] == full.state["steps"][3:]


@pytest.mark.parametrize("engines", [("xla", "torch"), ("pallas", "cuda")])
@pytest.mark.parametrize("policy", [{"step_stride": 4},
                                    {"step_adapt": True}])
def test_continue_a_jax_weighted_solve_in_the_port(engines, policy):
    """Ten JAX iterations of a weighted strided solve, then ten in the port
    from state_from_numpy, against twenty JAX iterations."""
    jax_engine, port_engine = engines
    dtype, tol = ((np.float64, F64) if jax_engine == "xla"
                  else (np.float32, F32))
    Y, A0, S0, W = _problem(dtype=dtype)
    kw = dict(e_rel=0, W=W, **policy)
    extra = {"tile_n": 128} if jax_engine == "pallas" else {}
    full = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=20,
                      engine=jax_engine, **extra, **kw)
    half = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=10,
                      engine=jax_engine, **extra, **kw)
    state = state_from_numpy(_numpy_state(half.state), device="cpu")
    rest = _nmf(Y, np.asarray(half.x[0]), np.asarray(half.x[1]),
                max_iter=10, engine=port_engine, state=state, **extra, **kw)
    assert rest.iterations == 10 and int(rest.state["it"]) == 20
    _close(rest.x, full.x, tol)


def test_option_gates():
    # past C K K = 2**20 both packages switch to batched Lanczos
    rng = np.random.default_rng(5)
    S_big, W_big = rng.random((33, 6)), 0.5 + rng.random((1000, 6))
    np.testing.assert_allclose(
        float(ptt.nmf._weighted_lipschitz_A(torch.from_numpy(S_big),
                                            torch.from_numpy(W_big))),
        float(pt.nmf._weighted_lipschitz_A(S_big, W_big)), **F64)
    Y, A0, S0, W = _problem(dtype=np.float32)
    with pytest.raises(ValueError, match="store_dtype"):
        _nmf(Y, A0, S0, W=W, max_iter=2, store_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="store_dtype"):
        _nmf(Y, A0, S0, engine="cuda", max_iter=2, store_dtype=torch.int8)
    strided = _nmf(Y, A0.copy(), S0.copy(), engine="cuda", max_iter=2,
                   step_stride=3).state
    with pytest.raises(ValueError, match="step_stride"):
        _nmf(Y, A0, S0, engine="cuda", max_iter=2, state=strided)
    with pytest.raises(ValueError, match="store_dtype"):
        _nmf(Y, A0, S0, engine="cuda", max_iter=2, step_stride=3,
             store_dtype="bfloat16", state=strided)
    with pytest.raises(ValueError, match="weighting"):
        _nmf(Y, A0, S0, W=W, engine="cuda", max_iter=2, step_stride=3,
             state=strided)
