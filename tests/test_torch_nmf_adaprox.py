"""AdaProx-NMF in the port against proxmin_tpu: K2's plain version, the two
engines of nmf(algorithm="adaprox"), and states crossing between engines
and packages.

Tolerances and their reasons:
- K2's plain version vs the JAX fused_nmf_adaprox_step (Pallas interpreter,
  problem padded to (8, 8, tile) and outputs cropped): rtol 2e-4, atol 1e-5
  elementwise, |S' - S|^2 rtol 1e-3 (K1's tolerances: float32 sums over the
  pixels in other orders); bfloat16 moment stores within one bfloat16 ulp.
- engine="torch" vs engine="xla", float64: rtol 1e-9, atol 1e-13 (the same
  iteration in the same order; BLAS summation orders differ by ulps).
- engine="cuda" (the plain K2 version on CPU tensors) vs nmf_adaprox_fused,
  float32: atol 2e-5, as test_pallas_ops.py holds the fused engine to the
  XLA driver. bfloat16 moments: a one-ulp float32 difference may flip one
  bfloat16 rounding, which then compounds, so 2 iterations are held to atol
  2e-5 and 20 to atol 5e-3.
- resume within the port: bitwise.
- K2's plain version with the bfloat16 store (S, Y and W in bfloat16) vs
  the JAX kernel (problem padded to (16, 16, tile), as JAX requires for
  bfloat16): S' within one bfloat16 ulp (a one-ulp float32 difference may
  flip one rounding), everything else at the tolerances above.
- nmf_adaprox_fused with the bfloat16 store: the JAX suite's loss rule
  l16 < max(3 l32, l32 + 1) against the float32 store, float32 outputs, and
  the JAX engine's iterates within atol 1e-2 after 2 iterations and 0.15
  after 10 (test_pallas_ops.py's bound between the stores: a flipped
  bfloat16 rounding of S moves an element by an ulp, which Adam's Phi/Psi
  ratio amplifies). After 200 iterations on bench.py's noisy data the
  losses: float32 store rtol 1e-4, bfloat16 store rtol 0.05 (the flipped
  roundings compound).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu_torch as ptt
from proxmin_tpu.ops.nmf_kernels import fused_nmf_adaprox_step as jax_step
from proxmin_tpu_torch import interop
from proxmin_tpu_torch.interop import state_from_numpy
from proxmin_tpu_torch.ops import nmf_kernels as kk

F64 = dict(rtol=1e-9, atol=1e-13)
F32 = dict(rtol=0, atol=2e-5)

# NumPy inputs go to the card unless the caller names a device; these tests
# run on the CPU
_nmf = functools.partial(ptt.nmf.nmf, device="cpu")
_adaprox_fused = functools.partial(ptt.nmf.nmf_adaprox_fused, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(seed=101, C=5, K=3, N=400, dtype=np.float64):
    rng = np.random.default_rng(seed)
    Y = (rng.random((C, K)) @ rng.random((K, N))
         + 0.01 * rng.standard_normal((C, N))).astype(dtype)
    A0 = rng.random((C, K)).astype(dtype)
    S0 = rng.random((K, N)).astype(dtype)
    W = (0.5 + rng.random((C, N))).astype(dtype)
    return Y, A0, S0, W


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _close(got, want, tol):
    for t, j in zip(got, want):
        np.testing.assert_allclose(_np(t), _np(j), **tol)


def _numpy_state(state):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, state)


# ---------------------------------------------------------------------------
# K2's plain version against the JAX kernel

def _pad(x, rows, cols):
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])))


def _bf16_ulp_close(got, want):
    """Within one bfloat16 ulp of want (both hold bfloat16 values)."""
    m, e = np.frexp(want)
    ulp = np.maximum(np.ldexp(1.0, e - 8), 2.0 ** -133)
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("mdt,weighted,prox", [
    (m, w, p) for m in ("f32", "bf16") for w in (False, True)
    for p in ("plus", "id")] + [("f32", True, "soft")])
def test_plain_version_matches_jax_kernel(mdt, weighted, prox):
    """f32 and bf16 moments, with and without W, the builtin proxs and a
    relative soft threshold (the plain version takes any prox)."""
    rng = np.random.default_rng(7)
    C, K, N, tile = 5, 4, 300, 128
    A = rng.random((C, K)).astype(np.float32)
    S = rng.random((K, N)).astype(np.float32)
    Y = rng.random((C, N)).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32) if weighted else None
    jmd = jnp.bfloat16 if mdt == "bf16" else jnp.float32
    # moments that the moment dtype holds exactly, as float32 arrays
    M = np.array(jnp.asarray(0.1 * rng.standard_normal((K, N)), jmd)
                 .astype(jnp.float32))
    V = np.array(jnp.asarray(0.01 * rng.random((K, N)), jmd)
                 .astype(jnp.float32))
    alpha = (S.sum(1, keepdims=True) / N / 10).astype(np.float32)
    one, t = np.float32(1), np.float32(4)
    sc = (np.float32(0.9), one / (one - np.float32(0.9) ** t),
          one / (one - np.float32(0.999) ** t))
    j_prox, t_prox = {
        "plus": (None, None),
        "id": (pt.operators.prox_id, ptt.operators.prox_id),
        "soft": (functools.partial(pt.operators.prox_soft, thresh=0.01),
                 functools.partial(ptt.operators.prox_soft, thresh=0.01)),
    }[prox]
    Np = -(-N // tile) * tile
    want = jax_step(
        jnp.asarray(_pad(A, 8, 8)), jnp.asarray(_pad(S, 8, Np)),
        jnp.asarray(_pad(M, 8, Np), jmd), jnp.asarray(_pad(V, 8, Np), jmd),
        jnp.asarray(_pad(Y, 8, Np)), jnp.asarray(_pad(alpha, 8, 1)),
        jnp.asarray(sc), W=None if W is None else jnp.asarray(_pad(W, 8, Np)),
        prox_S=j_prox, tile_n=tile, dims=(C, K, N))
    tmd = torch.bfloat16 if mdt == "bf16" else torch.float32
    got = kk.fused_nmf_adaprox_step(
        torch.from_numpy(A), torch.from_numpy(S),
        torch.from_numpy(M).to(tmd), torch.from_numpy(V).to(tmd),
        torch.from_numpy(Y), torch.from_numpy(alpha), sc,
        W=None if W is None else torch.from_numpy(W), prox_S=t_prox)
    crops = [(C, K), (K, N), (K, N), (K, N), (K, 1)]
    for i, (g, w) in enumerate(zip(got[:5], want[:5])):
        assert g.dtype == (tmd if i in (2, 3) else torch.float32)
        w = _np(w)[:crops[i][0], :crops[i][1]]
        if mdt == "bf16" and i in (2, 3):
            _bf16_ulp_close(_np(g), w)
        else:
            np.testing.assert_allclose(_np(g), w, rtol=2e-4, atol=1e-5)
    for i, (g, w) in enumerate(zip(got[5:], want[5:])):
        np.testing.assert_allclose(float(g), float(w),
                                   rtol=1e-3 if i == 1 else 2e-4)


@pytest.mark.parametrize("mdt", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_version_bf16_store_matches_jax_kernel(mdt, weighted):
    """S, Y (and W) stored in bfloat16, with f32 and bf16 moments."""
    rng = np.random.default_rng(11)
    C, K, N, tile = 5, 4, 300, 128
    bf = jnp.bfloat16
    A = rng.random((C, K)).astype(np.float32)
    # data that bfloat16 holds exactly, as float32 arrays
    S, Y = (np.array(jnp.asarray(rng.random(sh), bf).astype(jnp.float32))
            for sh in ((K, N), (C, N)))
    W = (np.array(jnp.asarray(0.5 + rng.random((C, N)), bf)
                  .astype(jnp.float32)) if weighted else None)
    jmd = bf if mdt == "bf16" else jnp.float32
    M = np.array(jnp.asarray(0.1 * rng.standard_normal((K, N)), jmd)
                 .astype(jnp.float32))
    V = np.array(jnp.asarray(0.01 * rng.random((K, N)), jmd)
                 .astype(jnp.float32))
    alpha = (S.sum(1, keepdims=True) / N / 10).astype(np.float32)
    one, t = np.float32(1), np.float32(4)
    sc = (np.float32(0.9), one / (one - np.float32(0.9) ** t),
          one / (one - np.float32(0.999) ** t))
    Np = -(-N // tile) * tile
    want = jax_step(
        jnp.asarray(_pad(A, 16, 16)), jnp.asarray(_pad(S, 16, Np), bf),
        jnp.asarray(_pad(M, 16, Np), jmd), jnp.asarray(_pad(V, 16, Np), jmd),
        jnp.asarray(_pad(Y, 16, Np), bf), jnp.asarray(_pad(alpha, 16, 1)),
        jnp.asarray(sc),
        W=None if W is None else jnp.asarray(_pad(W, 16, Np), bf),
        tile_n=tile, dims=(C, K, N))
    tmd = torch.bfloat16 if mdt == "bf16" else torch.float32
    tb = torch.bfloat16
    got = kk.fused_nmf_adaprox_step(
        torch.from_numpy(A), torch.from_numpy(S).to(tb),
        torch.from_numpy(M).to(tmd), torch.from_numpy(V).to(tmd),
        torch.from_numpy(Y).to(tb), torch.from_numpy(alpha), sc,
        W=None if W is None else torch.from_numpy(W).to(tb))
    assert got[1].dtype == tb
    crops = [(C, K), (K, N), (K, N), (K, N), (K, 1)]
    for i, (g, w) in enumerate(zip(got[:5], want[:5])):
        w = _np(w)[:crops[i][0], :crops[i][1]]
        if i == 1 or (mdt == "bf16" and i in (2, 3)):
            _bf16_ulp_close(_np(g), w)
        else:
            np.testing.assert_allclose(_np(g), w, rtol=2e-4, atol=1e-5)
    for i, (g, w) in enumerate(zip(got[5:], want[5:])):
        np.testing.assert_allclose(float(g), float(w),
                                   rtol=1e-3 if i == 1 else 2e-4)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper is the plain version, bit for bit, and
    counts no kernel launch."""
    rng = np.random.default_rng(3)
    A, S, Y = (torch.from_numpy(rng.random(s).astype(np.float32))
               for s in ((4, 3), (3, 200), (4, 200)))
    M, V = torch.zeros_like(S), torch.zeros_like(S)
    alpha = S.sum(1, keepdim=True) / 2000
    sc = (0.9, 10.0, 1000.0)
    before = kk.fused_nmf_adaprox_step.launches
    got = kk.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc)
    ref = kk.fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha, sc)
    assert kk.fused_nmf_adaprox_step.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    # prox_S reaches K2 as a compiled chain where separable_when holds, and
    # as the split path otherwise; none raises
    assert kk.describe_prox(None, "adaprox").ops == (kk._PLUS,)
    assert kk.describe_prox(ptt.operators.prox_id, "adaprox").ops == ()
    assert kk.describe_prox(ptt.operators.prox_soft, "adaprox").ops == (
        kk._SOFT | kk._RELATIVE,)
    assert kk.describe_prox(functools.partial(ptt.operators.prox_soft,
                                              thresh=0.1,
                                              type="absolute"),
                            "adaprox").split
    with pytest.raises(ValueError, match="CPU or CUDA"):
        meta = torch.empty((4, 3), device="meta")
        kk.fused_nmf_adaprox_step(meta, S, M, V, Y, alpha, sc)


# ---------------------------------------------------------------------------
# the torch engine against engine="xla"

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["separable", "sub-loop"])
def test_torch_engine_matches_xla(weighted, mode):
    """The separable closed form for 25 fixed iterations, or the default
    prox sub-iterations to a stopping test."""
    Y, A0, S0, W = _problem()
    w = W if weighted else 1
    kw = (dict(e_rel=0, max_iter=25, separable_prox="auto")
          if mode == "separable" else dict(e_rel=1e-4, max_iter=40))
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), W=w, algorithm="adaprox", **kw)
    rt = _nmf(Y, A0.copy(), S0.copy(), W=w, algorithm="adaprox", **kw)
    assert rt.iterations == rj.iterations
    assert rt.sub_iterations == rj.sub_iterations
    assert rt.x[0].dtype == torch.float64
    _close(rt.x, rj.x, F64)


def test_step_and_weights_match_jax():
    Y, A, S, W = _problem(C=4, K=3, N=50)
    for s, w in zip(ptt.nmf.step_adaprox(torch.from_numpy(A),
                                         torch.from_numpy(S)),
                    pt.nmf.step_adaprox(A, S)):
        np.testing.assert_allclose(s.numpy(), np.asarray(w), rtol=1e-15)
    Yt = torch.from_numpy(Y)
    for w in (2.0, W, W[:, :1], np.float32(3.0)):
        np.testing.assert_array_equal(ptt.nmf._promote_W(w, Yt).numpy(),
                                      np.asarray(pt.nmf._promote_W(w, Y)))


# ---------------------------------------------------------------------------
# the cuda engine (the plain K2 version on CPU tensors) against
# nmf_adaprox_fused

@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_engine_matches_fused_engine(weighted):
    Y, A0, S0, W = _problem(dtype=np.float32)
    w = W if weighted else None
    rj = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), W=w, e_rel=0,
                                  max_iter=30, tile_n=128)
    rt = _nmf(Y, A0.copy(), S0.copy(), W=1 if w is None else w,
                     algorithm="adaprox", engine="cuda", e_rel=0,
                     max_iter=30)
    assert rt.iterations == rj.iterations == 30
    _close(rt.x, rj.x, F32)
    _close(rt.M + rt.V, rj.M + rj.V, dict(rtol=1e-3, atol=1e-5))
    np.testing.assert_allclose(rt.loss, rj.loss, rtol=1e-5)


def test_cuda_engine_bfloat16_moments():
    Y, A0, S0, _ = _problem(dtype=np.float32)
    for iters, tol in ((2, F32), (20, dict(rtol=0, atol=5e-3))):
        rj = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                      max_iter=iters, tile_n=128,
                                      moment_dtype=jnp.bfloat16)
        rt = _nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                         engine="cuda", e_rel=0, max_iter=iters,
                         moment_dtype="bfloat16")
        assert rt.M[1].dtype == torch.bfloat16
        assert rt.M[0].dtype == rt.x[1].dtype == torch.float32
        _close(rt.x, rj.x, tol)


def test_cuda_engine_bfloat16_store():
    """store_dtype=bfloat16 (with bfloat16 moments for the loss rule) on
    CPU tensors against the JAX fused engine, as test_pallas_ops.py holds
    JAX's store against its float32 one."""
    rng = np.random.default_rng(5)
    C, K, N = 16, 8, 512
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    both = dict(store_dtype="bfloat16", moment_dtype="bfloat16")
    r32 = _adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=40,
                         tile_n=128)
    r16 = _adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=40,
                         tile_n=128, **both)
    assert r16.x[1].dtype == r16.x[0].dtype == torch.float32
    assert r16.loss < max(r32.loss * 3, r32.loss + 1.0)
    assert r16.state["fused_config"]["store_dtype"] == "bfloat16"
    j16 = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                   max_iter=40, tile_n=128,
                                   store_dtype=jnp.bfloat16,
                                   moment_dtype=jnp.bfloat16)
    assert r16.loss < max(j16.loss * 3, j16.loss + 1.0)
    for iters, atol in ((2, 1e-2), (10, 0.15)):
        rj = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                      max_iter=iters, tile_n=128,
                                      store_dtype=jnp.bfloat16)
        rt = _nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                  engine="cuda", e_rel=0, max_iter=iters, tile_n=128,
                  store_dtype=torch.bfloat16)
        assert rt.state["fused_config"]["store_dtype"] == "bfloat16"
        _close(rt.x, rj.x, dict(rtol=0, atol=atol))


def test_cuda_engine_bfloat16_store_resume_is_bit_exact():
    """With the bfloat16 store and W, 2 x 10 iterations through state=
    equal 20 straight, bit for bit; a float32-store resume of that state
    raises."""
    Y, A0, S0, W = _problem(dtype=np.float32)
    kw = dict(algorithm="adaprox", engine="cuda", e_rel=0, W=W,
              store_dtype=torch.bfloat16)
    full = _nmf(Y, A0.copy(), S0.copy(), max_iter=20, **kw)
    half = _nmf(Y, A0.copy(), S0.copy(), max_iter=10, **kw)
    rest = _nmf(Y, *half.x, max_iter=10, state=half.state, **kw)
    for a, b in zip(rest.x + rest.M + rest.V, full.x + full.M + full.V):
        assert torch.equal(a, b)
    assert rest.loss == full.loss
    with pytest.raises(ValueError, match="store_dtype"):
        _nmf(Y, *half.x, algorithm="adaprox", engine="cuda", e_rel=0, W=W,
             max_iter=2, state=half.state)


def test_cuda_engine_bfloat16_store_levels_off_as_jax():
    """bench.py's flagship data (C=5, K=7, noise 0.02) at N=2e4 for 200
    iterations: the float32 store fits into the noise (K > C) and the
    bfloat16 store levels off near the noise's own loss (its Adam steps
    round away), in the port as in the JAX engine."""
    C, K, N = 5, 7, 20_000
    rng = np.random.default_rng(101)
    Y = (rng.random((C, K)).astype(np.float32)
         @ rng.random((K, N)).astype(np.float32)
         + 0.02 * rng.standard_normal((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    noise = 0.5 * C * N * 0.02 ** 2

    def loss(r):
        R = _np(r.x[0]) @ _np(r.x[1]) - Y
        return 0.5 * float(np.sum(R * R))

    got, want = {}, {}
    for sdt in (None, "bfloat16"):
        got[sdt] = loss(_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                       max_iter=200, store_dtype=sdt))
        want[sdt] = loss(pt.nmf.nmf_adaprox_fused(
            Y, A0.copy(), S0.copy(), e_rel=0, max_iter=200,
            store_dtype=sdt and jnp.bfloat16))
    np.testing.assert_allclose(got[None], want[None], rtol=1e-4)
    # a flipped bfloat16 rounding compounds (see the module docstring)
    np.testing.assert_allclose(got["bfloat16"], want["bfloat16"], rtol=0.05)
    assert got[None] < 0.5 * noise < got["bfloat16"] < 1.5 * noise


def test_cuda_engine_warm_start_matches_fused_engine():
    """M=/V= from a previous solve: the moments carry over and the
    bias-correction clock restarts, as in the JAX engine."""
    Y, A0, S0, _ = _problem(dtype=np.float32)
    first = pt.nmf.nmf_adaprox_fused(Y, A0.copy(), S0.copy(), e_rel=0,
                                     max_iter=12, tile_n=128)
    A1, S1 = (np.array(x) for x in first.x)
    M = tuple(np.asarray(m) for m in first.M)
    V = tuple(np.asarray(v) for v in first.V)
    rj = pt.nmf.nmf_adaprox_fused(Y, A1.copy(), S1.copy(), e_rel=0,
                                  max_iter=12, tile_n=128, M=M, V=V)
    rt = _nmf(Y, A1.copy(), S1.copy(), algorithm="adaprox",
                     engine="cuda", e_rel=0, max_iter=12, M=M, V=V)
    _close(rt.x, rj.x, F32)


def test_cuda_engine_resume_is_bit_exact():
    """2 x 15 iterations through state= equal 30 straight, bit for bit (the
    kernel's row sums carry over), and a stopped solve stays stopped."""
    Y, A0, S0, W = _problem(dtype=np.float32)
    kw = dict(algorithm="adaprox", engine="cuda", e_rel=0, W=W)
    full = _nmf(Y, A0.copy(), S0.copy(), max_iter=30, **kw)
    half = _nmf(Y, A0.copy(), S0.copy(), max_iter=15, **kw)
    rest = _nmf(Y, *half.x, max_iter=15, state=half.state, **kw)
    assert rest.iterations == 15 and rest.state["it"] == 30
    for a, b in zip(rest.x + rest.M + rest.V, full.x + full.M + full.V):
        assert torch.equal(a, b)
    assert torch.equal(rest.state["rowsum"], full.state["rowsum"])
    assert rest.loss == full.loss
    done = _nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                       engine="cuda", e_rel=1e-2, max_iter=3000)
    assert done.status == "converged"
    again = _nmf(Y, *done.x, algorithm="adaprox", engine="cuda",
                        e_rel=1e-2, max_iter=50, state=done.state)
    assert again.iterations == 0 and again.loss == done.loss


# ---------------------------------------------------------------------------
# states across engines and packages

def test_old_interop_sent_adaprox_states_to_the_pgm_branch():
    """A JAX adaprox state has no "kind": the pgm conversion, which
    state_from_numpy used to apply to any such state, fails on it with
    KeyError 't'; the adaprox conversion takes it."""
    Y, A0, S0, _ = _problem()
    half = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                      e_rel=0, max_iter=5, separable_prox="auto")
    st = _numpy_state(half.state)
    assert "kind" not in st
    with pytest.raises(KeyError, match="'t'"):
        interop._pgm_state(st, None)
    conv = state_from_numpy(st, device="cpu")
    assert set(conv) >= {"M", "V", "Vhat", "it", "converged", "diverged"}
    assert conv["it"] == 5


@pytest.mark.parametrize("jax_engine,port_engine,mdt", [
    ("xla", "torch", None), ("pallas", "cuda", None),
    ("pallas", "cuda", "bfloat16"), ("pallas", "torch", None)])
def test_continue_a_jax_adaprox_solve_in_the_port(jax_engine, port_engine,
                                                  mdt):
    """15 JAX iterations, then 15 in the port from state_from_numpy,
    against 30 JAX iterations (the fused state's bfloat16 moments arrive as
    ml_dtypes arrays)."""
    dtype = np.float64 if jax_engine == "xla" else np.float32
    Y, A0, S0, _ = _problem(dtype=dtype)
    kw = dict(algorithm="adaprox", e_rel=0, engine=jax_engine)
    if jax_engine == "xla":
        kw["separable_prox"] = "auto"
    else:
        kw["tile_n"] = 128
    if mdt:
        kw["moment_dtype"] = jnp.bfloat16
    full = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=30, **kw)
    half = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=15, **kw)
    state = state_from_numpy(_numpy_state(half.state), device="cpu")
    port_kw = dict(algorithm="adaprox", e_rel=0, engine=port_engine)
    if port_engine == "cuda":
        port_kw["tile_n"] = 128
        port_kw["moment_dtype"] = mdt
    else:
        port_kw["separable_prox"] = "auto"
    rest = _nmf(Y, np.asarray(half.x[0]), np.asarray(half.x[1]),
                       max_iter=15, state=state, **port_kw)
    assert rest.iterations == 15 and int(rest.state["it"]) == 30
    tol = F64 if jax_engine == "xla" else F32
    if mdt:  # a moment rounding may flip (see the module docstring)
        tol = dict(rtol=0, atol=5e-3)
    _close(rest.x, full.x, tol)


@pytest.mark.parametrize("mdt", [None, "bfloat16"])
def test_continue_a_jax_bf16_store_adaprox_solve_in_the_port(mdt):
    """A JAX fused solve with the bfloat16 store: 10 JAX iterations, then 10
    in the port from state_from_numpy, against 20 JAX iterations."""
    Y, A0, S0, W = _problem(dtype=np.float32)
    kw = dict(algorithm="adaprox", e_rel=0, engine="pallas", tile_n=128,
              store_dtype=jnp.bfloat16, W=W)
    if mdt:
        kw["moment_dtype"] = jnp.bfloat16
    full = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=20, **kw)
    half = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=10, **kw)
    state = state_from_numpy(_numpy_state(half.state), device="cpu")
    assert state["fused_config"]["store_dtype"] == "bfloat16"
    rest = _nmf(Y, np.asarray(half.x[0]), np.asarray(half.x[1]),
                max_iter=10, state=state, algorithm="adaprox", e_rel=0,
                engine="cuda", tile_n=128, store_dtype="bfloat16",
                moment_dtype=mdt, W=W)
    assert rest.iterations == 10 and int(rest.state["it"]) == 20
    # a flipped bfloat16 rounding compounds (see the module docstring)
    _close(rest.x, full.x, dict(rtol=0, atol=1e-2))


def test_cuda_state_resumes_on_the_torch_engine():
    """The fused state is interchangeable with the driver's: 15 cuda
    iterations continued by 15 on the torch engine match 30 cuda ones, and
    the other way round."""
    Y, A0, S0, _ = _problem(dtype=np.float32)
    cuda = dict(algorithm="adaprox", engine="cuda", e_rel=0)
    torch_ = dict(algorithm="adaprox", engine="torch", e_rel=0,
                  separable_prox="auto")
    full = _nmf(Y, A0.copy(), S0.copy(), max_iter=30, **cuda)
    half = _nmf(Y, A0.copy(), S0.copy(), max_iter=15, **cuda)
    rest = _nmf(Y, *half.x, max_iter=15, state=half.state, **torch_)
    assert int(rest.state["it"]) == 30
    _close(rest.x, full.x, F32)
    half_t = _nmf(Y, A0.copy(), S0.copy(), max_iter=15, **torch_)
    rest_c = _nmf(Y, *half_t.x, max_iter=15, state=half_t.state,
                         **cuda)
    _close(rest_c.x, full.x, F32)


# ---------------------------------------------------------------------------
# what the engines refuse, as the JAX engines refuse it

@pytest.mark.parametrize("kw,err,match", [
    ({"scheme": "radam"}, ValueError, "scheme='adam'"),
    ({"separable_prox": False}, ValueError, "sub-iteration"),
    ({"separable_prox": "Auto"}, ValueError, "separable"),
    ({"prox_S": functools.partial(ptt.operators.prox_soft, thresh=0.01,
                                  type="absolute")}, ValueError, "separable"),
    ({"step_stride": 5}, ValueError, "step_stride"),
    ({"step": ptt.nmf.step_adaprox}, ValueError, "default steps"),
    ({"accelerated": True}, ValueError, "unsupported"),
    # the id names what this case raised before the engine took the
    # bfloat16 store; it now runs (err None)
    pytest.param({"store_dtype": torch.bfloat16}, None, "store_dtype",
                 id="kw7-NotImplementedError-store_dtype"),
])
def test_cuda_engine_gates(kw, err, match):
    Y, A0, S0, _ = _problem(C=4, K=3, N=128, dtype=np.float32)
    if err is None:
        r = _nmf(Y, A0, S0, algorithm="adaprox", engine="cuda", max_iter=3,
                 **kw)
        assert r.iterations == 3 and r.state["fused_config"][match]
        return
    with pytest.raises(err, match=match):
        _nmf(Y, A0, S0, algorithm="adaprox", engine="cuda",
                    max_iter=3, **kw)


def test_states_that_do_not_fit_raise():
    Y, A0, S0, W = _problem(C=4, K=3, N=128, dtype=np.float32)
    pgm_state = _nmf(Y, A0.copy(), S0.copy(), engine="cuda",
                            max_iter=2).state
    with pytest.raises(ValueError, match="PGM state"):
        _nmf(Y, A0, S0, algorithm="adaprox", max_iter=2,
                    state=pgm_state)
    with pytest.raises(ValueError, match="nmf_pgm_fused"):
        _adaprox_fused(Y, A0, S0, max_iter=2, state=pgm_state)
    fused = _nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                        engine="cuda", max_iter=2)
    with pytest.raises(ValueError, match="fused configuration"):
        _nmf(Y, *fused.x, algorithm="adaprox", engine="cuda",
                    max_iter=2, tile_n=128, state=fused.state)
    with pytest.raises(ValueError, match="stepper state"):
        _nmf(Y, *fused.x, algorithm="adaprox", engine="cuda",
                    max_iter=2, state=dict(fused.state, stepper_state=(1,)))
    weighted = _nmf(Y, A0.copy(), S0.copy(), W=W, engine="cuda",
                    max_iter=2).state
    with pytest.raises(ValueError, match="weighting"):
        _nmf(Y, A0, S0, max_iter=2, state=weighted)
    with pytest.raises(ValueError, match="store_dtype"):
        _nmf(Y, A0, S0, algorithm="adaprox", max_iter=2,
             store_dtype=torch.bfloat16)
