"""The port's linear operators and its ADMM-family numerics against
proxmin_tpu, on the same seeded NumPy inputs.

Tolerances and their reasons:
- matvec/rmatvec, Gram and dense eigen-quantities, f64: rtol 1e-9. The same
  products; only the BLAS libraries' summation orders differ.
- Lanczos and power iteration, f32: rtol 1e-5, f64: rtol 1e-9. The same
  recurrence from the same start vector; the reductions round differently.
- batched Lanczos against eigvalsh of the dense blocks: rtol 1e-8 (k = rank
  + 1 steps give the exact spectrum; the bisection ends at a few ulps).
- update_variables / check_constraint_convergence, f64: rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from proxmin_tpu import linop as jl
from proxmin_tpu import utils as ju
from proxmin_tpu_torch import linop as tl
from proxmin_tpu_torch import utils as tu

F64 = dict(rtol=1e-9, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=F64):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **tol)


# ---------------------------------------------------------------------------
# TV operators (the image_tv scenario), in both packages

def _tv(lib):
    cat = jnp.concatenate if lib is jnp else (
        lambda xs, axis: torch.cat(xs, dim=axis))

    def dh(x):
        return x[:, 1:] - x[:, :-1]

    def dh_T(v):
        return cat([-v[:, :1], v[:, :-1] - v[:, 1:], v[:, -1:]], axis=1)

    def dv(x):
        return x[1:, :] - x[:-1, :]

    def dv_T(v):
        return cat([-v[:1, :], v[:-1, :] - v[1:, :], v[-1:, :]], axis=0)

    return (dh, dh_T), (dv, dv_T)


# ---------------------------------------------------------------------------
# the iterations

@pytest.mark.parametrize("dtype,tol", [(np.float32, F32), (np.float64, F64)])
@pytest.mark.parametrize("which", ["power", "lanczos"])
def test_norm_iterations_match_jax(rng, which, dtype, tol):
    L = rng.normal(size=(9, 6)).astype(dtype)
    Lt = _t(L)
    name = f"{which}_iteration_norm_sq" if which == "power" \
        else "lanczos_norm_sq"
    want = getattr(jl, name)(lambda v: jnp.asarray(L) @ v,
                             lambda v: jnp.asarray(L).T @ v, (6,),
                             num_iters=40, dtype=dtype)
    got = getattr(tl, name)(lambda v: Lt @ v, lambda v: Lt.T @ v, (6,),
                            num_iters=40, dtype=dtype, device="cpu")
    assert got.dtype == _t(L).dtype and got.shape == ()
    _close(got, want, tol)
    if which == "lanczos":
        # k = n steps: the exact top eigenvalue
        _close(got, np.linalg.eigvalsh(L.T @ L)[-1],
               dict(rtol=1e-4 if dtype == np.float32 else 1e-9))


def test_lanczos_breakdown_keeps_the_computed_block():
    """A rank-1 operator breaks down after one step (beta = 0): the rest
    of the tridiagonal is zeros and the maximum is the one eigenvalue."""
    a = np.arange(1.0, 6.0)
    got = tl.lanczos_norm_sq(lambda v: _t(a) * torch.dot(_t(a), v),
                             lambda v: v, (5,), num_iters=5,
                             dtype=torch.float64, device="cpu")
    want = jl.lanczos_norm_sq(lambda v: jnp.asarray(a) * jnp.vdot(a, v),
                              lambda v: v, (5,), num_iters=5,
                              dtype=np.float64)
    _close(got, want)
    _close(got, a @ a)


def test_lanczos_on_tv_beats_power_iteration():
    """Forward differences have clustered top eigenvalues: Lanczos reaches
    4 sin^2(pi (n-1) / 2n) where power iteration is still short."""
    (dh, dh_T), _ = _tv(torch)
    (jdh, jdh_T), _ = _tv(jnp)
    got = tl.lanczos_norm_sq(dh, dh_T, (3, 24), dtype=torch.float32,
                             device="cpu")
    want = jl.lanczos_norm_sq(jdh, jdh_T, (3, 24), dtype=np.float32)
    _close(got, want, F32)
    exact = 4 * np.sin(np.pi * 23 / 48) ** 2
    assert abs(float(got) - exact) < 1e-4
    pw = tl.power_iteration_norm_sq(dh, dh_T, (3, 24), device="cpu")
    assert float(pw) < float(got)


def test_gram_norm_sq_matches_jax(rng):
    for shape in ((7, 3), (3, 7)):
        M = rng.normal(size=shape)
        _close(tl.gram_norm_sq(M, device="cpu"), jl.gram_norm_sq(M))
    assert tl.gram_norm_sq(np.eye(2, dtype=np.int64),
                           device="cpu").is_floating_point()


# ---------------------------------------------------------------------------
# the operators

def _operators(rng, kind):
    """A (port operator, JAX operator, in-shape) triple."""
    if kind == "identity":
        return tl.IdentityOperator(), jl.IdentityOperator(), (4, 3)
    if kind == "matrix":
        L = rng.normal(size=(5, 4))
        return (tl.MatrixOperator(L, device="cpu"), jl.MatrixOperator(L),
                (4, 3))
    if kind == "matrix axis=1":
        L = rng.normal(size=(8, 12))
        return (tl.MatrixOperator(L, axis=1, device="cpu"),
                jl.MatrixOperator(L, axis=1), (4, 3))
    if kind in ("sparse", "sparse axis=1"):
        shape = (8, 12) if "axis" in kind else (5, 4)
        axis = 1 if "axis" in kind else None
        L = sp.random(*shape, density=0.4, random_state=7, format="csr")
        return (tl.SparseOperator(L, axis=axis, device="cpu"),
                jl.SparseOperator(L, axis=axis), (4, 3))
    (dh, dh_T), _ = _tv(torch)
    (jdh, jdh_T), _ = _tv(jnp)
    return (tl.FunctionOperator(dh, dh_T, (4, 3), dtype=torch.float64,
                                device="cpu"),
            jl.FunctionOperator(jdh, jdh_T, (4, 3), dtype=np.float64),
            (4, 3))


KINDS = ["identity", "matrix", "matrix axis=1", "sparse", "sparse axis=1",
         "function"]


@pytest.mark.parametrize("kind", KINDS)
def test_operator_matches_jax(rng, kind):
    """matvec, rmatvec, dot, .T (both ways) and the spectral quantity."""
    top, jop, shape = _operators(rng, kind)
    x = rng.normal(size=shape)
    y_j = jop.matvec(jnp.asarray(x))
    y_t = top.matvec(_t(x))
    _close(y_t, y_j)
    _close(top.dot(_t(x)), y_j)
    y = rng.normal(size=np.shape(y_j))
    _close(top.rmatvec(_t(y)), jop.rmatvec(jnp.asarray(y)))
    _close(top.T.matvec(_t(y)), jop.T.matvec(jnp.asarray(y)))
    _close(top.T.rmatvec(_t(x)), jop.T.rmatvec(jnp.asarray(x)))
    _close(top.spectral_norm_sq, jop.spectral_norm_sq)
    _close(top.spectral_norm, jop.spectral_norm_sq)
    _close(top.T.spectral_norm_sq, jop.spectral_norm_sq)
    assert top.is_identity == jop.is_identity


@pytest.mark.parametrize("kind", ["matrix", "sparse"])
def test_matrix_operators_take_vectors_and_matrices(rng, kind):
    """``L @ X`` for 1-D and 2-D X, and through ``.T``."""
    top, jop, _ = _operators(rng, kind)
    for x in (rng.normal(size=4), rng.normal(size=(4, 2))):
        _close(top.matvec(_t(x)), jop.matvec(jnp.asarray(x)))
    for y in (rng.normal(size=5), rng.normal(size=(5, 2))):
        _close(top.rmatvec(_t(y)), jop.rmatvec(jnp.asarray(y)))
        _close(top.T.matvec(_t(y)), jop.T.matvec(jnp.asarray(y)))
    assert top.shape == (5, 4) and top.T.shape == (4, 5)
    # a float32 operand against the float64 matrix promotes, as in JAX
    x32 = rng.normal(size=4).astype(np.float32)
    assert top.matvec(_t(x32)).dtype == torch.float64


def test_matrix_operator_surface(rng):
    L = rng.normal(size=(5, 4))
    op = tl.MatrixOperator(_t(L))
    assert (op.shape, op.ndim, op.size, len(op)) == ((5, 4), 2, 20, 5)
    assert "MatrixOperator" in repr(op)
    with pytest.raises(NotImplementedError):
        tl.MatrixOperator(_t(L), axis=0).matvec(_t(L[0]))
    with pytest.raises(NotImplementedError):
        tl.LinearOperator().matvec(None)


def test_sparse_operator_from_scipy_and_torch(rng):
    """A scipy matrix in any format and a torch.sparse tensor give the
    same operator; the matrix stays sparse."""
    L = sp.random(8, 6, density=0.3, random_state=3)
    x = rng.normal(size=6)
    dense = L.toarray() @ x
    ops = [tl.SparseOperator(L.asformat(f), device="cpu")
           for f in ("coo", "csr", "csc")]
    ops.append(tl.SparseOperator(_t(L.toarray()).to_sparse_csr()))
    for op in ops:
        assert op.L.layout == torch.sparse_coo and op.L._nnz() == L.nnz
        _close(op.matvec(_t(x)), dense)
        _close(op.spectral_norm_sq,
               np.linalg.eigvalsh(L.toarray().T @ L.toarray())[-1],
               dict(rtol=1e-8))
    assert "nse=" in repr(ops[0])


def test_function_operator_out_shape_and_meta_fallback():
    (dh, dh_T), (dv, dv_T) = _tv(torch)
    op = tl.FunctionOperator(dh, dh_T, (5, 7), norm_sq=4.0)
    assert op.out_shape == (5, 6) and op.T.in_shape == (5, 6)
    assert op.spectral_norm_sq == 4.0 and op.T.spectral_norm_sq == 4.0
    assert tl.FunctionOperator(dv, dv_T, (5, 7), norm_sq=4.0).out_shape \
        == (4, 7)
    # a matvec that closes over a real tensor cannot run on a meta tensor
    w = torch.arange(7.0)
    closed = tl.FunctionOperator(lambda x: x * w, lambda y: y * w, (5, 7),
                                 norm_sq=36.0, device="cpu")
    assert closed.out_shape == (5, 7)
    assert "FunctionOperator" in repr(op)


def test_as_linear_operator_coerces_and_decascades(rng):
    L = rng.normal(size=(3, 2))
    assert isinstance(tl.as_linear_operator(None), tl.IdentityOperator)
    dense = tl.as_linear_operator(L, device="cpu")
    assert isinstance(dense, tl.MatrixOperator)
    assert tl.as_linear_operator(dense) is dense
    assert tl.MatrixAdapter(dense) is dense
    assert isinstance(tl.as_linear_operator(_t(L)), tl.MatrixOperator)
    sparse = tl.as_linear_operator(sp.csr_matrix(L), axis=1, device="cpu")
    assert isinstance(sparse, tl.SparseOperator) and sparse.axis == 1
    assert isinstance(tl.as_linear_operator(_t(L).to_sparse()),
                      tl.SparseOperator)


def test_get_spectral_norm_matches_jax(rng):
    L = rng.normal(size=(4, 3))
    assert tl.get_spectral_norm(None) == jl.get_spectral_norm(None) == 1
    _close(tl.get_spectral_norm(L, device="cpu"), jl.get_spectral_norm(L))
    _close(tl.get_spectral_norm(sp.csr_matrix(L), device="cpu"),
           jl.get_spectral_norm(sp.csr_matrix(L)))
    op = tl.MatrixOperator(L, device="cpu")
    assert tl.get_spectral_norm(op) is op.spectral_norm_sq


@pytest.mark.parametrize("make", [
    lambda: tl.MatrixOperator(np.eye(2)),
    lambda: tl.SparseOperator(sp.eye(2)),
    lambda: tl.as_linear_operator(np.eye(2)),
    lambda: tl.FunctionOperator(lambda x: x, lambda x: x, (2,)),
    lambda: tl.gram_norm_sq(np.eye(2)),
    lambda: tl.lanczos_norm_sq(lambda x: x, lambda x: x, (2,)),
    lambda: tl.power_iteration_norm_sq(lambda x: x, lambda x: x, (2,)),
])
def test_numpy_inputs_go_to_the_card_or_raise(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()


@settings(max_examples=25, deadline=None)
@given(hst.integers(2, 9), hst.integers(2, 9), hst.integers(0, 2 ** 31 - 1))
def test_tv_operators_are_adjoint(H, W, seed):
    """<L x, y> = <x, L^T y> for both difference operators."""
    rng = np.random.default_rng(seed)
    for (mv, rmv), out in zip(_tv(torch), ((H, W - 1), (H - 1, W))):
        op = tl.FunctionOperator(mv, rmv, (H, W), dtype=torch.float64,
                                 norm_sq=4.0)
        assert op.out_shape == out
        x, y = _t(rng.normal(size=(H, W))), _t(rng.normal(size=out))
        lhs = torch.sum(op.matvec(x) * y)
        rhs = torch.sum(x * op.rmatvec(y))
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-10,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# utils: the batched Lanczos bound

def _psd_blocks(rng, B, K, r):
    F = rng.normal(size=(B, r, K))
    F[B // 2] = 0.0  # a zero operator contributes exactly 0
    return np.einsum("brk,brl->bkl", F, F)


@pytest.mark.parametrize("B,n_candidates", [(6, 256), (40, 8)])
def test_batched_lanczos_max_matches_jax_and_eigvalsh(rng, B, n_candidates):
    """B under n_candidates (bisection on every member) and over it (the
    Gershgorin bound picks the candidates)."""
    K, r = 5, 3
    H = _psd_blocks(rng, B, K, r)
    v0 = np.ones((B, K)) + 0.01 * np.arange(K)
    v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    want = ju.batched_lanczos_max(
        lambda v: jnp.einsum("bkl,bl->bk", H, v), jnp.asarray(v0), r + 1,
        n_candidates=n_candidates)
    Ht = _t(H)
    got = tu.batched_lanczos_max(
        lambda v: torch.einsum("bkl,bl->bk", Ht, v), _t(v0), r + 1,
        n_candidates=n_candidates)
    _close(got, want)
    exact = np.linalg.eigvalsh(H)[:, -1].max()
    assert float(got) >= exact * (1 - 1e-8)
    if n_candidates >= B:
        _close(got, exact, dict(rtol=1e-8))


def test_tridiagonal_helpers_match_jax(rng):
    alphas, betas = rng.random((7, 4)) + 1, rng.random((7, 4))
    _close(tu.tridiag_gershgorin_max(_t(alphas), _t(betas)),
           ju.tridiag_gershgorin_max(jnp.asarray(alphas), jnp.asarray(betas)))
    got = tu._tridiag_max_eig(_t(alphas), _t(betas))
    _close(got, ju._tridiag_max_eig(jnp.asarray(alphas), jnp.asarray(betas)))
    T = [np.diag(a) + np.diag(b[:-1], 1) + np.diag(b[:-1], -1)
         for a, b in zip(alphas, betas)]
    _close(got, np.linalg.eigvalsh(np.stack(T))[:, -1], dict(rtol=1e-10))
    # k = 1: the diagonal itself
    _close(tu._tridiag_max_eig(_t(alphas[:, :1]), _t(betas[:, :1])),
           alphas[:, 0], dict(rtol=1e-12))


# ---------------------------------------------------------------------------
# utils: the shared ADMM update and its convergence test

TIGHT = dict(rtol=1e-12, atol=1e-14)


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("case", ["none", "one", "many"])
def test_update_variables_and_convergence_match_jax(rng, case):
    """No constraint, one constraint and M constraints: the update's six
    outputs and the convergence verdict with its errors."""
    n = 6
    c = rng.normal(size=n)
    x = rng.normal(size=n)
    L1, L2 = rng.normal(size=(4, n)), rng.normal(size=(5, n))

    def prox_f_t(v, s):
        return (v + s * _t(c)) / (1 + s)

    def prox_f_j(v, s):
        return (v + s * jnp.asarray(c)) / (1 + s)

    def pg_t(v, s):
        return torch.clamp_min(v, 0.0)

    def pg_j(v, s):
        return jnp.maximum(v, 0.0)

    step_f, e_rel, e_abs = 0.3, 1e-3, 1e-4
    if case == "none":
        args_t = (_t(x), _t(x), torch.zeros(n, dtype=torch.float64),
                  prox_f_t, step_f, None, None, tl.IdentityOperator())
        args_j = (jnp.asarray(x), jnp.asarray(x), jnp.zeros(n), prox_f_j,
                  step_f, None, None, jl.IdentityOperator())
        conv_sg = (None, None)
    elif case == "one":
        Lt, Lj = tl.MatrixOperator(_t(L1)), jl.MatrixOperator(L1)
        z, u = L1 @ x + 0.1, rng.normal(size=4)
        sg_t = tu.get_step_g(step_f, Lt.spectral_norm_sq)
        sg_j = ju.get_step_g(step_f, Lj.spectral_norm_sq)
        _close(sg_t, sg_j, TIGHT)
        args_t = (_t(x), _t(z), _t(u), prox_f_t, step_f, pg_t, sg_t, Lt)
        args_j = (jnp.asarray(x), jnp.asarray(z), jnp.asarray(u), prox_f_j,
                  step_f, pg_j, sg_j, Lj)
        conv_sg = (sg_t, sg_j)
    else:
        Lt = [tl.MatrixOperator(_t(L1)), tl.MatrixOperator(_t(L2))]
        Lj = [jl.MatrixOperator(L1), jl.MatrixOperator(L2)]
        z = [L1 @ x + 0.1, L2 @ x - 0.2]
        u = [rng.normal(size=4), rng.normal(size=5)]
        sg_t = [tu.get_step_g(step_f, L.spectral_norm_sq, M=2) for L in Lt]
        sg_j = [ju.get_step_g(step_f, L.spectral_norm_sq, M=2) for L in Lj]
        args_t = (_t(x), [_t(a) for a in z], [_t(a) for a in u], prox_f_t,
                  step_f, [pg_t, pg_t], sg_t, Lt)
        args_j = (jnp.asarray(x), [jnp.asarray(a) for a in z],
                  [jnp.asarray(a) for a in u], prox_f_j, step_f,
                  [pg_j, pg_j], sg_j, Lj)
        conv_sg = (sg_t, sg_j)
    out_t = tu.update_variables(*args_t)
    out_j = ju.update_variables(*args_j)
    assert len(out_t) == len(out_j) == 6
    for a, b in zip(_flat(out_t), _flat(out_j)):
        _close(a, b, TIGHT)
    X_t, Z_t, U_t, LX_t, R_t, S_t = out_t
    X_j, Z_j, U_j, LX_j, R_j, S_j = out_j
    wrap = (lambda v: list(v)) if case == "many" else (lambda v: v)
    c_t, e_t = tu.check_constraint_convergence(
        X_t, args_t[7], wrap(LX_t), wrap(Z_t), wrap(U_t), wrap(R_t),
        wrap(S_t), step_f, conv_sg[0], e_rel, e_abs)
    c_j, e_j = ju.check_constraint_convergence(
        X_j, args_j[7], wrap(LX_j), wrap(Z_j), wrap(U_j), wrap(R_j),
        wrap(S_j), step_f, conv_sg[1], e_rel, e_abs)
    assert isinstance(c_t, torch.Tensor) and c_t.dtype == torch.bool
    assert bool(c_t) == bool(c_j)
    for a, b in zip(_flat(e_t), _flat(e_j)):
        _close(a, b, TIGHT)
    assert all(isinstance(v, torch.Tensor) for v in
               (e_t if case != "many" else e_t[0]))


def test_initZU_l2_and_get_step_f_match_jax(rng):
    x = rng.normal(size=5)
    L = rng.normal(size=(3, 5))
    _close(tu.l2(_t(x)), ju.l2(jnp.asarray(x)), TIGHT)
    Z, U = tu.initZU(_t(x), tl.MatrixOperator(_t(L)))
    _close(Z, L @ x, TIGHT)
    assert not U.any() and U.shape == Z.shape
    Zs, Us = tu.initZU(_t(x), [tl.IdentityOperator(),
                               tl.MatrixOperator(_t(L))])
    assert len(Zs) == len(Us) == 2 and Zs[0].shape == (5,)
    for lR2, lS2 in ((100.0, 1.0), (1.0, 100.0), (1.0, 1.0)):
        _close(tu.get_step_f(0.5, lR2, lS2), ju.get_step_f(0.5, lR2, lS2),
               TIGHT)
