"""proxmin_tpu_torch.functional against proxmin_tpu.functional, on the same
NumPy inputs, in float64: one counterpart for each test of
tests/test_functional.py, with the problem written once in jnp and once in
torch.

``jax.vmap(solve)`` becomes ``torch.func.vmap(solve)``: the lanes
controller (solvers.common.run_lanes) runs every lane to its own stop, so
each batched test holds every lane it names against that lane's individual
solve, with iteration counts that differ across lanes.

Tolerances and their reasons:
- iterates: rtol 1e-12 where the JAX test uses it (the same operations in
  the same order); rtol 1e-9 (F64) where the two packages' reductions or
  BLAS summation orders differ (matrix products, the NMF Lipschitz power
  iterations, AdaProx's bias corrections);
- iteration counts and flags: equal;
- a factory against its driver in the port, and a batched lane against its
  individual solve: bitwise or rtol 1e-12 (the same body; vmap may reorder
  a batched reduction);
- implicit gradients: against the analytic ones and central differences at
  the JAX test's tolerances, and against JAX's gradients at rtol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu_torch as ptt
from proxmin_tpu import functional as jf
from proxmin_tpu import operators as jops
from proxmin_tpu_torch import functional as tf
from proxmin_tpu_torch import operators as tops

F64 = dict(rtol=1e-9, atol=1e-12)
EXACT = dict(rtol=1e-12, atol=0)
CENTER = np.array([1.0, 0.5])
vmap = torch.func.vmap


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _close(t, j, tol=F64):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **tol)


def j_disk(x, step, r=0.5):
    nrm = jnp.sqrt(jnp.sum(x ** 2))
    return jnp.where(nrm > r, x * (r / nrm), x)


def t_disk(x, step, r=0.5):
    nrm = torch.sqrt(torch.sum(x ** 2))
    return torch.where(nrm > r, x * (r / nrm), x)


def _grad_center(lib):
    c = jnp.asarray(CENTER) if lib is jnp else _t(CENTER)
    return lambda x: x - c


# --- make_pgm_solver ------------------------------------------------------

def test_functional_pgm_matches_driver():
    kw = dict(accelerated=True, e_rel=1e-10, max_iter=300)
    x, it, conv, div = tf.make_pgm_solver(
        _grad_center(torch), 0.5, prox=t_disk, **kw)(_t([-1.0, -1.0]))
    r = ptt.pgm(_t([-1.0, -1.0]), _grad_center(torch), 0.5, prox=t_disk,
                **kw)
    assert torch.equal(x, r.x) and int(it) == r.iterations
    assert tuple(conv.tolist()) == r.converged and not bool(div)
    assert it.dtype == torch.int32 and conv.shape == (1,)
    xj, itj, convj, _ = jax.jit(jf.make_pgm_solver(
        _grad_center(jnp), 0.5, prox=j_disk, **kw))(jnp.asarray([-1.0, -1.0]))
    _close(x, xj, EXACT)
    assert int(it) == int(itj) and bool(conv[0]) == bool(convj[0])


def test_functional_pgm_vmap_batch_of_problems():
    """A batch of problems in one call: every lane equals its individual
    solve, although the iteration counts differ."""
    centers = np.random.default_rng(3).normal(size=(16, 2))

    def solve_one(lib, disk):
        def solve(x0, c):
            mk = tf if lib is torch else jf
            return mk.make_pgm_solver(lambda x: x - c, 0.3, prox=disk,
                                      e_rel=1e-11, max_iter=400)(x0)
        return solve

    x0s = np.tile([-1.0, -1.0], (16, 1))
    xs, its, convs, divs = vmap(solve_one(torch, t_disk))(_t(x0s),
                                                         _t(centers))
    assert len(set(its.tolist())) > 1
    xj, itj, _, _ = jax.jit(jax.vmap(solve_one(jnp, j_disk)))(
        jnp.asarray(x0s), jnp.asarray(centers))
    _close(xs, xj, EXACT)
    assert its.tolist() == np.asarray(itj).tolist()
    for i in range(16):
        xi, iti, convi, _ = solve_one(torch, t_disk)(_t(x0s[i]),
                                                     _t(centers[i]))
        _close(xs[i], xi, EXACT)
        assert int(its[i]) == int(iti)
        assert torch.equal(convs[i], convi)


def test_functional_pgm_grad_none():
    def f_t(x):
        return 0.5 * torch.sum((x - _t(CENTER)) ** 2)

    def f_j(x):
        return 0.5 * jnp.sum((x - jnp.asarray(CENTER)) ** 2)

    x, it, conv, div = tf.make_pgm_solver(None, 0.5, f=f_t, e_rel=1e-10,
                                          max_iter=500)(_t([-1.0, -1.0]))
    np.testing.assert_allclose(x.numpy(), CENTER, atol=1e-8)
    xj, itj, _, _ = jax.jit(jf.make_pgm_solver(
        None, 0.5, f=f_j, e_rel=1e-10, max_iter=500))(
        jnp.asarray([-1.0, -1.0]))
    _close(x, xj, EXACT)
    assert int(it) == int(itj)
    assert not x.requires_grad


# --- make_adaprox_solver --------------------------------------------------

def test_functional_adaprox_matches_driver():
    kw = dict(scheme="amsgrad", e_rel=1e-8, max_iter=600)
    x, M, V, Vhat, it, conv, div = tf.make_adaprox_solver(
        _grad_center(torch), 0.1, **kw)(_t([-1.0, -1.0]))
    r = ptt.adaprox(_t([-1.0, -1.0]), _grad_center(torch), 0.1, **kw)
    assert torch.equal(x, r.x) and int(it) == r.iterations
    assert torch.equal(M[0], r.M[0]) and torch.equal(Vhat[0], r.Vhat[0])
    xj, Mj, _, _, itj, _, _ = jax.jit(jf.make_adaprox_solver(
        _grad_center(jnp), 0.1, **kw))(jnp.asarray([-1.0, -1.0]))
    _close(x, xj, EXACT)
    # the first moment has decayed to ~1e-9 and cancels
    _close(M[0], Mj[0], dict(rtol=1e-12, atol=1e-15))
    assert int(it) == int(itj)


def test_functional_adaprox_vmap():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(8, 3))

    def solve_one(mk):
        def solve(x0, c):
            return mk.make_adaprox_solver(lambda x: x - c, 0.2,
                                          scheme="adam", e_rel=1e-9,
                                          max_iter=800)(x0)
        return solve

    z = torch.zeros(8, 3, dtype=torch.float64)
    xs, _, _, _, its, _, _ = vmap(solve_one(tf))(z, _t(centers))
    np.testing.assert_allclose(xs.numpy(), centers, atol=1e-4)
    xj, *_, itj, _, _ = jax.jit(jax.vmap(solve_one(jf)))(
        jnp.zeros((8, 3)), jnp.asarray(centers))
    _close(xs, xj)
    assert its.tolist() == np.asarray(itj).tolist()
    for i in (0, 7):
        xi, *_, iti, _, _ = solve_one(tf)(torch.zeros(3, dtype=torch.float64),
                                          _t(centers[i]))
        _close(xs[i], xi, EXACT)
        assert int(its[i]) == int(iti)


def test_functional_adaprox_validates_b1_schedule():
    """A short b1 schedule raises, as the drivers do (ValueError in the
    port, AssertionError in the JAX package)."""
    with pytest.raises(ValueError, match="b1 schedule"):
        tf.make_adaprox_solver(lambda x: x, 0.1,
                               b1=np.linspace(0.9, 0.5, 100), max_iter=1000)
    with pytest.raises(AssertionError):
        jf.make_adaprox_solver(lambda x: x, 0.1,
                               b1=np.linspace(0.9, 0.5, 100), max_iter=1000)


# --- make_differentiable_pgm_solver ---------------------------------------

def _tgrad(loss, theta):
    """``d loss / d theta`` at a NumPy ``theta``, by torch.autograd."""
    th = _t(theta).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(th), th)
    return g.numpy()


def test_implicit_diff_interior_and_boundary():
    """The implicit gradient matches the analytic and the finite-difference
    ones, inside and on the constraint's boundary, and JAX's."""
    w = np.array([1.0, 2.0])
    solve = tf.make_differentiable_pgm_solver(lambda x, th: x - th, 0.7,
                                              prox=t_disk)
    solve_j = jf.make_differentiable_pgm_solver(lambda x, th: x - th, 0.7,
                                                prox=j_disk)

    def loss(theta):
        return torch.sum(solve(torch.zeros(2, dtype=torch.float64),
                               theta)[0] * _t(w))

    def loss_j(theta):
        return jnp.sum(solve_j(jnp.zeros(2), theta)[0] * jnp.asarray(w))

    # interior: x* = theta -> dloss/dtheta = w
    g = _tgrad(loss, [0.1, 0.2])
    np.testing.assert_allclose(g, w, atol=1e-6)
    # boundary: x* = r theta / ||theta||
    th = np.array([1.0, 0.7])
    g = _tgrad(loss, th)
    eps = 1e-6
    with torch.no_grad():
        fd = [(loss(_t(th + eps * np.eye(2)[i]))
               - loss(_t(th - eps * np.eye(2)[i]))).item() / (2 * eps)
              for i in range(2)]
    np.testing.assert_allclose(g, fd, atol=1e-5)
    _close(g, jax.grad(loss_j)(jnp.asarray(th)), dict(rtol=1e-6))


def test_implicit_diff_composes_with_jit_vmap():
    """The JAX test takes ``jax.vmap(jax.grad(loss))``; so does the port,
    with ``torch.func.vmap(torch.func.grad(loss))``."""
    def grad_t(x, theta):
        return 2.0 * (x - theta)

    solve = tf.make_differentiable_pgm_solver(grad_t, 0.4)
    solve_j = jf.make_differentiable_pgm_solver(
        lambda x, theta: 2.0 * (x - theta), 0.4)
    ths = np.random.default_rng(0).normal(size=(5, 3))
    gs = vmap(torch.func.grad(lambda th: torch.sum(solve(
        torch.zeros(3, dtype=torch.float64), th)[0] ** 2)))(_t(ths))
    np.testing.assert_allclose(gs, 2 * ths, atol=1e-6)
    gj = jax.jit(jax.vmap(jax.grad(lambda th: jnp.sum(
        solve_j(jnp.zeros(3), th)[0] ** 2))))(jnp.asarray(ths))
    _close(gs, gj, dict(rtol=1e-6, atol=1e-12))


def test_implicit_diff_hyperparameter_learning():
    """Bilevel: gradient descent of an outer loss over the inner solve's
    data, through ``.backward()`` in an outer loop."""
    target = np.array([0.3, -0.1, 0.4])
    # torch.maximum (prox_plus) splits the gradient of a tie as
    # jnp.maximum does; clamp_min would pass all of it
    solve = tf.make_differentiable_pgm_solver(
        lambda x, th: x - th, 0.8, prox=tops.prox_plus)
    solve_j = jf.make_differentiable_pgm_solver(
        lambda x, th: x - th, 0.8, prox=lambda z, s: jnp.maximum(z, 0))

    theta = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    for _ in range(200):
        theta.grad = None
        outer = 0.5 * torch.sum((solve(torch.zeros(3, dtype=torch.float64),
                                       theta)[0] - _t(target)) ** 2)
        outer.backward()
        with torch.no_grad():
            theta -= 0.5 * theta.grad
    x_final, conv = solve(torch.zeros(3, dtype=torch.float64),
                          theta.detach())
    assert bool(conv)
    np.testing.assert_allclose(x_final.numpy(), np.maximum(target, 0),
                               atol=1e-4)

    og = jax.jit(jax.grad(lambda th: 0.5 * jnp.sum(
        (solve_j(jnp.zeros(3), th)[0] - jnp.asarray(target)) ** 2)))
    th_j = jnp.zeros(3)
    for _ in range(200):
        th_j = th_j - 0.5 * og(th_j)
    _close(theta.detach(), th_j, dict(rtol=1e-6, atol=1e-9))


def test_implicit_diff_learns_regularization_strength():
    """prox_params=True: the gradient flows through the regularizer, which
    learns the soft-threshold strength of a sparse denoise."""
    rng = np.random.default_rng(5)
    truth = np.array([0.0, 0.0, 1.0, 0.0, -0.7, 0.0, 0.4, 0.0])
    y = truth + 0.05 * rng.standard_normal(8)

    solve = tf.make_differentiable_pgm_solver(
        lambda x, lam: x - _t(y), 0.9,
        prox=lambda z, s, lam: tops.prox_soft(
            z, s, thresh=torch.nn.functional.softplus(lam)),
        prox_params=True)
    solve_j = jf.make_differentiable_pgm_solver(
        lambda x, lam: x - jnp.asarray(y), 0.9,
        prox=lambda z, s, lam: jops.prox_soft(z, s,
                                              thresh=jax.nn.softplus(lam)),
        prox_params=True)

    def outer(lam):
        return 0.5 * torch.sum((solve(torch.zeros(8, dtype=torch.float64),
                                      lam)[0] - _t(truth)) ** 2)

    lam = torch.tensor(-3.0, dtype=torch.float64)
    with torch.no_grad():
        l0 = outer(lam).item()
    for _ in range(300):
        lam = lam - 0.5 * torch.as_tensor(_tgrad(outer, lam))
    with torch.no_grad():
        l1 = outer(lam).item()
    assert l1 < 0.7 * l0, (l0, l1)
    eps = 1e-4
    with torch.no_grad():
        fd = (outer(lam + eps) - outer(lam - eps)).item() / (2 * eps)
    np.testing.assert_allclose(float(_tgrad(outer, lam)), fd, atol=1e-4)

    og = jax.jit(jax.grad(lambda lam: 0.5 * jnp.sum(
        (solve_j(jnp.zeros(8), lam)[0] - jnp.asarray(truth)) ** 2)))
    lam_j = jnp.asarray(-3.0)
    for _ in range(300):
        lam_j = lam_j - 0.5 * og(lam_j)
    _close(lam, lam_j, dict(rtol=1e-6))


def test_implicit_diff_multiblock_pytree_exact():
    """A tuple iterate (a coupled two-block problem with a known SPD joint
    Hessian): the implicit gradient is the analytic H^{-1} w."""
    rng = np.random.default_rng(0)
    na, ns = 3, 4
    Mx = rng.standard_normal((na + ns, na + ns))
    H = Mx @ Mx.T + 0.5 * np.eye(na + ns)
    Ht = _t(H)
    L = float(np.linalg.eigvalsh(H)[-1])
    w_a, w_s = rng.standard_normal(na), rng.standard_normal(ns)
    theta = rng.standard_normal(na + ns)

    def grad_t(x, th):
        a, s = x
        return (Ht[:na, :na] @ a + Ht[:na, na:] @ s - th[:na],
                Ht[:na, na:].T @ a + Ht[na:, na:] @ s - th[na:])

    solve = tf.make_differentiable_pgm_solver(grad_t, 0.9 / L, e_rel=1e-13,
                                              max_iter=20000,
                                              vjp_rtol=1e-13)

    def loss(th):
        z = functools.partial(torch.zeros, dtype=torch.float64)
        (a, s), conv = solve((z(na), z(ns)), th)
        assert isinstance(a, torch.Tensor) and bool(conv)
        return a @ _t(w_a) + s @ _t(w_s)

    g = _tgrad(loss, theta)
    gt = np.linalg.solve(H, np.concatenate([w_a, w_s]))
    np.testing.assert_allclose(g, gt, atol=1e-10)


def test_implicit_diff_ill_conditioned_adjoint_converges():
    """At condition number 100 the residual-stopped adjoint adapts its
    iteration count and returns the true gradient."""
    h = _t([1.0, 1e-2])
    solve = tf.make_differentiable_pgm_solver(lambda x, th: h * x - th, 0.9,
                                              max_iter=10000)
    g = _tgrad(lambda th: torch.sum(solve(
        torch.zeros(2, dtype=torch.float64), th)[0]), [0.3, 0.4])
    np.testing.assert_allclose(g, [1.0, 100.0], rtol=1e-6)


def test_implicit_diff_warns_when_the_adjoint_is_capped(caplog):
    """An adjoint stopped by vjp_iters short of vjp_rtol is a truncated
    gradient (the JAX solver returns it silently): the port logs it."""
    h = _t([1.0, 1e-2])
    th = _t([0.3, 0.4])
    z = torch.zeros(2, dtype=torch.float64)
    for cap, warned in ((10, True), (10000, False)):
        solve = tf.make_differentiable_pgm_solver(
            lambda x, t: h * x - t, 0.9, max_iter=10000, vjp_iters=cap)
        caplog.clear()
        with caplog.at_level("WARNING", logger="proxmin"):
            g = _tgrad(lambda t: torch.sum(solve(z, t)[0]), th)
        assert ("truncated" in caplog.text) == warned
        assert (abs(g[1] - 100.0) > 1.0) == warned


# --- make_nmf_solver ------------------------------------------------------

def _nmf_loss(A, S, Y, W=1.0):
    return float(0.5 * np.sum(W * (Y - A @ S) ** 2))


def _nmf_patchwise(weighted):
    """One call factorizes a batch of patch problems, each lane equal to
    its individual solve and to JAX's lane, every lane's loss falling."""
    rng = np.random.default_rng(9 if weighted else 3)
    B, C, K, N = (5, 4, 2, 48) if weighted else (6, 4, 2, 32)
    Ys = rng.random((B, C, K)) @ rng.random((B, K, N))
    Ws = 0.5 + rng.random((B, C, N)) if weighted else None
    A0s, S0s = rng.random((B, C, K)), rng.random((B, K, N))
    max_iter = 300 if weighted else 400
    args = (A0s, S0s, Ys) + ((Ws,) if weighted else ())

    solve = tf.make_nmf_solver(e_rel=1e-6, max_iter=max_iter,
                               weighted=weighted)
    As, Ss, its, convs = vmap(solve)(*map(_t, args))
    solve_j = jf.make_nmf_solver(e_rel=1e-6, max_iter=max_iter,
                                 weighted=weighted)
    Aj, Sj, itj, convj = jax.jit(jax.vmap(solve_j))(*map(jnp.asarray, args))
    _close(As, Aj)
    _close(Ss, Sj)
    assert its.tolist() == np.asarray(itj).tolist()
    assert convs.tolist() == np.asarray(convj).tolist()
    for b in (0, B - 1):
        Ab, Sb, itb, convb = solve(*(_t(a[b]) for a in args))
        _close(As[b], Ab, EXACT)
        _close(Ss[b], Sb, EXACT)
        assert int(its[b]) == int(itb) and bool(convs[b]) == bool(convb)
    for b in range(B):
        W = Ws[b] if weighted else 1.0
        l0 = _nmf_loss(A0s[b], S0s[b], Ys[b], W)
        l1 = _nmf_loss(As[b].numpy(), Ss[b].numpy(), Ys[b], W)
        assert l1 < (0.1 if weighted else 0.5) * l0


def test_make_nmf_solver_vmap_patchwise():
    _nmf_patchwise(weighted=False)


def test_make_nmf_solver_weighted_vmap():
    """Per-patch (Y, W) problems: the weighted bounds by power iterations,
    the per-pixel one warm-started across iterations."""
    _nmf_patchwise(weighted=True)


def test_lam_max_psd_batch_matches_jax():
    """The weighted path's batched power iteration (nmf._lam_max_psd_batch)
    against the JAX package's and the exact eigenvalue."""
    from proxmin_tpu import nmf as jnmf
    from proxmin_tpu_torch import nmf as tnmf

    rng = np.random.default_rng(2)
    G = rng.random((5, 3, 4))
    H = np.einsum("ckn,cln->ckl", G, G)
    got = tnmf._lam_max_psd_batch(_t(H), 64)
    _close(got, jnmf._lam_max_psd_batch(jnp.asarray(H), 64))
    np.testing.assert_allclose(float(got), np.linalg.eigvalsh(H)[:, -1].max(),
                               rtol=1e-10)


# --- make_admm_solver, make_sdmm_solver -----------------------------------

def test_functional_admm_matches_driver():
    def prox_f_t(v, step):
        return (v + step * _t(CENTER)) / (1.0 + step)

    def prox_f_j(v, step):
        return (v + step * jnp.asarray(CENTER)) / (1.0 + step)

    kw = dict(prox_g=t_disk, e_rel=1e-8, max_iter=500)
    x, it, conv, errors = tf.make_admm_solver(prox_f_t, 0.5, **kw)(
        _t([-1.0, -1.0]))
    r = ptt.admm(_t([-1.0, -1.0]), prox_f_t, 0.5, **kw)
    assert torch.equal(x, r.x) and int(it) == r.iterations
    assert bool(conv) == r.converged and errors.shape == (1, 4)
    assert tuple(errors[0].tolist()) == r.errors
    xj, itj, convj, errj = jax.jit(jf.make_admm_solver(
        prox_f_j, 0.5, prox_g=j_disk, e_rel=1e-8, max_iter=500))(
        jnp.asarray([-1.0, -1.0]))
    _close(x, xj, EXACT)
    _close(errors, errj, F64)
    assert int(it) == int(itj) and bool(conv) == bool(convj)


def test_functional_admm_refuses_L_without_prox_g():
    with pytest.raises(ValueError, match="pass prox_g or drop L"):
        tf.make_admm_solver(lambda v, s: v, 0.5, L=torch.eye(2))
    with pytest.raises(ValueError, match="pass prox_g or drop L"):
        jf.make_admm_solver(lambda v, s: v, 0.5, L=jnp.eye(2))


def test_functional_admm_vmap_tv_denoise_batch():
    """A batch of 1-D TV denoises (quadratic fidelity, soft threshold on
    first differences through L) in one call; every lane equals its
    individual solve."""
    rng = np.random.default_rng(7)
    B, n = 8, 32
    ys = (np.cumsum(rng.normal(size=(B, n)), axis=1)
          + 0.3 * rng.normal(size=(B, n)))
    D = np.eye(n)[1:] - np.eye(n)[:-1]

    def solve_one(mk, lib_ops, Dm):
        def solve(x0, y):
            def prox_f(v, step):
                return (v + step * y) / (1.0 + step)

            return mk.make_admm_solver(
                prox_f, 0.4,
                prox_g=functools.partial(lib_ops.prox_soft, thresh=0.5),
                L=Dm, e_rel=1e-9, max_iter=600)(x0)
        return solve

    solve_t = solve_one(tf, tops, _t(D))
    xs, its, convs, errs = vmap(solve_t)(_t(ys), _t(ys))
    assert len(set(its.tolist())) > 1
    xj, itj, convj, _ = jax.jit(jax.vmap(solve_one(jf, jops, jnp.asarray(D))))(
        jnp.asarray(ys), jnp.asarray(ys))
    _close(xs, xj)
    assert its.tolist() == np.asarray(itj).tolist()
    assert convs.tolist() == np.asarray(convj).tolist()
    for b in (0, 3, B - 1):
        xb, itb, convb, errb = solve_t(_t(ys[b]), _t(ys[b]))
        _close(xs[b], xb, dict(rtol=1e-11, atol=1e-12))
        _close(errs[b], errb, dict(rtol=1e-11, atol=1e-12))
        assert int(its[b]) == int(itb) and bool(convs[b]) == bool(convb)


def test_functional_admm_vmap_restarts_per_lane():
    """The slack restart under vmap: the lanes whose iterate stalls short of
    convergence restart on their own (halved slack, clock reset) until the
    work cap, while a lane that converges stops; each lane equals its
    individual solve."""
    def solve_one(x0, c, g):
        # constant proxs: the iterate stalls at once; it converges only
        # where g = c (no primal residual)
        return tf.make_admm_solver(lambda v, s: c + 0 * v, 0.5,
                                   prox_g=lambda v, s: g + 0 * v,
                                   e_rel=1e-6, max_iter=50)(x0)

    cs = _t([[0.3, 0.3], [0.3, 0.3], [-0.2, 0.1]])
    gs = _t([[9.0, 9.0], [0.3, 0.3], [2.0, -1.0]])
    x0s = torch.zeros(3, 2, dtype=torch.float64)
    xs, its, convs, _ = vmap(solve_one)(x0s, cs, gs)
    assert convs.tolist() == [False, True, False]
    for b in range(3):
        xb, itb, convb, _ = solve_one(x0s[b], cs[b], gs[b])
        _close(xs[b], xb, EXACT)
        assert int(its[b]) == int(itb) and bool(convs[b]) == bool(convb)
        r = ptt.admm(x0s[b], lambda v, s: cs[b] + 0 * v, 0.5,
                     prox_g=lambda v, s: gs[b] + 0 * v, e_rel=1e-6,
                     max_iter=50)
        assert int(its[b]) == r.iterations
        assert (r.slack < 1) == (b != 1)  # restarts where it stalled


def test_functional_sdmm_matches_driver_and_vmap():
    def half_t(v, step):
        return torch.cat([torch.clamp_min(v[:1], 0.15), v[1:]])

    def half_j(v, step):
        return v.at[0].set(jnp.maximum(v[0], 0.15))

    centers = np.random.default_rng(11).normal(size=(6, 2))

    def solve_one(mk, disk, half):
        def solve(x0, c):
            def prox_f(v, step):
                return (v + step * c) / (1.0 + step)

            return mk.make_sdmm_solver(prox_f, 0.5, proxs_g=[disk, half],
                                       e_rel=1e-9, max_iter=800)(x0)
        return solve

    solve_t = solve_one(tf, t_disk, half_t)
    x, it, conv, errors = solve_t(_t([-1.0, -1.0]), _t(CENTER))
    r = ptt.sdmm(_t([-1.0, -1.0]),
                 lambda v, s: (v + s * _t(CENTER)) / (1.0 + s), 0.5,
                 proxs_g=[t_disk, half_t], e_rel=1e-9, max_iter=800)
    assert torch.equal(x, r.x) and int(it) == r.iterations
    assert errors.shape == (2, 4)
    xj, itj, _, errj = jax.jit(solve_one(jf, j_disk, half_j))(
        jnp.asarray([-1.0, -1.0]), jnp.asarray(CENTER))
    _close(x, xj, EXACT)
    _close(errors, errj)
    assert int(it) == int(itj)

    x0s = np.tile([-1.0, -1.0], (6, 1))
    xs, its, _, _ = vmap(solve_t)(_t(x0s), _t(centers))
    xsj, itsj, _, _ = jax.jit(jax.vmap(solve_one(jf, j_disk, half_j)))(
        jnp.asarray(x0s), jnp.asarray(centers))
    _close(xs, xsj, EXACT)
    assert its.tolist() == np.asarray(itsj).tolist()
    for b in (0, 5):
        xb, itb, _, _ = solve_t(_t(x0s[b]), _t(centers[b]))
        _close(xs[b], xb, dict(rtol=1e-11, atol=1e-12))
        assert int(its[b]) == int(itb)


# --- make_bsdmm_solver ----------------------------------------------------

C1, C2 = np.array([1.0, -0.5]), np.array([0.2, 0.8, -0.1])


def _bsdmm_pieces(lib, scale=1.0):
    arr = _t if lib is torch else jnp.asarray
    maximum = ((lambda v: torch.clamp_min(v, 0)) if lib is torch
               else (lambda v: jnp.maximum(v, 0)))

    def proxs_f(x, step, Xs=None, j=None):
        c = scale * arr([C1, C2][j])
        return (x + step * c) / (1 + step)

    def pg(v, step):
        return maximum(v)

    return proxs_f, (lambda Xs, j=None: 0.4), [[pg], [pg, pg]]


def test_functional_bsdmm_matches_driver_and_vmap():
    pf, steps, pgs = _bsdmm_pieces(torch)
    solve = tf.make_bsdmm_solver(pf, steps, proxs_g=pgs, e_rel=1e-9,
                                 max_iter=200)
    z = functools.partial(torch.zeros, dtype=torch.float64)
    xs, it, conv = solve(z(2), z(3))
    r = ptt.bsdmm([z(2), z(3)], pf, steps, proxs_g=pgs, e_rel=1e-9,
                  max_iter=200)
    assert all(torch.equal(a, b) for a, b in zip(xs, r.x))
    assert int(it) == r.iterations and tuple(conv.tolist()) == r.converged
    solve(z(2), z(3))  # a second call reuses the memoized program
    pfj, stepsj, pgsj = _bsdmm_pieces(jnp)
    xj, itj, convj = jax.jit(jf.make_bsdmm_solver(
        pfj, stepsj, proxs_g=pgsj, e_rel=1e-9, max_iter=200))(
        jnp.zeros(2), jnp.zeros(3))
    for a, b in zip(xs, xj):
        _close(a, b, EXACT)
    assert int(it) == int(itj)
    assert conv.tolist() == np.asarray(convj).tolist()

    scales = [0.5, 1.0, 1.7, 2.4]

    def solve_one(mk, lib):
        def run(s):
            pf_s, st_s, pg_s = _bsdmm_pieces(lib, s)
            zz = (z(2), z(3)) if lib is torch else (jnp.zeros(2),
                                                   jnp.zeros(3))
            return mk.make_bsdmm_solver(pf_s, st_s, proxs_g=pg_s,
                                        e_rel=1e-9, max_iter=200)(*zz)
        return run

    xsb, itsb, _ = vmap(solve_one(tf, torch))(_t(scales))
    xsj, itsj, _ = jax.jit(jax.vmap(solve_one(jf, jnp)))(jnp.asarray(scales))
    for a, b in zip(xsb, xsj):
        _close(a, b, dict(rtol=1e-11, atol=1e-14))
    assert itsb.tolist() == np.asarray(itsj).tolist()
    for b in (0, 3):
        xb, itb, _ = solve_one(tf, torch)(_t(scales[b]))
        _close(xsb[0][b], xb[0], dict(rtol=1e-11))
        _close(xsb[1][b], xb[1], dict(rtol=1e-11))
        assert int(itsb[b]) == int(itb)


# --- the differentiable ADMM family ---------------------------------------

def _fd_check(loss, theta0, coords, eps, rtol, g):
    for i in coords:
        e = np.zeros_like(theta0)
        e[i] = eps
        with torch.no_grad():
            fd = (loss(_t(theta0 + e)) - loss(_t(theta0 - e))).item() / (
                2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=rtol, atol=1e-7)


def test_implicit_diff_admm_gradient_vs_finite_differences():
    n = 12
    rng = np.random.default_rng(4)
    y = rng.normal(size=n)
    D = np.eye(n)[1:] - np.eye(n)[:-1]
    kw = dict(L=None, e_rel=1e-12, max_iter=20000, vjp_rtol=1e-12,
              prox_params=True)
    solve = tf.make_differentiable_admm_solver(
        lambda v, s, th: (v + s * (_t(y) + th)) / (1.0 + s), 0.5,
        lambda v, s, th: tops.prox_soft(v, s, thresh=0.3),
        **dict(kw, L=_t(D)))
    solve_j = jf.make_differentiable_admm_solver(
        lambda v, s, th: (v + s * (jnp.asarray(y) + th)) / (1.0 + s), 0.5,
        lambda v, s, th: jops.prox_soft(v, s, thresh=0.3),
        **dict(kw, L=jnp.asarray(D)))

    def loss(theta):
        return torch.sum(solve(torch.zeros(n, dtype=torch.float64),
                               theta)[0] ** 3)

    theta0 = rng.normal(size=n) * 0.1
    x0, conv = solve(torch.zeros(n, dtype=torch.float64), _t(theta0))
    assert bool(conv)
    g = _tgrad(loss, theta0)
    _fd_check(loss, theta0, (0, 5, n - 1), 1e-5, 2e-4, g)
    gj = jax.grad(lambda th: jnp.sum(solve_j(jnp.zeros(n), th)[0] ** 3))(
        jnp.asarray(theta0))
    _close(g, gj, dict(rtol=1e-6, atol=1e-10))


def test_implicit_diff_admm_learns_regularizer():
    """Learn a soft-threshold strength through the differentiable ADMM:
    gradient descent on lambda improves the fit to a clean target."""
    n = 32
    rng = np.random.default_rng(12)
    truth = np.repeat(rng.normal(size=4), n // 4)
    y = truth + 0.2 * rng.normal(size=n)
    D = np.eye(n)[1:] - np.eye(n)[:-1]
    solve = tf.make_differentiable_admm_solver(
        lambda v, s, lam: (v + s * _t(y)) / (1.0 + s), 0.5,
        lambda v, s, lam: tops.prox_soft(
            v, s, thresh=torch.nn.functional.softplus(lam)),
        L=_t(D), e_rel=1e-10, max_iter=20000, vjp_rtol=1e-10,
        prox_params=True)

    def objective(lam):
        x, _ = solve(_t(y), lam)
        return torch.mean((x - _t(truth)) ** 2)

    lam = torch.tensor(-3.0, dtype=torch.float64)
    with torch.no_grad():
        mse0 = objective(lam).item()
    # the JAX test takes 60 steps; the loss levels off at its optimum (mse
    # 0.37 of the start's) by the 25th, so 30 hold the same bound
    lams = []
    for _ in range(30):
        lam = lam - 20.0 * torch.as_tensor(_tgrad(objective, lam))
        lams.append(float(lam))
    with torch.no_grad():
        mse1 = objective(lam).item()
    assert mse1 < 0.5 * mse0, (mse0, mse1)

    solve_j = jf.make_differentiable_admm_solver(
        lambda v, s, lam: (v + s * jnp.asarray(y)) / (1.0 + s), 0.5,
        lambda v, s, lam: jops.prox_soft(v, s, thresh=jax.nn.softplus(lam)),
        L=jnp.asarray(D), e_rel=1e-10, max_iter=20000, vjp_rtol=1e-10,
        prox_params=True)
    og = jax.jit(jax.grad(lambda lam: jnp.mean(
        (solve_j(jnp.asarray(y), lam)[0] - jnp.asarray(truth)) ** 2)))
    lam_j = jnp.asarray(-3.0)
    for _ in range(5):
        lam_j = lam_j - 20.0 * og(lam_j)
    # the first steps against JAX's (later ones follow the same landscape)
    np.testing.assert_allclose(lams[4], float(lam_j), rtol=1e-6)


def test_implicit_diff_sdmm_gradient_vs_finite_differences():
    """Two simultaneous constraints: a soft threshold through a difference
    operator and a non-negativity projection."""
    n = 12
    rng = np.random.default_rng(4)
    y = rng.normal(size=n)
    D = np.eye(n)[1:] - np.eye(n)[:-1]
    kw = dict(e_rel=1e-12, max_iter=20000, vjp_rtol=1e-12, prox_params=True)
    solve = tf.make_differentiable_sdmm_solver(
        lambda v, s, th: (v + s * (_t(y) + th)) / (1.0 + s), 0.5,
        (lambda v, s, th: tops.prox_soft(v, s, thresh=0.2),
         lambda v, s, th: tops.prox_plus(v, s)), Ls=[_t(D), None], **kw)
    solve_j = jf.make_differentiable_sdmm_solver(
        lambda v, s, th: (v + s * (jnp.asarray(y) + th)) / (1.0 + s), 0.5,
        (lambda v, s, th: jops.prox_soft(v, s, thresh=0.2),
         lambda v, s, th: jops.prox_plus(v, s)), Ls=[jnp.asarray(D), None],
        **kw)

    def loss(theta):
        return torch.sum(solve(torch.zeros(n, dtype=torch.float64),
                               theta)[0] ** 3)

    theta0 = rng.normal(size=n) * 0.1
    assert bool(solve(torch.zeros(n, dtype=torch.float64), _t(theta0))[1])
    g = _tgrad(loss, theta0)
    _fd_check(loss, theta0, (0, 5, n - 1), 1e-5, 2e-4, g)
    gj = jax.grad(lambda th: jnp.sum(solve_j(jnp.zeros(n), th)[0] ** 3))(
        jnp.asarray(theta0))
    _close(g, gj, dict(rtol=1e-6, atol=1e-10))


def test_implicit_diff_bsdmm_gradient_vs_finite_differences():
    """Two coupled strongly convex blocks, one soft-thresholded: the
    implicit VJP through the Gauss-Seidel sweep."""
    n, alpha = 10, 0.5
    rng = np.random.default_rng(11)
    t1, t2 = rng.normal(size=n), rng.normal(size=n)

    def pieces(arr, soft):
        def proxs_f(v, step, theta, Xs=None, j=None):
            other = Xs[1 - j]
            target = (arr(t1) + theta) if j == 0 else arr(t2)
            return (v + step * (target + alpha * other)) / (
                1.0 + step * (1.0 + alpha))

        return proxs_f, [[lambda v, s, th: soft(v, s, thresh=0.15)], None]

    kw = dict(e_rel=1e-12, max_iter=30000, vjp_rtol=1e-12, prox_params=True)
    pf, pg = pieces(_t, tops.prox_soft)
    solve = tf.make_differentiable_bsdmm_solver(pf, 0.4, proxs_g=pg, **kw)
    pfj, pgj = pieces(jnp.asarray, jops.prox_soft)
    solve_j = jf.make_differentiable_bsdmm_solver(pfj, 0.4, proxs_g=pgj,
                                                  **kw)
    z = functools.partial(torch.zeros, n, dtype=torch.float64)

    def loss(theta):
        (x1, x2), _ = solve((z(), z()), theta)
        return torch.sum(x1 ** 3) + torch.sum(x1 * x2)

    theta0 = rng.normal(size=n) * 0.1
    assert bool(solve((z(), z()), _t(theta0))[1])
    g = _tgrad(loss, theta0)
    _fd_check(loss, theta0, (0, 4, n - 1), 1e-5, 5e-4, g)

    def loss_j(th):
        (x1, x2), _ = solve_j((jnp.zeros(n), jnp.zeros(n)), th)
        return jnp.sum(x1 ** 3) + jnp.sum(x1 * x2)

    _close(g, jax.grad(loss_j)(jnp.asarray(theta0)),
           dict(rtol=1e-6, atol=1e-10))


def test_differentiable_sdmm_matches_host_sdmm_forward():
    """The differentiable SDMM's forward pass lands on the host sdmm
    driver's fixed point, and on JAX's."""
    n = 8
    y = np.random.default_rng(3).normal(size=n)
    proxs_g = [tops.prox_plus, lambda v, s: tops.prox_max(v, s, thresh=1.0)]

    def prox_f(v, step):
        return (v + step * _t(y)) / (1.0 + step)

    x_d, conv = tf.make_differentiable_sdmm_solver(
        prox_f, 0.5, proxs_g, Ls=[None, None], e_rel=1e-13,
        max_iter=50000)(torch.zeros(n, dtype=torch.float64))
    assert bool(conv)
    res = ptt.sdmm(torch.zeros(n, dtype=torch.float64), prox_f, 0.5,
                   proxs_g=proxs_g, Ls=[None, None], e_rel=1e-12,
                   max_iter=50000)
    _close(x_d, res.x, dict(rtol=1e-6, atol=1e-8))
    xj, _ = jf.make_differentiable_sdmm_solver(
        lambda v, s: (v + s * jnp.asarray(y)) / (1.0 + s), 0.5,
        [jops.prox_plus, lambda v, s: jops.prox_max(v, s, thresh=1.0)],
        Ls=[None, None], e_rel=1e-13, max_iter=50000)(jnp.zeros(n))
    _close(x_d, xj, dict(rtol=1e-9, atol=1e-12))


# --- make_differentiable_adaprox_solver -----------------------------------

def test_implicit_diff_adaprox_gradient_vs_finite_differences():
    """Adam forward trajectory, PGM-condition backward: the gradient
    against central differences and JAX's."""
    n = 10
    rng = np.random.default_rng(11)
    y = rng.normal(size=n)
    kw = dict(e_rel=1e-12, max_iter=50000, vjp_rtol=1e-12)
    solve = tf.make_differentiable_adaprox_solver(
        lambda x, th: x - (_t(y) + th), 0.5,
        prox=lambda z, s: tops.prox_soft(z, s, thresh=0.25), **kw)
    solve_j = jf.make_differentiable_adaprox_solver(
        lambda x, th: x - (jnp.asarray(y) + th), 0.5,
        prox=lambda z, s: jops.prox_soft(z, s, thresh=0.25), **kw)

    def loss(theta):
        return torch.sum(solve(torch.zeros(n, dtype=torch.float64),
                               theta)[0] ** 3)

    theta0 = rng.normal(size=n) * 0.1
    assert bool(solve(torch.zeros(n, dtype=torch.float64), _t(theta0))[1])
    g = _tgrad(loss, theta0)
    _fd_check(loss, theta0, (0, 4, n - 1), 1e-5, 2e-4, g)
    gj = jax.grad(lambda th: jnp.sum(solve_j(jnp.zeros(n), th)[0] ** 3))(
        jnp.asarray(theta0))
    _close(g, gj, dict(rtol=1e-6, atol=1e-10))


def test_differentiable_adaprox_matches_pgm_solution():
    """The Adam forward pass lands on the PGM forward pass's fixed point,
    through a prox_params constraint, and both gradients agree."""
    n = 8
    rng = np.random.default_rng(5)
    y = rng.normal(size=n)

    def grad(x, theta):
        return 2.0 * (x - _t(y)) + theta

    def prox(z, step, theta):
        return tops.prox_plus(z, step)

    kw = dict(prox=prox, e_rel=1e-12, max_iter=50000, prox_params=True)
    s_ada = tf.make_differentiable_adaprox_solver(grad, 0.4, **kw)
    s_pgm = tf.make_differentiable_pgm_solver(grad, 0.4, **kw)
    theta0 = _t(rng.normal(size=n) * 0.3)
    z = torch.zeros(n, dtype=torch.float64)
    xa, ca = s_ada(z, theta0)
    xp, cp = s_pgm(z, theta0)
    assert bool(ca) and bool(cp)
    _close(xa, xp, dict(rtol=1e-7, atol=1e-9))
    ga = _tgrad(lambda t: torch.sum(s_ada(z, t)[0] ** 2), theta0)
    gp = _tgrad(lambda t: torch.sum(s_pgm(z, t)[0] ** 2), theta0)
    _close(ga, gp, dict(rtol=1e-5, atol=1e-8))
    xj, _ = jf.make_differentiable_adaprox_solver(
        lambda x, th: 2.0 * (x - jnp.asarray(y)) + th, 0.4,
        prox=lambda z_, s, th: jops.prox_plus(z_, s), e_rel=1e-12,
        max_iter=50000, prox_params=True)(jnp.zeros(n),
                                          jnp.asarray(theta0.numpy()))
    _close(xa, xj, dict(rtol=1e-7, atol=1e-9))


def test_functional_entry_points_refuse_data_dependent_loops_under_vmap():
    """Backtracking's halvings and AdaProx's prox sub-iterations depend on
    each lane's data: under vmap they run as rounds over the lanes (they
    were refused before the lanes controller ran them), and each lane
    equals its own solve."""
    x0s = _t([[0.0, 0.0], [2.0, -1.0], [0.5, 4.0]])
    cs = _t([[1.0, 1.0], [3.0, 0.5], [-1.0, 2.0]])

    def pgm_bt(x0, c):
        return tf.make_pgm_solver(
            lambda x: 3.0 * (x - c), 1.0, backtracking=True,
            f=lambda x: 1.5 * torch.sum((x - c) ** 2), e_rel=1e-10,
            max_iter=200)(x0)

    def ada(x0, c):
        return tf.make_adaprox_solver(lambda x: x - c, 0.1, prox=t_disk,
                                      e_rel=1e-8, max_iter=300)(x0)

    x, it, conv, _ = vmap(pgm_bt)(x0s, cs)
    xa, *_, ita, conva, _ = vmap(ada)(x0s, cs)
    assert bool(conv.all()) and 1 <= int(it.max()) < 200
    for i in range(3):
        xi, iti, convi, _ = pgm_bt(x0s[i], cs[i])
        _close(x[i], xi, EXACT)
        assert int(it[i]) == int(iti) and torch.equal(conv[i], convi)
        xai, *_, itai, convai, _ = ada(x0s[i], cs[i])
        _close(xa[i], xai, EXACT)
        assert int(ita[i]) == int(itai) and torch.equal(conva[i], convai)
    # a separable prox runs inside vmap as before
    x, *_ = vmap(tf.make_adaprox_solver(
        lambda x: x - 1.0, 0.1, prox=tops.prox_plus, separable_prox=True,
        max_iter=50))(x0s)
    assert x.shape == (3, 2)


def test_functional_numpy_inputs_need_a_device():
    """NumPy inputs go to the card unless the factory names a device."""
    solve = tf.make_pgm_solver(lambda x: x - 1.0, 0.5, max_iter=20,
                               device="cpu")
    x, it, conv, div = solve(np.zeros(2))
    assert x.device.type == "cpu" and int(it) <= 20
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            tf.make_pgm_solver(lambda x: x - 1.0, 0.5)(np.zeros(2))
