"""The auto-SPMD routes of proxmin_tpu_torch against proxmin_tpu's, in one
process: the ordinary drivers on sharded ``DTensor`` inputs.

Counterparts of the auto-SPMD tests of ``tests/test_sharding.py``. The port
runs on a one-rank gloo group made through a ``FileStore`` under the
test's temporary directory (no port is opened), on the CPU, in float64.
Each route is held against the JAX package on a one-device mesh at rtol
1e-9 with equal ``iterations``, ``converged`` and ``status``, and against
the port's own single-device solve at the JAX suite's tolerances (rtol
1e-9 / atol 1e-12; bsdmm 1e-8 / 1e-10). The five functional factories run
on ``DTensor`` inputs, and a solve under ``mesh=`` resumes bit for bit
through ``state=`` and through a checkpoint. Two and four ranks, and the
collective-layout audit, run in ``test_torch_distributed.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

import proxmin_tpu as pt
import proxmin_tpu.parallel as jpar
import proxmin_tpu_torch as ptt
import proxmin_tpu_torch.parallel as tpar
from proxmin_tpu_torch import functional as tfn
from proxmin_tpu_torch import operators as top
from proxmin_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

F64 = dict(rtol=1e-9, atol=0)
SINGLE = dict(rtol=1e-9, atol=1e-12)
SINGLE_B = dict(rtol=1e-8, atol=1e-10)
SCHEMES = ("adam", "nadam", "amsgrad", "padam", "adamx", "radam")


@pytest.fixture(scope="module", autouse=True)
def _group(tmp_path_factory):
    """One gloo rank for the whole module, through a file store."""
    store = tmp_path_factory.mktemp("store") / "store"
    tpar.initialize_distributed(f"file://{store}", 1, 0)
    yield
    dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def problem(rng):
    C, N, K = 6, 64, 3
    A_true = rng.random((C, K))
    S_true = rng.random((K, N))
    Y = A_true @ S_true + 0.01 * rng.standard_normal((C, N))
    return Y, rng.random((C, K)), rng.random((K, N))


def _mesh(shape=None):
    return tpar.make_mesh(shape, device="cpu")


def _jmesh(shape=(1,)):
    return jpar.make_mesh(shape, devices=jax.devices("cpu")[:1])


def _np(x):
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _held(rt, rj, tol=F64):
    """A port solve against a JAX solve: iterates, iterations, flags."""
    xt = rt.x if isinstance(rt.x, (tuple, list)) else (rt.x,)
    xj = rj.x if isinstance(rj.x, (tuple, list)) else (rj.x,)
    for t, j in zip(xt, xj):
        np.testing.assert_allclose(_np(t), np.asarray(j), **tol)
    assert rt.iterations == rj.iterations
    assert np.array_equal(np.asarray(rt.converged, dtype=object),
                          np.asarray(rj.converged, dtype=object))
    assert rt.status == rj.status


def _x_sharded(x, mesh, jmesh, two_d=False):
    """``x`` over the pixel axis (and the channel axis over ``model`` on a
    2-D mesh) in both packages."""
    spec = P("model", "data") if two_d else P(None, "data")
    placements = [Shard(1), Shard(0)] if two_d else [Shard(1)]
    xt = distribute_tensor(torch.from_numpy(x.copy()), mesh, placements)
    xj = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, spec))
    return xt, xj


def test_nmf_on_sharded_inputs(problem):
    """nmf() on the DTensors of shard_nmf_problem runs the ordinary driver
    (tests/test_sharding.py:59): equal to JAX's on sharded inputs and to
    the port's single-device solve; the factors stay laid out as given."""
    Y, A0, S0 = problem
    Yt, At, St, _ = tpar.shard_nmf_problem(_mesh(), Y, A0, S0)
    Yj, Aj, Sj, _ = jpar.shard_nmf_problem(_jmesh(), Y, A0, S0)
    rt = ptt.nmf.nmf(Yt, At, St, e_rel=0, max_iter=20)
    rj = pt.nmf.nmf(Yj, Aj, Sj, e_rel=0, max_iter=20)
    _held(rt, rj)
    assert [x.placements for x in rt.x] == [At.placements, St.placements]
    single = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=20,
                         device="cpu")
    for t, s in zip(rt.x, single.x):
        np.testing.assert_allclose(_np(t), s.numpy(), **SINGLE)


def test_auto_sharded_adaprox(problem):
    """The adaprox driver on sharded inputs (tests/test_sharding.py:265)."""
    Y, A0, S0 = problem
    Yt, At, St, _ = tpar.shard_nmf_problem(_mesh(), Y, A0, S0)
    Yj, Aj, Sj, _ = jpar.shard_nmf_problem(_jmesh(), Y, A0, S0)
    rt = ptt.nmf.nmf(Yt, At, St, algorithm="adaprox", e_rel=0, max_iter=15)
    rj = pt.nmf.nmf(Yj, Aj, Sj, algorithm="adaprox", e_rel=0, max_iter=15)
    _held(rt, rj)


def test_auto_spmd_accelerated_converges(problem):
    """FISTA under mesh= along a trajectory that converges: both factors'
    steps at half their Lipschitz bounds, to e_rel 1e-5 (716 iterations
    on this problem). Finite iterates, equal to JAX's nmf(mesh=) at rtol
    1e-9 with equal iterations and status, and to the port's single-device
    solve; the route's restart and momentum run on DTensor blocks."""
    Y, A0, S0 = problem

    def half(step_pgm):
        return lambda *X, it=None: tuple(0.5 * s for s in step_pgm(*X))

    kw = dict(accelerated=True, e_rel=1e-5, max_iter=2000)
    A1, S1 = A0.copy(), S0.copy()
    rj = pt.nmf.nmf(Y, A1, S1, mesh=_jmesh(), step=half(pt.nmf.step_pgm),
                    **kw)
    A2, S2 = A0.copy(), S0.copy()
    rt = ptt.nmf.nmf(Y, A2, S2, mesh=_mesh(), step=half(ptt.nmf.step_pgm),
                     **kw)
    assert rt.status == "converged" and 100 < rt.iterations < 2000
    assert all(bool(torch.isfinite(x.to_local()).all()) for x in rt.x)
    _held(rt, rj)
    np.testing.assert_allclose(A2, A1, **F64)
    np.testing.assert_allclose(S2, S1, **F64)
    single = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), device="cpu",
                         step=half(ptt.nmf.step_pgm), **kw)
    assert single.iterations == rt.iterations
    for t, s in zip(rt.x, single.x):
        np.testing.assert_allclose(_np(t), s.numpy(), **SINGLE)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_adaprox_schemes_under_mesh(problem, scheme):
    """nmf(mesh=, algorithm='adaprox') for each scheme: adam takes the
    explicit sharded solve (its state says so) and the other five the
    auto-SPMD route, in both packages; NumPy inputs take the result."""
    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    rj = pt.nmf.nmf(Y, A1, S1, algorithm="adaprox", scheme=scheme, e_rel=0,
                    max_iter=15, mesh=_jmesh())
    A2, S2 = A0.copy(), S0.copy()
    rt = ptt.nmf.nmf(Y, A2, S2, algorithm="adaprox", scheme=scheme, e_rel=0,
                     max_iter=15, mesh=_mesh())
    np.testing.assert_allclose(A2, A1, **F64)
    np.testing.assert_allclose(S2, S1, **F64)
    assert rt.iterations == rj.iterations == 15
    kind = getattr(rt, "state", {}).get("kind")
    assert (kind == "nmf_adaprox_sharded") == (scheme == "adam")
    single = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="adaprox",
                         scheme=scheme, e_rel=0, max_iter=15, device="cpu")
    for t, s in zip((A2, S2), single.x):
        np.testing.assert_allclose(t, s.numpy(), **SINGLE)


def test_nonseparable_falls_back(problem):
    """separable_prox=False keeps the auto-SPMD route, with the prox
    sub-iterations (tests/test_sharding.py:1000)."""
    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    rj = pt.nmf.nmf(Y, A1, S1, algorithm="adaprox", e_rel=0, max_iter=15,
                    separable_prox=False, mesh=_jmesh())
    A2, S2 = A0.copy(), S0.copy()
    rt = ptt.nmf.nmf(Y, A2, S2, algorithm="adaprox", e_rel=0, max_iter=15,
                     separable_prox=False, mesh=_mesh())
    assert rt.state.get("kind") != "nmf_adaprox_sharded"
    np.testing.assert_allclose(A2, A1, **F64)
    np.testing.assert_allclose(S2, S1, **F64)
    assert rt.sub_iterations == tuple(rj.sub_iterations)


def _prox_f_pair():
    def prox_f_t(v, step):
        return (v + step) / (1 + step)   # prox of 0.5||v - 1||^2

    def prox_f_j(v, step):
        return (v + step) / (1 + step)

    return prox_f_t, prox_f_j


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_auto_sharded_admm(problem, two_d):
    """admm on a pixel-sharded x (tests/test_sharding.py:314), and on a 2-D
    mesh with both of x's axes sharded (:416)."""
    Y, _, S0 = problem
    x = Y.copy() if two_d else S0.copy()
    mesh, jmesh = (_mesh((1, 1)), _jmesh((1, 1))) if two_d else (_mesh(),
                                                                 _jmesh())
    xt, xj = _x_sharded(x, mesh, jmesh, two_d)
    pf_t, pf_j = _prox_f_pair()
    it = 300 if two_d else 500
    rt = ptt.admm(xt, pf_t, 0.5, prox_g=lambda v, s: torch.clamp_max(v, 0.8),
                  e_rel=1e-6, max_iter=it)
    rj = pt.admm(xj, pf_j, 0.5, prox_g=lambda v, s: jnp.minimum(v, 0.8),
                 e_rel=1e-6, max_iter=it)
    assert isinstance(rt.x, DTensor) and rt.x.placements == xt.placements
    np.testing.assert_allclose(_np(rt.x), np.asarray(rj.x), rtol=1e-9,
                               atol=1e-12)
    assert rt.iterations == rj.iterations
    plain = ptt.admm(torch.from_numpy(x.copy()), pf_t, 0.5,
                     prox_g=lambda v, s: torch.clamp_max(v, 0.8),
                     e_rel=1e-6, max_iter=it)
    np.testing.assert_array_equal(_np(rt.x), plain.x.numpy())


def test_auto_sharded_sdmm(problem):
    """sdmm with two constraints on a pixel-sharded x
    (tests/test_sharding.py:392)."""
    _, _, S0 = problem
    xt, xj = _x_sharded(S0.copy(), _mesh(), _jmesh())
    pf_t, pf_j = _prox_f_pair()
    rt = ptt.sdmm(xt, pf_t, 0.5, proxs_g=[
        lambda v, s: torch.clamp_max(v, 0.8), top.prox_plus],
        e_rel=1e-6, max_iter=300)
    rj = pt.sdmm(xj, pf_j, 0.5, proxs_g=[
        lambda v, s: jnp.minimum(v, 0.8), pt.operators.prox_plus],
        e_rel=1e-6, max_iter=300)
    np.testing.assert_allclose(_np(rt.x), np.asarray(rj.x), rtol=1e-9,
                               atol=1e-12)
    assert rt.iterations == rj.iterations


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_auto_sharded_bsdmm_cmf(problem, rng, two_d):
    """bsdmm-backed CMF on sharded inputs: weighted on the 1-D mesh
    (tests/test_sharding.py:359), unweighted on a data x model mesh with
    the channel axis sharded (:377)."""
    Y, A0, S0 = problem
    W = None if two_d else 0.5 + rng.random(Y.shape)
    model = "model" if two_d else None
    mesh, jmesh = (_mesh((1, 1)), _jmesh((1, 1))) if two_d else (_mesh(),
                                                                 _jmesh())
    Yt, At, St, Wt = tpar.shard_nmf_problem(mesh, Y, A0, S0, W,
                                            model_axis=model)
    Yj, Aj, Sj, Wj = jpar.shard_nmf_problem(jmesh, Y, A0, S0, W,
                                            model_axis=model)
    rt = ptt.nmf.nmf(Yt, At, St, W=1 if W is None else Wt,
                     algorithm="bsdmm", e_rel=0, max_iter=15)
    rj = pt.nmf.nmf(Yj, Aj, Sj, W=1 if W is None else Wj,
                    algorithm="bsdmm", e_rel=0, max_iter=15)
    _held(rt, rj)
    single = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), W=1 if W is None else W,
                         algorithm="bsdmm", e_rel=0, max_iter=15,
                         device="cpu")
    for t, s in zip(rt.x, single.x):
        np.testing.assert_allclose(_np(t), s.numpy(), **SINGLE_B)


def test_dtensor_inputs_refuse_the_cuda_engine(problem):
    """The fused kernels are single-device: DTensor inputs on
    engine='cuda' raise, as mesh= does."""
    Y, A0, S0 = problem
    Yt, At, St, _ = tpar.shard_nmf_problem(_mesh(), Y, A0, S0)
    with pytest.raises(ValueError, match="single-device"):
        ptt.nmf.nmf(Yt, At, St, engine="cuda")
    # engine='auto' runs the torch driver on them
    ra = ptt.nmf.nmf(Yt, At, St, engine="auto", e_rel=0, max_iter=3)
    rt = ptt.nmf.nmf(Yt, At, St, engine="torch", e_rel=0, max_iter=3)
    for a, b in zip(ra.x, rt.x):
        assert torch.equal(a.to_local(), b.to_local())


def _factories(Yt, Y_plain):
    """``name -> (make(Y), args(Y-side blocks))`` of the five factories on
    the flagship-style problem."""
    from proxmin_tpu_torch.nmf import (_bsdmm_prox_f, _bsdmm_step_default,
                                       grad_likelihood, step_adaprox,
                                       step_pgm)

    def prox_f(x, step):
        return (x + step * Y_plain[:3]) / (1.0 + step)

    pair = (top.prox_plus, top.prox_plus)
    return {
        "pgm": lambda Y: tfn.make_pgm_solver(
            lambda A, S: grad_likelihood(A, S, Y=Y), step_pgm,
            prox=top.prox_plus, e_rel=1e-4, max_iter=100),
        "adaprox": lambda Y: tfn.make_adaprox_solver(
            lambda A, S: grad_likelihood(A, S, Y=Y), step_adaprox,
            prox=top.prox_plus, e_rel=1e-4, max_iter=100),
        "bsdmm": lambda Y: tfn.make_bsdmm_solver(
            functools.partial(_bsdmm_prox_f, Y=Y, W=1, prox=pair),
            functools.partial(_bsdmm_step_default, W=1), e_rel=1e-4,
            max_iter=50),
        "admm": lambda B: tfn.make_admm_solver(
            lambda x, step: (x + step * B) / (1.0 + step), 0.5,
            prox_g=top.prox_plus, e_rel=1e-6, max_iter=50),
        "sdmm": lambda B: tfn.make_sdmm_solver(
            lambda x, step: (x + step * B) / (1.0 + step), 0.5,
            (top.prox_plus, functools.partial(top.prox_max, thresh=2.0)),
            e_rel=1e-6, max_iter=50),
    }


@pytest.mark.parametrize("name", ["pgm", "adaprox", "bsdmm", "admm",
                                  "sdmm"])
def test_functional_factories_on_dtensors(problem, name):
    """Each factory of the JAX package's collective audit
    (tests/test_collective_layout.py:172-272) runs on DTensor inputs and
    equals its solve on plain tensors at the JAX suite's tolerance (a
    shard's transposed copy may take another BLAS path), with equal
    counts."""
    Y, A0, S0 = problem
    mesh = _mesh()
    Yt, At, St, _ = tpar.shard_nmf_problem(mesh, Y, A0, S0)
    Yp, Ap, Sp = (torch.from_numpy(a.copy()) for a in (Y, A0, S0))
    make = _factories(Yt, Yp)[name]
    if name in ("admm", "sdmm"):
        B = distribute_tensor(Yp[:3].clone(), mesh, [Shard(1)])
        got, want = make(B)(St), make(Yp[:3])(Sp)
    else:
        got, want = make(Yt)(At, St), make(Yp)(Ap, Sp)
    gx = got[0] if isinstance(got[0], (tuple, list)) else (got[0],)
    wx = want[0] if isinstance(want[0], (tuple, list)) else (want[0],)
    assert all(isinstance(x, DTensor) for x in gx)
    for g, w in zip(gx, wx):
        np.testing.assert_allclose(_np(g), w.numpy(), **SINGLE)
    # the iteration count: after x, or after adaprox's moments
    at = 4 if name == "adaprox" else 1
    assert int(_np(got[at])) == int(_np(want[at]))


@pytest.mark.parametrize("kw", [
    {"algorithm": "bsdmm", "weighted": True},
    {"algorithm": "adaprox", "scheme": "amsgrad"},
], ids=["bsdmm", "adaprox-amsgrad"])
def test_resume_under_mesh_bit_for_bit(problem, rng, tmp_path, kw):
    """A solve under mesh= stopped at 8 iterations continues for 12 to the
    straight 20 bit for bit, through state= and through a checkpoint
    (whose DTensor leaves torch.distributed.checkpoint writes)."""
    Y, A0, S0 = problem
    kw = dict(kw)
    if kw.pop("weighted", False):
        kw["W"] = 0.5 + rng.random(Y.shape)
    mesh = _mesh()
    Yt, At, St, Wt = tpar.shard_nmf_problem(mesh, Y, A0, S0, kw.get("W"))
    if "W" in kw:
        kw["W"] = Wt
    full = ptt.nmf.nmf(Yt, At, St, e_rel=0, max_iter=20, mesh=mesh, **kw)
    half = ptt.nmf.nmf(Yt, At, St, e_rel=0, max_iter=8, mesh=mesh, **kw)
    via_state = ptt.nmf.nmf(Yt, *half.x, e_rel=0, max_iter=12, mesh=mesh,
                            state=half.state, **kw)
    path = save_checkpoint(str(tmp_path / "ck"), x=half.x,
                           solver_state=half.state)
    ck = load_checkpoint(path, mesh=mesh)
    via_file = ptt.nmf.nmf(Yt, *ck["x"], e_rel=0, max_iter=12, mesh=mesh,
                           state=ck["solver_state"], **kw)
    for res in (via_state, via_file):
        assert res.iterations == 12
        for a, b in zip(res.x, full.x):
            assert isinstance(a, DTensor)
            assert torch.equal(a.to_local(), b.to_local())


def test_spectral_bounds_on_sharded_problems(problem, rng):
    """The ADMM family's spectral bounds where the problem is sharded: the
    Gram ``eigvalsh`` of a DTensor matrix and of its plain copy agree, and
    admm on a pixel-sharded x equals its plain solve with a dense L (the
    Gram bound) and with a matrix-free L (the Lanczos bound, on the
    operator's own probe)."""
    from proxmin_tpu_torch import linop

    _, _, S0 = problem
    mesh = _mesh()
    Lm = torch.from_numpy(rng.random((5, 3)))
    Ld = distribute_tensor(Lm, mesh, [Replicate()])
    dense, dense_p = linop.MatrixOperator(Ld), linop.MatrixOperator(Lm)
    np.testing.assert_allclose(float(_np(dense.spectral_norm_sq)),
                               float(dense_p.spectral_norm_sq), rtol=1e-12)
    diff = linop.FunctionOperator(
        lambda x: x[1:] - x[:-1],
        lambda v: torch.cat([-v[:1], v[:-1] - v[1:], v[-1:]]), (3, 64),
        dtype=torch.float64, device="cpu")
    xt = distribute_tensor(torch.from_numpy(S0.copy()), mesh, [Shard(1)])
    pf_t, _ = _prox_f_pair()
    for L, L_plain in ((dense, dense_p), (diff, diff)):
        rt = ptt.admm(xt, pf_t, 0.5, prox_g=top.prox_plus, L=L, e_rel=1e-6,
                      max_iter=100)
        rp = ptt.admm(torch.from_numpy(S0.copy()), pf_t, 0.5,
                      prox_g=top.prox_plus, L=L_plain, e_rel=1e-6,
                      max_iter=100)
        assert isinstance(rt.x, DTensor) and rt.iterations == rp.iterations
        np.testing.assert_allclose(_np(rt.x), rp.x.numpy(), **SINGLE)


def test_options_on_sharded_inputs(problem, rng):
    """The drivers' options on DTensor blocks: Barzilai-Borwein steps,
    backtracking, grad=None, trace= on pgm, adaprox, admm and bsdmm, and
    the weighted strided adaptive bsdmm, each equal to the plain solve."""
    from proxmin_tpu_torch import utils as tut
    from proxmin_tpu_torch.nmf import (_bsdmm_prox_f, _bsdmm_step_default,
                                       grad_likelihood, log_likelihood,
                                       step_pgm)

    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    Yt, At, St, Wt = tpar.shard_nmf_problem(_mesh(), Y, A0, S0, W)
    Yp, Ap, Sp, Wp = (torch.from_numpy(a.copy()) for a in (Y, A0, S0, W))
    pair = (top.prox_plus, top.prox_plus)
    cases = {
        "bb": lambda Y_, A, S, W_: ptt.pgm(
            [A, S], functools.partial(grad_likelihood, Y=Y_),
            tut.BarzilaiBorweinStepper(), prox=top.prox_plus, e_rel=0,
            max_iter=20),
        "backtracking": lambda Y_, A, S, W_: ptt.pgm(
            [A, S], functools.partial(grad_likelihood, Y=Y_),
            lambda *X, it=None: tuple(6 * s for s in step_pgm(*X)),
            prox=top.prox_plus, backtracking=True,
            f=functools.partial(log_likelihood, Y=Y_), e_rel=0,
            max_iter=20),
        "grad_none": lambda Y_, A, S, W_: ptt.pgm(
            [A, S], None, step_pgm, prox=top.prox_plus,
            f=functools.partial(log_likelihood, Y=Y_), e_rel=0,
            max_iter=20),
        "pgm_trace": lambda Y_, A, S, W_: ptt.nmf.nmf(
            Y_, A, S, e_rel=0, max_iter=20, trace=True),
        "adaprox_trace": lambda Y_, A, S, W_: ptt.nmf.nmf(
            Y_, A, S, algorithm="adaprox", e_rel=0, max_iter=20,
            trace=True),
        "bsdmm_trace": lambda Y_, A, S, W_: ptt.bsdmm(
            [A, S], functools.partial(_bsdmm_prox_f, Y=Y_, W=1, prox=pair),
            functools.partial(_bsdmm_step_default, W=1), e_rel=0,
            max_iter=20, trace=True),
        "admm_trace": lambda Y_, A, S, W_: ptt.admm(
            S, _prox_f_pair()[0], 0.5, prox_g=top.prox_plus, e_rel=1e-6,
            max_iter=50, trace=True),
        "bsdmm_w_adapt": lambda Y_, A, S, W_: ptt.nmf.nmf(
            Y_, A, S, W=W_, algorithm="bsdmm", step_stride=5,
            step_adapt=True, e_rel=0, max_iter=20),
    }
    for name, solve in cases.items():
        rt, rp = solve(Yt, At, St, Wt), solve(Yp, Ap, Sp, Wp)
        xt = rt.x if isinstance(rt.x, (tuple, list)) else (rt.x,)
        xp = rp.x if isinstance(rp.x, (tuple, list)) else (rp.x,)
        assert rt.iterations == rp.iterations, name
        for a, b in zip(xt, xp):
            np.testing.assert_allclose(_np(a), b.numpy(), err_msg=name,
                                       **SINGLE)
        if getattr(rp, "history", None) is not None:
            np.testing.assert_allclose(rt.history, rp.history, err_msg=name,
                                       **SINGLE)
