"""proxmin_tpu_torch.parallel against proxmin_tpu.parallel, in one process.

The port runs on a one-rank gloo group made through a ``FileStore`` under
the test's temporary directory (no port is opened, so xdist workers share
nothing), on the CPU, in float64. Each whole solve is held against the JAX
solve on a mesh of the same size (one device) at rtol 1e-9 with equal
``iterations``, ``converged`` and ``status``, and against the
single-device ``nmf`` at the JAX suite's own tolerances (rtol 1e-8 /
atol 1e-11 unweighted, 1e-6 / 1e-9 weighted). Two and four ranks run in
``test_torch_distributed.py``.
"""

import ast
import functools
import inspect
import pathlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

import proxmin_tpu as pt
import proxmin_tpu.parallel as jpar
import proxmin_tpu_torch as ptt
import proxmin_tpu_torch.parallel as tpar
from proxmin_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from proxmin_tpu_torch.interop import state_from_numpy

F64 = dict(rtol=1e-9, atol=0)
SINGLE = dict(rtol=1e-8, atol=1e-11)
SINGLE_W = dict(rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module", autouse=True)
def _group(tmp_path_factory):
    """One gloo rank for the whole module, through a file store."""
    store = tmp_path_factory.mktemp("store") / "store"
    info = tpar.initialize_distributed(f"file://{store}", 1, 0)
    assert info == tpar.DistributedInfo(0, 1, 1, 1)
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


def _mesh(shape=None, axis_names=None):
    return tpar.make_mesh(shape, axis_names, device="cpu")


def _jmesh(shape=(1,), axis_names=None):
    return jpar.make_mesh(shape, axis_names, devices=jax.devices("cpu")[:1])


def _np(x):
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(rt, rj, tol=F64):
    """A port solve against a JAX solve of the same algorithm."""
    for t, j in zip(rt.x, rj.x):
        np.testing.assert_allclose(_np(t), np.asarray(j), **tol)
    assert rt.iterations == rj.iterations
    assert tuple(rt.converged) == tuple(rj.converged)
    assert rt.status == rj.status
    np.testing.assert_allclose(rt.loss, rj.loss, **tol)


def _numpy_state(state):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, state)


def _count_all_reduces(monkeypatch):
    """Record ``(elements, op)`` of every ``torch.distributed.all_reduce``
    call from here on."""
    calls = []
    real = dist.all_reduce

    def counted(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        calls.append((tensor.numel(), str(op)))
        return real(tensor, op=op, group=group, async_op=async_op)

    monkeypatch.setattr(dist, "all_reduce", counted)
    return calls


def test_one_rank_available():
    assert dist.is_initialized() and dist.get_world_size() == 1
    # idempotent: a second call returns the same layout
    assert tpar.initialize_distributed() == tpar.DistributedInfo(0, 1, 1, 1)


def test_make_mesh_1d():
    mesh = _mesh()
    assert mesh.mesh_dim_names == ("data",)
    assert mesh.mesh.numel() == dist.get_world_size()
    assert mesh.device_type == "cpu"


def test_make_mesh_2d():
    mesh = _mesh(shape=(1, 1))
    assert mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        _mesh(shape=(2,))


def test_shard_problem_layout(problem):
    Y, A0, S0 = problem
    Ys, As, Ss, Ws = tpar.shard_nmf_problem(_mesh(), Y, A0, S0)
    assert Ys.placements == (Shard(1),) and Ss.placements == (Shard(1),)
    assert As.placements == (Replicate(),) and Ws is None
    assert tuple(Ys.shape) == Y.shape and Ys.dtype == torch.float64
    np.testing.assert_array_equal(_np(Ss), S0)
    mesh2 = _mesh((1, 1))
    Ys, As, Ss, Ws = tpar.shard_nmf_problem(mesh2, Y, A0, S0, W=Y,
                                            model_axis="model")
    assert Ys.placements == (Shard(1), Shard(0))
    assert As.placements == (Replicate(), Shard(0))
    assert Ss.placements == (Shard(1), Replicate())
    assert Ws.placements == Ys.placements
    # half and integer inputs promote to the default float dtype, as JAX's
    # promote to its default float
    Yh, Ai, _, _ = tpar.shard_nmf_problem(_mesh(), Y.astype(np.float16),
                                          (A0 * 10).astype(np.int32), S0)
    assert Yh.dtype == Ai.dtype == torch.get_default_dtype()


def test_shard_problem_refuses_what_does_not_divide(problem):
    """The JAX errors: the pixel axis and the channel axis must divide."""
    Y, A0, S0 = problem
    jmesh = _jmesh((1, 1), ("data", "model"))
    # a one-rank mesh divides everything: the check is the JAX message's
    for mod, mesh in ((tpar, _mesh((1, 1))), (jpar, jmesh)):
        out = mod.shard_nmf_problem(mesh, Y, A0, S0, model_axis="model")
        assert out[0].shape == Y.shape
    with pytest.raises(ValueError, match="no axis 'model'"):
        tpar.shard_nmf_problem(_mesh(), Y, A0, S0, model_axis="model")


def test_explicit_step_matches_reference_math(problem):
    """One explicit step == one hand-computed PGM step, and == the JAX
    step on a one-device mesh."""
    Y, A0, S0 = problem
    mesh = _mesh()
    Ys, As, Ss, _ = tpar.shard_nmf_problem(mesh, Y, A0, S0)
    A1, S1, loss = tpar.make_nmf_pgm_step(mesh)(As, Ss, Ys)
    assert isinstance(A1, DTensor) and S1.placements == (Shard(1),)

    D = A0 @ S0 - Y
    gA, gS = D @ S0.T, A0.T @ D
    sA = 1.0 / np.linalg.eigvalsh(S0 @ S0.T).max()
    sS = 1.0 / np.linalg.eigvalsh(A0.T @ A0).max()
    np.testing.assert_allclose(_np(A1), np.maximum(A0 - sA * gA, 0),
                               rtol=1e-7)
    np.testing.assert_allclose(_np(S1), np.maximum(S0 - sS * gS, 0),
                               rtol=1e-7)
    np.testing.assert_allclose(float(loss), np.sum(D * D) / 2, rtol=1e-10)

    jmesh = _jmesh()
    out = jpar.make_nmf_pgm_step(jmesh)(
        *(jpar.shard_nmf_problem(jmesh, Y, A0, S0)[i] for i in (1, 2, 0)))
    for t, j in zip((A1, S1, loss), out):
        np.testing.assert_allclose(_np(t), np.asarray(j), **F64)


def test_explicit_step_2d_mesh(problem):
    """TP x DP: the channel axis sharded over 'model' as well."""
    Y, A0, S0 = problem
    mesh = _mesh((1, 1))
    Ys, As, Ss, _ = tpar.shard_nmf_problem(mesh, Y, A0, S0,
                                           model_axis="model")
    A1, S1, loss = tpar.make_nmf_pgm_step(mesh, model_axis="model")(
        As, Ss, Ys)
    mesh1 = _mesh()
    ref = tpar.make_nmf_pgm_step(mesh1)(
        *(tpar.shard_nmf_problem(mesh1, Y, A0, S0)[i] for i in (1, 2, 0)))
    np.testing.assert_allclose(_np(A1), _np(ref[0]), rtol=1e-7)
    np.testing.assert_allclose(_np(S1), _np(ref[1]), rtol=1e-7)
    np.testing.assert_allclose(float(loss), float(ref[2]), rtol=1e-10)


@pytest.mark.parametrize("weighted", [False, True])
def test_full_sharded_solve_matches_jax_and_single_device(problem, rng,
                                                          weighted):
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape) if weighted else None
    n = 15 if weighted else 30
    rt = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=_mesh(),
                              e_rel=0, max_iter=n)
    rj = jpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=_jmesh(),
                              e_rel=0, max_iter=n)
    _same(rt, rj)
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, W=1 if W is None else W, e_rel=0, max_iter=n)
    tol = SINGLE_W if weighted else SINGLE
    np.testing.assert_allclose(_np(rt.x[0]), A1, **tol)
    np.testing.assert_allclose(_np(rt.x[1]), S1, **tol)
    assert rt.iterations == n and rt.status == "max_iter"
    assert rt.state["kind"] == "nmf_pgm_sharded"


@pytest.mark.parametrize("W", [0.5, "per_pixel_1d"])
def test_sharded_scalar_and_lower_rank_W_not_dropped(problem, rng, W):
    """A scalar or 1-D per-pixel W broadcasts against Y as the
    single-device engines' does; through nmf(mesh=) for both algorithms,
    the result equals JAX's nmf(mesh=)."""
    Y, A0, S0 = problem
    if W == "per_pixel_1d":
        W = 0.5 + rng.random(Y.shape[1])
    for algorithm in ("pgm", "adaprox"):
        if np.ndim(W) == 0:
            solver = (tpar.nmf_pgm_sharded if algorithm == "pgm"
                      else tpar.nmf_adaprox_sharded)
            res_w = solver(Y, A0.copy(), S0.copy(), W=W, mesh=_mesh(),
                           e_rel=0, max_iter=15)
            res_u = solver(Y, A0.copy(), S0.copy(), mesh=_mesh(),
                           e_rel=0, max_iter=15)
            np.testing.assert_allclose(res_w.loss / res_u.loss, W,
                                       rtol=1e-3)
        A1, S1 = A0.copy(), S0.copy()
        pt.nmf.nmf(Y, A1, S1, W=W, algorithm=algorithm, e_rel=0,
                   max_iter=15, mesh=_jmesh())
        A2, S2 = A0.copy(), S0.copy()
        ptt.nmf.nmf(Y, A2, S2, W=W, algorithm=algorithm, e_rel=0,
                    max_iter=15, mesh=_mesh())
        np.testing.assert_allclose(A2, A1, err_msg=algorithm, **F64)
        np.testing.assert_allclose(S2, S1, err_msg=algorithm, **F64)


def test_unweighted_sharded_W_operand_aliases_Y(problem):
    """The unweighted whole solves pass Y itself as the dead W operand,
    not a Y-sized plane of ones."""
    Y, A0, S0 = problem
    from proxmin_tpu_torch.parallel.sharding import (_classify_weight,
                                                     _weight_shard)
    weighted, W2 = _classify_weight(1.0, np.shape(Y))
    assert not weighted
    mesh = _mesh()
    Yd = tpar.shard_nmf_problem(mesh, Y, A0, S0)[0]
    assert _weight_shard(None, W2, Yd, mesh, "data", None, weighted) is Yd


@pytest.mark.parametrize("weighted", [False, True])
def test_full_sharded_solve_2d(problem, rng, weighted):
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape) if weighted else None
    kw = dict(W=W, e_rel=0, max_iter=10 if weighted else 20,
              model_axis="model")
    rt = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=_mesh((1, 1)),
                              **kw)
    rj = jpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(),
                              mesh=_jmesh((1, 1), ("data", "model")), **kw)
    _same(rt, rj)
    assert rt.x[0].placements == (Replicate(), Shard(0))


def test_prox_unity_sharded(problem):
    """Sum-to-one along the sharded pixel axis needs the all-reduce: on a
    local shard with a named axis, on a DTensor, and with a group."""
    _, _, S0 = problem
    mesh = _mesh()
    expected = S0 / S0.sum(axis=1, keepdims=True)
    X = torch.from_numpy(S0)
    out = tpar.prox_unity_sharded(X, 0.5, axis=1, axis_name="data",
                                  mesh=mesh)
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-10)
    Xd = tpar.shard_nmf_problem(mesh, S0[:1], S0[:1, :3], S0)[2]
    outd = tpar.prox_unity_sharded(Xd, 0.5, axis=1, axis_name="data")
    assert isinstance(outd, DTensor) and outd.placements == Xd.placements
    np.testing.assert_allclose(_np(outd), expected, rtol=1e-10)
    outg = tpar.prox_unity_sharded(X, 0.5, axis=1,
                                   axis_name=mesh.get_group("data"))
    np.testing.assert_allclose(outg.numpy(), expected, rtol=1e-10)


def test_sharded_convergence_early_stop(problem):
    """e_rel > 0: the all-reduced flags stop the loop, on the iteration
    JAX's stops."""
    Y, A0, S0 = problem
    rt = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=_mesh(),
                              e_rel=1e-2, max_iter=5000)
    rj = jpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=_jmesh(),
                              e_rel=1e-2, max_iter=5000)
    assert rt.iterations < 5000 and all(rt.converged)
    _same(rt, rj)


def test_weighted_sharded_loss_matches_likelihood(problem, rng):
    """The weighted loss is sum(W R^2)/2."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    mesh = _mesh()
    Ys, As, Ss, Ws = tpar.shard_nmf_problem(mesh, Y, A0, S0, W)
    _, _, loss = tpar.make_nmf_pgm_step(mesh, weighted=True)(As, Ss, Ys, Ws)
    expected = float(pt.nmf.log_likelihood(A0, S0, Y=Y, W=W))
    np.testing.assert_allclose(float(loss), expected, rtol=1e-10)
    res = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=mesh,
                               e_rel=0, max_iter=2)
    assert np.isfinite(res.loss)


def test_weighted_sharded_masked_pixels(problem, rng):
    """Fully masked pixels must not NaN the weighted power iteration."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    W[:, 3] = 0.0
    W[:, 17] = 0.0
    rt = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=_mesh(),
                              e_rel=0, max_iter=10)
    assert np.isfinite(_np(rt.x[1])).all()
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, W=W, e_rel=0, max_iter=10)
    np.testing.assert_allclose(_np(rt.x[0]), A1, **SINGLE_W)
    np.testing.assert_allclose(_np(rt.x[1]), S1, **SINGLE_W)


def test_explicit_step_weighted_uses_weighted_lipschitz(problem):
    """With W >> 1 the unweighted steps exceed 1/L and diverge; the
    weighted step descends."""
    Y, A0, S0 = problem
    W = np.full(Y.shape, 25.0)
    mesh = _mesh()
    step = tpar.make_nmf_pgm_step(mesh, weighted=True)
    Ys, As, Ss, Ws = tpar.shard_nmf_problem(mesh, Y, A0, S0, W)
    losses = []
    for _ in range(30):
        As, Ss, loss = step(As, Ss, Ys, Ws)
        losses.append(float(loss))
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0] * 0.9
    assert losses[-1] < 1e4


@pytest.mark.parametrize("kw", [
    {"step_stride": 10}, {"step_stride": 10, "step_adapt": True},
    {"step_adapt": True}], ids=str)
@pytest.mark.parametrize("weighted", [False, True])
def test_full_sharded_solve_strided_matches_jax(problem, rng, kw, weighted):
    """The segmented strided solve: the same refresh schedule (cold 48
    passes, warm 12, 0.9 safety, the adaptive interval) as JAX's."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape) if weighted else None
    rt = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=_mesh(),
                              e_rel=0, max_iter=60, **kw)
    rj = jpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=_jmesh(),
                              e_rel=0, max_iter=60, **kw)
    _same(rt, rj)
    for key in ("stride", "seg_end"):
        assert rt.state[key] == int(rj.state[key])
    np.testing.assert_allclose(float(rt.state["step_S"]),
                               float(rj.state["step_S"]), **F64)


def test_full_sharded_solve_weighted_stride_matches_single_device(problem,
                                                                  rng):
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, W=W, e_rel=0, max_iter=40, step_stride=10)
    r = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), W=W, mesh=_mesh(),
                             e_rel=0, max_iter=40, step_stride=10)
    np.testing.assert_allclose(_np(r.x[0]), A1, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(_np(r.x[1]), S1, rtol=1e-8, atol=1e-10)


def test_full_sharded_solve_multi_level_data_axes(problem, rng):
    """The pixel axis sharded over two mesh axes ("dcn", "data"): one
    group over both."""
    Y, A0, S0 = problem
    mesh = _mesh((1, 1), ("dcn", "data"))
    jmesh = _jmesh((1, 1), ("dcn", "data"))
    kw = dict(data_axis=("dcn", "data"), e_rel=0, max_iter=25)
    rt = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh, **kw)
    _same(rt, jpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=jmesh,
                                   **kw))
    assert rt.x[1].placements == (Shard(1), Shard(1))
    W = 0.5 + rng.random(Y.shape)
    kw.update(W=W, max_iter=30, step_stride=10)
    _same(tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh, **kw),
          jpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=jmesh, **kw))
    with pytest.raises(ValueError, match="mesh's order"):
        tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                             data_axis=("data", "dcn"), e_rel=0, max_iter=2)


def test_sharded_solve_step_adapt_float32(rng):
    """JAX's float32 step_adapt case: 120 iterations, the loss falls, and
    nmf(mesh=, step_adapt=True) routes to it."""
    C, K, N = 4, 3, 64
    Y = (rng.random((C, K)).astype(np.float32)
         @ rng.random((K, N)).astype(np.float32))
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    kw = dict(W=W, e_rel=0, max_iter=120, step_stride=10)
    r_fix = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=_mesh(),
                                 **kw)
    r_ad = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=_mesh(),
                                step_adapt=True, **kw)
    assert r_ad.iterations == 120 and r_ad.x[1].dtype == torch.float32
    l0 = float(pt.nmf.log_likelihood(A0, S0, Y=Y, W=W))
    assert r_ad.loss < 0.1 * l0
    assert r_ad.loss < 1.5 * r_fix.loss + 1e-6
    r = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), W=W, mesh=_mesh(), e_rel=0,
                    max_iter=60, step_adapt=True)
    assert r.iterations == 60 and r.state["kind"] == "nmf_pgm_sharded"


def test_sharded_divergence_detection(rng):
    """A NaN input stops the loop early with status 'diverged', on the
    iteration JAX's stops; healthy solves keep their status."""
    C, K, N = 4, 3, 256
    Y = rng.random((C, N))
    Y[0, 0] = np.nan
    A0, S0 = rng.random((C, K)), rng.random((K, N))
    for mod, mesh in ((tpar, _mesh()), (jpar, _jmesh())):
        r = mod.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                                e_rel=0, max_iter=500)
        assert r.status == "diverged" and r.iterations == 1
        r = mod.nmf_adaprox_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                                    e_rel=0, max_iter=500)
        assert r.status == "diverged" and r.iterations == 1
    Y[0, 0] = 0.5
    r4 = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=_mesh(),
                              e_rel=0, max_iter=10)
    assert r4.status == "max_iter" and r4.iterations == 10


@pytest.mark.parametrize("weighted", [False, True])
def test_full_sharded_adaprox_matches_jax(problem, rng, weighted):
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape) if weighted else None
    rt = tpar.nmf_adaprox_sharded(Y, A0.copy(), S0.copy(), W=W,
                                  mesh=_mesh(), e_rel=0, max_iter=20)
    rj = jpar.nmf_adaprox_sharded(Y, A0.copy(), S0.copy(), W=W,
                                  mesh=_jmesh(), e_rel=0, max_iter=20)
    _same(rt, rj)
    A1, S1 = A0.copy(), S0.copy()
    pt.nmf.nmf(Y, A1, S1, W=1 if W is None else W, algorithm="adaprox",
               e_rel=0, max_iter=20)
    tol = dict(rtol=1e-7, atol=1e-10) if weighted else SINGLE
    np.testing.assert_allclose(_np(rt.x[0]), A1, **tol)
    np.testing.assert_allclose(_np(rt.x[1]), S1, **tol)
    assert rt.state["kind"] == "nmf_adaprox_sharded"
    assert rt.state["MS"].placements == (Shard(1),)


def test_full_sharded_adaprox_weighted_2d(problem, rng):
    """Weighted on a ("model", "data") mesh: the gradients and the alpha
    sums reduce over the right axes."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    kw = dict(W=W, model_axis="model", e_rel=0, max_iter=20)
    rt = tpar.nmf_adaprox_sharded(Y, A0.copy(), S0.copy(),
                                  mesh=_mesh((1, 1), ("model", "data")),
                                  **kw)
    rj = jpar.nmf_adaprox_sharded(Y, A0.copy(), S0.copy(),
                                  mesh=_jmesh((1, 1), ("model", "data")),
                                  **kw)
    _same(rt, rj)


@pytest.mark.parametrize("case", ["pgm weighted adaptive", "pgm exact",
                                  "adaprox"])
def test_sharded_resume_bit_exact(problem, rng, case):
    """12 iterations, then state= and 8 more, equal the straight 20 bit for
    bit; the same through a sharded checkpoint on disk."""
    Y, A0, S0 = problem
    if case == "adaprox":
        solve = functools.partial(tpar.nmf_adaprox_sharded, Y)
    else:
        kw = ({"W": 0.5 + rng.random(Y.shape), "step_stride": 4,
               "step_adapt": True} if "weighted" in case else {})
        solve = functools.partial(tpar.nmf_pgm_sharded, Y, **kw)
    mesh = _mesh()
    full = solve(A0.copy(), S0.copy(), mesh=mesh, e_rel=0, max_iter=20)
    half = solve(A0.copy(), S0.copy(), mesh=mesh, e_rel=0, max_iter=12)
    rest = solve(half.x[0], half.x[1], mesh=mesh, e_rel=0, max_iter=8,
                 state=half.state)
    assert rest.iterations == 8 and rest.state["it"] == 20
    for a, b in zip(rest.x, full.x):
        assert torch.equal(a.to_local(), b.to_local())
    assert rest.loss == full.loss


def test_sharded_checkpoint_resumes_bit_exact(problem, rng, tmp_path):
    """A weighted adaptive solve killed after 11 iterations, saved through
    torch.distributed.checkpoint, loaded onto the mesh and continued for
    13: equal to the straight 24 bit for bit."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    mesh = _mesh()
    kw = dict(W=W, mesh=mesh, e_rel=0, step_stride=10, step_adapt=True)
    full = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), max_iter=24, **kw)
    half = tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), max_iter=11, **kw)
    path = save_checkpoint(tmp_path / "pod", x=half.x,
                           solver_state=half.state)
    ck = load_checkpoint(path, mesh=mesh)
    st = ck["solver_state"]
    assert isinstance(st["v"], DTensor) and st["v"].placements == (Shard(0),)
    assert isinstance(st["it"], int) and st["kind"] == "nmf_pgm_sharded"
    assert isinstance(ck["x"], tuple)
    res = tpar.nmf_pgm_sharded(Y, *ck["x"], max_iter=13, state=st, **kw)
    for a, b in zip(res.x, full.x):
        assert torch.equal(a.to_local(), b.to_local())
    with pytest.raises(ValueError, match="mesh="):
        load_checkpoint(path)


@pytest.mark.parametrize("case", [
    "pgm exact", "pgm weighted stride", "pgm weighted adaptive",
    "pgm adaptive", "adaprox", "adaprox weighted"])
def test_jax_sharded_state_continues_in_the_port(problem, rng, case):
    """A JAX sharded solve stopped after 12 iterations continues in the
    port (interop.state_from_numpy on the mesh) to JAX's straight 25."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape) if "weighted" in case else None
    kw = {"W": W}
    if "stride" in case:
        kw["step_stride"] = 5
    if "adaptive" in case:
        kw.update(step_stride=4, step_adapt=True)
    name = "nmf_adaprox_sharded" if case.startswith("adaprox") else \
        "nmf_pgm_sharded"
    jsolve, tsolve = getattr(jpar, name), getattr(tpar, name)
    jmesh, mesh = _jmesh(), _mesh()
    full = jsolve(Y, A0.copy(), S0.copy(), mesh=jmesh, e_rel=0,
                  max_iter=25, **kw)
    half = jsolve(Y, A0.copy(), S0.copy(), mesh=jmesh, e_rel=0,
                  max_iter=12, **kw)
    st = state_from_numpy(_numpy_state(half.state), mesh=mesh)
    assert st["kind"] == name and st["it"] == 12
    rest = tsolve(Y, np.asarray(half.x[0]), np.asarray(half.x[1]),
                  mesh=mesh, e_rel=0, max_iter=13, state=st, **kw)
    assert rest.state["it"] == 25
    for t, j in zip(rest.x, full.x):
        np.testing.assert_allclose(_np(t), np.asarray(j), **F64)
    with pytest.raises(ValueError, match="mesh="):
        state_from_numpy(_numpy_state(half.state), device="cpu")


def test_nmf_mesh_routes_to_the_explicit_solves(problem, rng):
    """nmf(mesh=): pgm (exact, weighted stride) and adaprox take the
    explicit sharded solves (the state's kind shows the route), equal to
    JAX's nmf(mesh=) and write back to NumPy inputs."""
    Y, A0, S0 = problem
    W = 0.5 + rng.random(Y.shape)
    for kw in ({}, {"W": W, "step_stride": 10}, {"algorithm": "adaprox"}):
        A1, S1 = A0.copy(), S0.copy()
        rj = pt.nmf.nmf(Y, A1, S1, e_rel=0, max_iter=20, mesh=_jmesh(),
                        **kw)
        A2, S2 = A0.copy(), S0.copy()
        rt = ptt.nmf.nmf(Y, A2, S2, e_rel=0, max_iter=20, mesh=_mesh(),
                         **kw)
        assert rt.state["kind"] == rj.state["kind"]
        np.testing.assert_allclose(A2, A1, **F64)
        np.testing.assert_allclose(S2, S1, **F64)
        assert rt.iterations == rj.iterations == 20
    r2 = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=20,
                     mesh=_mesh((1, 1)), model_axis="model")
    assert r2.x[0].placements == (Replicate(), Shard(0))


def test_nmf_mesh_refusals(problem):
    """engine='cuda' under a mesh raises as JAX's engine='pallas' does; a
    sharded state without a mesh, a fused state under one, and a sharded
    state on a call that does not route to its solve raise ValueError."""
    Y, A0, S0 = problem
    mesh = _mesh()
    with pytest.raises(ValueError, match="single-device"):
        ptt.nmf.nmf(Y, A0.copy(), S0.copy(), mesh=mesh, engine="cuda")
    with pytest.raises(ValueError, match="single-device"):
        pt.nmf.nmf(Y, A0.copy(), S0.copy(), mesh=_jmesh(), engine="pallas")
    pgm_half = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), mesh=mesh, e_rel=0,
                           max_iter=5)
    ada_half = tpar.nmf_adaprox_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                                        e_rel=0, max_iter=5)
    for st in (pgm_half.state, ada_half.state):
        with pytest.raises(ValueError, match="sharded"):
            ptt.nmf.nmf(Y, A0.copy(), S0.copy(), state=st, device="cpu",
                        algorithm="adaprox" if "MS" in st else "pgm")
    with pytest.raises(ValueError, match="nmf_pgm_sharded"):
        ptt.nmf.nmf(Y, A0.copy(), S0.copy(), mesh=mesh, accelerated=True,
                    state=pgm_half.state)
    with pytest.raises(ValueError, match="nmf_adaprox_sharded"):
        ptt.nmf.nmf(Y, A0.copy(), S0.copy(), mesh=mesh, algorithm="adaprox",
                    scheme="amsgrad", state=ada_half.state)
    fused = ptt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), max_iter=2,
                                  device="cpu")
    with pytest.raises(ValueError, match="nmf_pgm_fused"):
        ptt.nmf.nmf(Y, A0.copy(), S0.copy(), mesh=mesh, state=fused.state)
    with pytest.raises(ValueError, match="nmf_pgm_sharded .state"):
        tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                             state=ada_half.state)
    with pytest.raises(ValueError, match="stride"):
        tpar.nmf_pgm_sharded(Y, A0.copy(), S0.copy(), mesh=mesh,
                             step_stride=5, state=pgm_half.state)


@pytest.mark.parametrize("kw", [
    {"algorithm": "bsdmm"},
    {"algorithm": "adaprox", "separable_prox": False},
    {"algorithm": "adaprox", "scheme": "amsgrad"},
    {"algorithm": "adaprox", "step_stride": 5},
    {"step": lambda *X, it=None: (0.1, 0.1)},
    {"accelerated": True},
    {"callback": lambda *X, it=None: None},
], ids=["bsdmm", "nonseparable", "amsgrad", "adaprox-stride", "step",
        "accelerated", "callback"])
def test_auto_spmd_routes_run(problem, kw):
    """The calls that the JAX package runs under a mesh through the
    ordinary drivers on sharded inputs (auto-SPMD) run so in the port too:
    equal to JAX's nmf(mesh=) at rtol 1e-9 with equal iterations, the
    result written back into the NumPy inputs."""
    Y, A0, S0 = problem
    A1, S1 = A0.copy(), S0.copy()
    rj = pt.nmf.nmf(Y, A1, S1, mesh=_jmesh(), e_rel=0, max_iter=10, **kw)
    A2, S2 = A0.copy(), S0.copy()
    rt = ptt.nmf.nmf(Y, A2, S2, mesh=_mesh(), e_rel=0, max_iter=10, **kw)
    np.testing.assert_allclose(A2, A1, **F64)
    np.testing.assert_allclose(S2, S1, **F64)
    # (accelerated diverges at iteration 9 on this problem, in both)
    assert rt.iterations == rj.iterations
    assert rt.status == rj.status
    assert all(isinstance(x, DTensor) for x in rt.x)
    assert rt.x[1].placements == (Shard(1),)


def test_collectives_per_iteration(problem, rng, monkeypatch):
    """Only small all-reduces (C K + K K, K K, scalars), a pinned count per
    iteration, on a one-rank mesh: the counts of the marginal 10
    iterations."""
    Y, A0, S0 = problem
    C, K = A0.shape
    W = 0.5 + rng.random(Y.shape)
    calls = _count_all_reduces(monkeypatch)
    cases = {
        "pgm exact": (tpar.nmf_pgm_sharded, {},
                      [(C * K + K * K, "sum"), (3, "sum")]),
        "pgm weighted": (tpar.nmf_pgm_sharded, {"W": W},
                         [(C * K + C * K * K, "sum"), (1, "max"),
                          (3, "sum")]),
        "adaprox": (tpar.nmf_adaprox_sharded, {},
                    [(K + C * K, "sum"), (3, "sum")]),
    }
    for name, (solve, kw, per_iter) in cases.items():
        seen = []
        for n in (10, 20):
            calls.clear()
            solve(Y, A0.copy(), S0.copy(), mesh=_mesh(), e_rel=0,
                  max_iter=n, **kw)
            seen.append(list(calls))
        extra = seen[1][len(seen[1]) - 10 * len(per_iter):]
        assert len(seen[1]) - len(seen[0]) == 10 * len(per_iter), name
        assert [(n, op.split(".")[-1].lower()) for n, op in extra] == \
            per_iter * 10, name
        # nothing of the size of a pixel-axis array crosses the network
        assert max(n for n, _ in seen[1]) < S0.size, name


def test_surface_matches_jax():
    """The JAX __all__ but hlo_collectives, each with the JAX parameters
    in order (the solvers and make_mesh add ``device``, the prox
    ``mesh``, initialize_distributed ``backend``)."""
    assert set(jpar.__all__) - set(tpar.__all__) == {"hlo_collectives"}
    added = {"make_mesh": ["device"], "nmf_pgm_sharded": ["device"],
             "nmf_adaprox_sharded": ["device"],
             "prox_unity_sharded": ["mesh"],
             "initialize_distributed": ["backend"]}
    for name in tpar.__all__:
        got, want = getattr(tpar, name), getattr(jpar, name)
        if inspect.isclass(want):
            assert got._fields == want._fields
            continue
        assert (list(inspect.signature(got).parameters)
                == list(inspect.signature(want).parameters)
                + added.get(name, [])), name


def test_parallel_imports_no_jax():
    for path in pathlib.Path(tpar.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in names if m.split(".")[0]
                    in ("jax", "jaxlib", "proxmin_tpu")], path
