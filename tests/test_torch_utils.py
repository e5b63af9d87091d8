"""The port's host-side utils against proxmin_tpu.utils: the Nesterov
accelerator, the callbacks, the approximate cache, the warning summary, the
profiler context, the Langville test and the Barzilai-Borwein stepper.

f64 where the JAX suite runs x64. The same NumPy inputs go through both
packages. Tolerances: the BB steps are ratios of a few reductions over 4 to
12 elements, the same operations in the same order in both, so rtol 1e-12
over 10 iterations; the host helpers must agree exactly."""

import io
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu_torch as ptt

uj, ut = pt.utils, ptt.utils


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_nesterov_accelerator_matches_jax():
    aj, at = uj.NesterovAccelerator(True), ut.NesterovAccelerator(True)
    want = [aj.omega for _ in range(6)]
    got = [at.omega for _ in range(6)]
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert at.t == pytest.approx(float(aj.t), rel=1e-12)
    # the tensor recursion the drivers use gives the same sequence
    t, seq = torch.tensor(1.0, dtype=torch.float64), []
    for _ in range(6):
        om, t = ut.nesterov_next(t)
        seq.append(float(om))
    np.testing.assert_allclose(seq, got, rtol=1e-15)
    off = ut.NesterovAccelerator(accelerated=False)
    assert off.omega == 0.0 and off.t == 1.0


def test_traceback_and_nullcallback(rng):
    """tests/test_utils.py's case, with the tensors the drivers hand a
    callback: the trace holds host NumPy copies equal to the JAX one's."""
    x = rng.normal(size=(2, 2))
    tj, tt = uj.Traceback(), ut.Traceback()
    xt = torch.from_numpy(x.copy())
    for it, scale in enumerate((1, 2)):
        tj(x * scale, it=it)
        tt(xt * scale, it=it)
    assert len(tt.trace) == len(tj.trace) == 2
    for a, b in zip(tt.trace, tj.trace):
        assert type(a) is tuple and type(a[0]) is np.ndarray
        np.testing.assert_array_equal(a[0], b[0])
    # a copy, not a view of the iterate
    xt.mul_(0)
    np.testing.assert_array_equal(tt.trace[0][0], x)
    # NumPy blocks are taken too
    tt(x, it=2)
    np.testing.assert_array_equal(tt.trace[2][0], x)
    tt.clear()
    assert tt.trace == []
    assert ut.NullCallback()(xt, it=0) is None


@pytest.mark.parametrize("as_tensor", [False, True])
def test_approximate_cache_matches_jax(as_tensor):
    """The same call sequence evaluates on the same calls and ends on the
    same stride, for floats and for 0-d tensors."""
    calls_j, calls_t = [], []

    def slow_j(v):
        calls_j.append(v)
        return v

    def slow_t(v):
        calls_t.append(float(v))
        return torch.tensor(v, dtype=torch.float64) if as_tensor else v

    cj = uj.ApproximateCache(slow_j, slack=0.1, max_stride=10)
    ct = ut.ApproximateCache(slow_t, slack=0.1, max_stride=10)
    vals_j = [cj(1.0 + 1e-4 * i) for i in range(30)]
    vals_t = [float(ct(1.0 + 1e-4 * i)) for i in range(30)]
    assert calls_t == calls_j and len(calls_t) < 30
    assert vals_t == vals_j and vals_t[0] == 1.0
    assert len(ct) == len(cj) >= 1
    assert (ct.it, ct.last, ct.stride) == (cj.it, cj.last, cj.stride)
    # slack=0 always evaluates
    calls_t.clear()
    c0 = ut.ApproximateCache(slow_t, slack=0.0)
    [c0(float(i)) for i in range(5)]
    assert len(calls_t) == 5
    with pytest.raises(ValueError):
        ut.ApproximateCache(slow_t, slack=1.0)


def test_hasnotnone_parity():
    for case in ([None, None], [[None], [1, None]], [[2], [None]], [],
                 [None, [None, 3], None]):
        assert ut.hasNotNone(case) == uj.hasNotNone(case)
    assert ut.hasNotNone([[None], [1, None]]) == 1
    assert ut.hasNotNone([[2], [None]]) == 2


def test_langville_convergence(rng):
    x = np.abs(rng.normal(size=(3, 3)))
    xt = torch.from_numpy(x)
    for new, e_rel in ((x, 1e-4), (x * 0.5, 1e-4), (x * (1 - 1e-9), 1e-4),
                       (x * 0.999, 0.1)):
        cj, nj = uj.check_convergence(jnp.asarray(new), jnp.asarray(x), e_rel)
        ct, nt = ut.check_convergence(torch.from_numpy(new), xt, e_rel)
        assert bool(ct) == bool(cj)
        np.testing.assert_allclose([float(v) for v in nt],
                                   [float(v) for v in nj], rtol=1e-14)
    assert bool(ut.check_convergence(xt, xt, 1e-4)[0])
    assert not bool(ut.check_convergence(xt * 0.5, xt, 1e-4)[0])


def _capture(logger):
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    logger.addHandler(handler)
    return stream, handler


def test_summarize_convergence_warnings_collapses_and_passes_through():
    logger = logging.getLogger("proxmin")
    stream, handler = _capture(logger)
    old_level = logger.level
    logger.setLevel(logging.WARNING)
    try:
        with ut.summarize_convergence_warnings() as s:
            for _ in range(7):
                logger.warning("Solution did not converge")
            logger.warning("unrelated warning")
        assert s.count == 7
        out = stream.getvalue()
        assert out.count("Solution did not converge") == 1
        assert "Suppressed 7x" in out and "unrelated warning" in out
        # detached: warnings emit normally again
        logger.warning("Solution did not converge")
        assert stream.getvalue().count("did not converge") == 2
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)


def test_summarize_convergence_warnings_through_driver():
    """Fixed-iteration nmf() solves of the port inside the context emit no
    warning each, and one summary on exit, as the JAX package's do."""
    rng = np.random.default_rng(3)
    Y = rng.random((3, 32)).astype(np.float32)
    A = rng.random((3, 2)).astype(np.float32)
    S = rng.random((2, 32)).astype(np.float32)
    logger = logging.getLogger("proxmin")
    stream, handler = _capture(logger)
    old_level = logger.level
    logger.setLevel(logging.WARNING)
    try:
        with ut.summarize_convergence_warnings() as s:
            for _ in range(3):
                ptt.nmf.nmf(Y, A.copy(), S.copy(), e_rel=0, max_iter=5,
                            device="cpu")
        assert s.count == 3
        assert stream.getvalue().count("Suppressed 3x") == 1
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    c = torch.tensor([1.0, 0.5], dtype=torch.float64)
    log_dir = tmp_path / "prof"
    with ut.profile_trace(str(log_dir), create_perfetto_link=True) as prof:
        ptt.pgm(np.array([-1.0, -1.0]), lambda x: x - c, 0.5, e_rel=1e-6,
                max_iter=50, device="cpu")
    found = os.listdir(log_dir)
    assert len(found) == 1 and "trace" in found[0]
    assert found[0].endswith(".json") and prof.path.endswith(found[0])
    assert os.path.getsize(prof.path) > 0
    assert len(prof.profiler.key_averages()) > 0


# ---------------------------------------------------------------------------
# Barzilai-Borwein

def _walk(rng, n_blocks, iters=10):
    """Iterates and gradients of a gradient walk on a quadratic, as NumPy
    arrays per iteration (the same for both packages)."""
    shapes = [(4,), (3, 4)][:n_blocks]
    H = [rng.uniform(0.1, 2.0, size=s) for s in shapes]
    X = [rng.normal(size=s) for s in shapes]
    out = []
    for it in range(iters):
        G = [h * x for h, x in zip(H, X)]
        out.append(([x.copy() for x in X], G))
        X = [x - 0.3 * g for x, g in zip(X, G)]
    return out


@pytest.mark.parametrize("bb_type", [1, 2])
@pytest.mark.parametrize("n_blocks", [1, 2])
def test_bb_steps_match_jax(rng, bb_type, n_blocks):
    """The stepper protocol over 10 iterations: steps rtol 1e-12, and the
    carried Delta equal after the stabilization window."""
    sj = uj.BarzilaiBorweinStepper(type=bb_type, init_r=0.1)
    st = ut.BarzilaiBorweinStepper(type=bb_type, init_r=0.1)
    walk = _walk(rng, n_blocks)
    X0, G0 = walk[0]
    state_j = sj.init_state(tuple(map(jnp.asarray, X0)),
                            tuple(map(jnp.asarray, G0)))
    state_t = st.init_state(tuple(map(torch.from_numpy, X0)), None)
    assert state_t[2].dtype == torch.float64
    assert bool(torch.isinf(state_t[2]).all())
    for it, (X, G) in enumerate(walk):
        steps_j, state_j = sj(state_j, tuple(map(jnp.asarray, X)),
                              jnp.int32(it), tuple(map(jnp.asarray, G)))
        steps_t, state_t = st(state_t, tuple(map(torch.from_numpy, X)), it,
                              tuple(map(torch.from_numpy, G)))
        np.testing.assert_allclose([float(s) for s in steps_t],
                                   [float(s) for s in steps_j], rtol=1e-12)
        np.testing.assert_allclose(state_t[2].numpy(),
                                   np.asarray(state_j[2]), rtol=1e-12)
    assert type(state_t) is tuple and len(state_t) == 3
    assert len(state_t[0]) == len(state_t[1]) == n_blocks


@pytest.mark.parametrize("bb_type", [1, 2])
def test_bb_stepper_host_interface_matches_jax(rng, bb_type):
    """The reference's calling convention, NumPy in and NumPy out."""
    sj = uj.BarzilaiBorweinStepper(type=bb_type, init_r=0.1)
    st = ut.BarzilaiBorweinStepper(type=bb_type, init_r=0.1)
    for it, (X, G) in enumerate(_walk(rng, 1, iters=6)):
        want = sj.step(*map(jnp.asarray, X), it=it, grads=tuple(
            map(jnp.asarray, G)))
        got = st.step(*map(torch.from_numpy, X), it=it, grads=tuple(
            map(torch.from_numpy, G)))
        assert type(got) is tuple and type(got[0]) is np.ndarray
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    assert got[0] > 0
    # NumPy blocks are taken as they are (and stay on the CPU)
    X, G = _walk(rng, 1, iters=1)[0]
    fresh = ut.BarzilaiBorweinStepper(type=bb_type, init_r=0.1)
    np.testing.assert_array_equal(
        fresh.step(*X, it=0, grads=tuple(G))[0],
        st.step(*map(torch.from_numpy, X), it=0, grads=tuple(
            map(torch.from_numpy, G)))[0])


@pytest.mark.parametrize("bb_type", [1, 2])
def test_bb_stepper_stall_no_nan(rng, bb_type):
    """An exactly stalled iterate (S = 0, Y = 0) gives the stabilized step,
    not NaN, and a zero gradient a zero step, not inf: both as in JAX."""
    sj = uj.BarzilaiBorweinStepper(type=bb_type, init_r=0.1)
    st = ut.BarzilaiBorweinStepper(type=bb_type, init_r=0.1)
    x, g = rng.normal(size=(4,)), rng.normal(size=(4,))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    for it in (0, 1, 2):  # the same iterate and gradient again and again
        want = sj.step(jnp.asarray(x), it=it, grads=(jnp.asarray(g),))
        got = st.step(xt, it=it, grads=(gt,))
        assert np.isfinite(got[0]), f"BB{bb_type} stall produced {got[0]}"
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)
    z = ut.BarzilaiBorweinStepper(type=bb_type).step(
        xt, it=0, grads=(torch.zeros(4, dtype=torch.float64),))
    assert z[0] == 0.0
    # and through pgm: starting at the optimum with BB steps
    c = torch.tensor([1.0, 0.5], dtype=torch.float64)
    res = ptt.pgm((c.clone(),), lambda x: x - c,
                  ut.BarzilaiBorweinStepper(type=bb_type), e_rel=0,
                  max_iter=5)
    assert bool(torch.isfinite(res.x[0]).all())


def test_make_stepper_routes_bb_and_it_is_not_segmentable():
    bb = ut.BarzilaiBorweinStepper()
    assert ut.make_stepper(bb, 1) is bb
    assert isinstance(ut.make_stepper(bb.step, 1), ut.FunctionStepper)
    assert ut.make_stepper(bb.step, 1).wants_grads
    assert isinstance(ut.make_stepper(0.5, 2), ut.ConstantStepper)
    for lib in (uj, ut):
        assert not lib.StridedStepper(lib.BarzilaiBorweinStepper(), 1,
                                      stride=5).segmentable
    with pytest.raises(ValueError):
        ut.BarzilaiBorweinStepper(type=3)
