"""The slice as a whole: the port's nmf() against proxmin_tpu.nmf.

Tolerances and their reasons:
- engine="torch" vs engine="xla", f64: rtol 1e-9. The same iteration in
  the same order; only the BLAS libraries' summation orders differ (a few
  ulps per iteration, grown by the nonconvex iteration over 25 steps).
- engine="cuda" (plain K1 version on CPU tensors) vs nmf_pgm_fused, f32:
  rtol 1e-3, atol 1e-5 as in test_pallas_ops.py, since float32 sums over
  the pixels in different orders compound over 20 iterations.
- resume in the port: bitwise.
"""

import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu_torch as ptt
from proxmin_tpu_torch.interop import state_from_numpy

REPO = Path(__file__).resolve().parents[1]
F64 = dict(rtol=1e-9, atol=0)
F32 = dict(rtol=1e-3, atol=1e-5)

# NumPy inputs go to the card unless the caller names a device; these tests
# run on the CPU
_nmf = functools.partial(ptt.nmf.nmf, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _static_routing(tmp_path, monkeypatch):
    """engine="auto" routes by the static table: calibration off, its
    cache in tmp_path and empty."""
    from proxmin_tpu_torch import calibrate

    monkeypatch.setenv("PROXMIN_TPU_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "routing.json"))
    calibrate.clear_cache()
    prev = calibrate.set_auto_calibration("off")
    yield
    calibrate.set_auto_calibration(prev)
    calibrate.clear_cache()


def _problem(seed=101, C=5, K=3, N=400, dtype=np.float64):
    rng = np.random.default_rng(seed)
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(dtype)
    return Y, rng.random((C, K)).astype(dtype), rng.random((K, N)).astype(dtype)


def _close(port_x, jax_x, tol):
    for t, j in zip(port_x, jax_x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def _numpy_state(state):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, state)


@pytest.mark.parametrize("accelerated,seed", [(False, 101), (True, 4)])
def test_torch_engine_matches_xla_fixed_iterations(accelerated, seed):
    """(FISTA on seed 101 drives A to 0 and stops at iteration 7 on both
    engines; seed 4 keeps it moving for all 25.)"""
    Y, A0, S0 = _problem(seed=seed)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=25,
                    accelerated=accelerated)
    rt = _nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=25,
                     accelerated=accelerated)
    assert rj.iterations == rt.iterations == 25
    assert rt.x[0].dtype == torch.float64
    _close(rt.x, rj.x, F64)


def test_torch_engine_stops_on_the_xla_iteration():
    """e_rel=1e-4 on a problem that converges (826 iterations)."""
    Y, A0, S0 = _problem(seed=0)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=1e-4, max_iter=3000)
    rt = _nmf(Y, A0.copy(), S0.copy(), e_rel=1e-4, max_iter=3000)
    assert rj.status == rt.status == "converged"
    assert rj.iterations == rt.iterations
    _close(rt.x, rj.x, F64)


def test_torch_engine_divergence_matches_xla():
    """FISTA on this problem diverges; both stop on the same iteration."""
    Y, A0, S0 = _problem(seed=0)
    kw = dict(e_rel=1e-4, max_iter=200, accelerated=True)
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), **kw)
    rt = _nmf(Y, A0.copy(), S0.copy(), **kw)
    assert rj.status == rt.status == "diverged"
    assert rj.iterations == rt.iterations


def test_cuda_engine_matches_pallas_engine():
    Y, A0, S0 = _problem(dtype=np.float32)
    rj = pt.nmf.nmf_pgm_fused(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=20,
                              tile_n=128)
    rt = _nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=20,
                     engine="cuda")
    assert rj.iterations == rt.iterations == 20
    _close(rt.x, rj.x, F32)
    np.testing.assert_allclose(rt.loss, rj.loss, rtol=1e-4)
    assert rt.state["kind"] == "nmf_pgm_fused"


def test_cuda_engine_resume_is_bit_exact():
    Y, A0, S0 = _problem(dtype=np.float32)
    full = _nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=20,
                       engine="cuda")
    half = _nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=10,
                       engine="cuda")
    # the fused state pins engine="cuda"
    rest = _nmf(Y, half.x[0], half.x[1], e_rel=0, max_iter=10,
                       state=half.state)
    assert rest.iterations == 10 and rest.state["it"] == 20
    for a, b in zip(rest.x, full.x):
        assert torch.equal(a, b)
    assert rest.loss == full.loss
    assert torch.equal(rest.state["steps"], full.state["steps"])


def test_torch_engine_resume_is_bit_exact():
    Y, A0, S0 = _problem(seed=4)
    kw = dict(e_rel=0, accelerated=True)
    full = _nmf(Y, A0.copy(), S0.copy(), max_iter=20, **kw)
    half = _nmf(Y, A0.copy(), S0.copy(), max_iter=10, **kw)
    rest = _nmf(Y, half.x[0], half.x[1], max_iter=10,
                       state=half.state, **kw)
    for a, b in zip(rest.x, full.x):
        assert torch.equal(a, b)


def test_stopped_fused_solve_stays_stopped():
    Y, A0, S0 = _problem(seed=0, dtype=np.float32)
    done = _nmf(Y, A0.copy(), S0.copy(), e_rel=1e-2, max_iter=3000,
                       engine="cuda")
    assert done.status == "converged"
    again = _nmf(Y, done.x[0], done.x[1], e_rel=1e-2, max_iter=50,
                        state=done.state)
    assert again.iterations == 0 and again.loss == done.loss


@pytest.mark.parametrize("engines", [("xla", "torch"), ("pallas", "cuda")])
def test_continue_a_jax_solve_in_the_port(engines):
    """Ten JAX iterations, then ten in the port from state_from_numpy,
    against twenty JAX iterations."""
    jax_engine, port_engine = engines
    dtype, tol = ((np.float64, F64) if jax_engine == "xla"
                  else (np.float32, F32))
    Y, A0, S0 = _problem(dtype=dtype)
    kw = dict(e_rel=0, engine=jax_engine)
    if jax_engine == "pallas":
        kw["tile_n"] = 128
    full = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=20, **kw)
    half = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=10, **kw)
    state = state_from_numpy(_numpy_state(half.state), device="cpu")
    port_kw = {"tile_n": 128} if port_engine == "cuda" else {}
    rest = _nmf(Y, np.asarray(half.x[0]), np.asarray(half.x[1]),
                       e_rel=0, max_iter=10, engine=port_engine, state=state,
                       **port_kw)
    assert rest.iterations == 10
    assert int(rest.state["it"]) == 20
    _close(rest.x, full.x, tol)


def test_nmf_updates_numpy_inputs_in_place():
    Y, A0, S0 = _problem()
    A, S = A0.copy(), S0.copy()
    res = _nmf(Y, A, S, e_rel=0, max_iter=5)
    np.testing.assert_array_equal(A, res.x[0].numpy())
    np.testing.assert_array_equal(S, res.x[1].numpy())


def test_tensor_inputs_stay_tensors_on_their_device():
    Y, A0, S0 = (torch.from_numpy(a) for a in _problem())
    res = _nmf(Y, A0, S0, e_rel=0, max_iter=3)
    assert res.x[1].device == S0.device and res.x[1].shape == S0.shape


def test_likelihood_gradient_and_steps_match_jax():
    Y, A, S = _problem()
    At, St, Yt = (torch.from_numpy(a) for a in (A, S, Y))
    np.testing.assert_allclose(
        float(ptt.nmf.log_likelihood(At, St, Y=Yt)),
        float(pt.nmf.log_likelihood(A, S, Y=Y)), rtol=1e-12)
    for g, w in zip(ptt.nmf.grad_likelihood(At, St, Y=Yt),
                    pt.nmf.grad_likelihood(A, S, Y=Y)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    for s, w in zip(ptt.nmf.step_pgm(At, St), pt.nmf.step_pgm(A, S)):
        np.testing.assert_allclose(float(s), float(w), rtol=1e-12)
    got = ptt.nmf.pgm_nmf_iteration(At, St, Yt)
    want = pt.nmf.pgm_nmf_iteration(A, S, Y)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    assert bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("kw,err", [
    ({"backtracking": True}, None),
    ({"engine": "auto"}, None),
    ({"mesh": object(), "algorithm": "bsdmm", "engine": "cuda"}, ValueError),
    ({"algorithm": "bsdmm", "engine": "cuda"}, ValueError),
    ({"algorithm": "admm"}, ValueError),
    ({"trace": True}, None),
    ({"engine": "pallas"}, ValueError),
    ({"engine": "cuda", "accelerated": True}, ValueError),
])
def test_later_slices_raise_clearly(kw, err):
    """A call the port refuses raises ValueError (``engine="cuda"`` under a
    mesh, as JAX's ``engine="pallas"``); ``backtracking``, ``trace``,
    ``engine="auto"`` and ``nmf(mesh=)``'s auto-SPMD routes raised until
    they were ported, and the first three are now held against the JAX
    package here (the test keeps its name; the routes are held in
    test_torch_auto_spmd.py): this small problem lies in the torch region
    of auto's H100 table, as in the xla region of JAX's, so auto runs the
    torch driver, equal to ``engine="torch"`` bit for bit."""
    Y, A0, S0 = _problem()
    if err is not None:
        with pytest.raises(err):
            _nmf(Y, A0, S0, max_iter=2, **kw)
        return
    kj, kt = dict(kw), dict(kw)
    if "backtracking" in kw:
        # steps 6 times the Lipschitz ones: the line search has to halve
        kj.update(f=functools.partial(pt.nmf.log_likelihood, Y=Y),
                  step=lambda *X, it=None: tuple(
                      6 * s for s in pt.nmf.step_pgm(*X)))
        kt.update(f=functools.partial(ptt.nmf.log_likelihood,
                                      Y=torch.from_numpy(Y)),
                  step=lambda *X, it=None: tuple(
                      6 * s for s in ptt.nmf.step_pgm(*X)))
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=15, **kj)
    rt = _nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=15, **kt)
    assert rj.iterations == rt.iterations == 15
    _close(rt.x, rj.x, F64)
    np.testing.assert_array_equal(rt.state["T"].numpy(),
                                  np.asarray(rj.state["T"]))
    if "backtracking" in kw:
        assert float(rt.state["T"].min()) < 1.0
    elif "engine" in kw:
        ref = _nmf(Y, A0.copy(), S0.copy(), e_rel=0, max_iter=15,
                   engine="torch")
        assert all(torch.equal(a, b) for a, b in zip(rt.x, ref.x))
    else:
        assert rt.history.shape == (15, 2)
        np.testing.assert_allclose(rt.history, rj.history, rtol=1e-9)


def test_bsdmm_algorithm_matches_jax():
    """nmf(algorithm="bsdmm"), by name and by function, against the JAX
    package's at a fixed sweep count."""
    Y, A0, S0 = _problem()
    rj = pt.nmf.nmf(Y, A0.copy(), S0.copy(), algorithm="bsdmm", e_rel=0,
                    max_iter=15)
    for algorithm in ("bsdmm", ptt.bsdmm):
        rt = _nmf(Y, A0.copy(), S0.copy(), algorithm=algorithm, e_rel=0,
                  max_iter=15)
        assert rj.iterations == rt.iterations == 15
        _close(rt.x, rj.x, F64)


def _entry_points():
    """Each entry point that takes NumPy inputs, called without device=."""
    Y, A0, S0 = _problem(dtype=np.float32)
    At, St, Yt = (torch.from_numpy(a) for a in (A0, S0, Y))
    grad = functools.partial(ptt.nmf.grad_likelihood, Y=Yt)
    return {
        "nmf": lambda: ptt.nmf.nmf(Y, A0, S0, max_iter=1),
        "nmf_pgm_fused": lambda: ptt.nmf.nmf_pgm_fused(Y, A0, S0,
                                                       max_iter=1),
        "nmf_adaprox_fused": lambda: ptt.nmf.nmf_adaprox_fused(
            Y, A0, S0, max_iter=1),
        "state_from_numpy": lambda: state_from_numpy(
            {"kind": "nmf_pgm_fused", "weighted": False, "tile_n": 128,
             "it": 1, "converged": np.zeros(2, bool), "diverged": False,
             "loss": 1.0, "steps": np.eye(3, dtype=np.float32)}),
        "pgm": lambda: ptt.pgm([A0, S0], grad, ptt.nmf.step_pgm,
                               max_iter=1),
        "adaprox": lambda: ptt.adaprox([A0, S0], grad,
                                       ptt.nmf.step_adaprox, max_iter=1),
    }


@pytest.mark.parametrize("entry", ["nmf", "nmf_pgm_fused",
                                   "nmf_adaprox_fused", "state_from_numpy",
                                   "pgm", "adaprox"])
def test_numpy_inputs_go_to_the_card_or_raise(entry, monkeypatch):
    """Without a card and without device=, NumPy inputs raise and name
    device="cpu"; with device="cpu" (or CPU tensors) they run here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_points()[entry]()


def test_the_default_device_is_the_card(monkeypatch):
    from proxmin_tpu_torch.solvers.common import default_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
    assert default_device("cpu") == torch.device("cpu")
    # a tensor input is the caller's choice of device
    Y, A0, S0 = (torch.from_numpy(a) for a in _problem())
    assert ptt.nmf.nmf(Y, A0, S0, max_iter=2).x[1].device.type == "cpu"


def test_shape_mismatch_raises():
    Y, A0, S0 = _problem()
    with pytest.raises(ValueError, match="shape mismatch"):
        _nmf(Y, A0.T, S0)


def test_port_never_imports_jax():
    """Neither the package nor chip_smoke.py names jax in an import, and
    importing the package loads no jax module."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|proxmin_tpu)\b", re.M)
    files = sorted((REPO / "proxmin_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f
    import subprocess
    import sys
    code = ("import sys, proxmin_tpu_torch; "
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'proxmin_tpu' "
            "or m.startswith('proxmin_tpu.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
