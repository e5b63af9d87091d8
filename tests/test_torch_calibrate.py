"""Runtime engine calibration of the port's ``nmf(engine="auto")``
(``proxmin_tpu_torch.calibrate``), beside ``tests/test_calibrate.py``.

Inside the gray zone around the H100 routing regions, the first auto-routed
PGM solve of a shape times a few marginal iterations of each engine and
caches the winner. These tests drive the decision machinery with fake
probes and an injected timer (both outcomes), the cache layers, and the
integration with ``nmf`` on the CPU (where the cuda engine runs K1's plain
version). Beyond the JAX module's tests: the key holds ``e_rel`` and a
probe that converged is not cached, a marginal at or below zero measures
nothing, and a probe that raises reaches the caller.
"""

import numpy as np
import pytest
import torch

import proxmin_tpu_torch as ptt
from proxmin_tpu_torch import calibrate
from proxmin_tpu_torch import nmf as tnmf


def _reset():
    calibrate._CACHE.clear()
    calibrate._DISK = {}
    calibrate._DISK_LOADED = False


@pytest.fixture(autouse=True)
def _fresh_calibration(tmp_path, monkeypatch):
    monkeypatch.setenv("PROXMIN_TPU_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "routing.json"))
    _reset()
    prev = calibrate.set_auto_calibration("on")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    calibrate.set_auto_calibration(prev)
    _reset()


def _fake_probes(ms_per_iter, calls, ran=None):
    """Probe callables whose fake run time is ``n * ms_per_iter``, read
    through an injected timer; each returns ``ran(n)`` iterations (all of
    them by default)."""
    clock = {"t": 0.0}

    def timer():
        return clock["t"]

    probes = {}
    for name, ms in ms_per_iter.items():
        def probe(n, _ms=ms, _name=name):
            calls.append((_name, n))
            clock["t"] += n * _ms * 1e-3
            return n if ran is None else ran(n)
        probes[name] = probe
    return probes, timer


def _problem(C, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((C, N))),
            torch.from_numpy(rng.random((C, K))),
            torch.from_numpy(rng.random((K, N))))


@pytest.mark.parametrize("faster", ["torch", "cuda"])
def test_measured_choice_picks_faster_engine(faster):
    slower = "cuda" if faster == "torch" else "torch"
    calls = []
    probes, timer = _fake_probes({faster: 0.1, slower: 0.2}, calls)
    got = calibrate.measured_choice(("k", 1), probes, fallback=slower,
                                    _timer=timer)
    assert got == faster
    # a warm-up, then PROBE_REPS runs of each iteration count, per engine
    lo, hi = calibrate.PROBE_ITERS
    for name in ("torch", "cuda"):
        assert [n for e, n in calls if e == name] == (
            [lo] + [lo, hi] * calibrate.PROBE_REPS)


def test_measured_choice_caches_in_process():
    calls = []
    probes, timer = _fake_probes({"torch": 0.1, "cuda": 0.2}, calls)
    key = ("kind", 5, 7, 1000)
    assert calibrate.measured_choice(key, probes, "cuda",
                                     _timer=timer) == "torch"
    n = len(calls)
    assert calibrate.measured_choice(key, probes, "cuda",
                                     _timer=timer) == "torch"
    assert len(calls) == n  # no second probe


def test_measured_choice_disk_roundtrip():
    calls = []
    probes, timer = _fake_probes({"torch": 0.3, "cuda": 0.1}, calls)
    key = ("NVIDIA H100 80GB HBM3", 5, 7, 1000, True)
    assert calibrate.measured_choice(key, probes, "torch",
                                     _timer=timer) == "cuda"
    # a fresh process: the in-memory caches dropped, the file kept
    _reset()
    n = len(calls)
    assert calibrate.measured_choice(key, probes, "torch",
                                     _timer=timer) == "cuda"
    assert len(calls) == n  # served from the file


def test_measured_choice_near_tie_keeps_static_fallback():
    calls = []
    probes, timer = _fake_probes({"torch": 0.100, "cuda": 0.098}, calls)
    got = calibrate.measured_choice(("tie",), probes, fallback="torch",
                                    _timer=timer)
    assert got == "torch"  # cuda "won" by 2 %: inside the tie band
    probes2, timer2 = _fake_probes({"torch": 0.100, "cuda": 0.098}, [])
    assert calibrate.measured_choice(("tie2",), probes2, fallback="cuda",
                                     _timer=timer2) == "cuda"


def test_mode_off_uses_fallback_without_probing():
    calls = []
    probes, timer = _fake_probes({"torch": 0.1, "cuda": 0.2}, calls)
    calibrate.set_auto_calibration("off")
    assert calibrate.measured_choice(("k",), probes, "cuda",
                                     _timer=timer) == "cuda"
    assert not calls


def test_probe_failure_reaches_the_caller():
    """Where the JAX module falls back to its static tables, the port
    raises: a kernel that fails must not become a quiet torch route. Nothing
    is cached, so the next call probes again."""
    calls = []

    def bad(n):
        calls.append(n)
        raise RuntimeError("the kernel did not launch")

    for _ in range(2):
        with pytest.raises(RuntimeError, match="did not launch"):
            calibrate.measured_choice(("k2",), {"torch": bad, "cuda": bad},
                                      "torch")
    assert len(calls) == 2
    assert not calibrate._CACHE and not calibrate._DISK


def test_set_auto_calibration_validates():
    with pytest.raises(ValueError):
        calibrate.set_auto_calibration("sometimes")
    assert calibrate.set_auto_calibration("off") == "on"
    assert calibrate.set_auto_calibration("on") == "off"


@pytest.mark.parametrize("path,weighted,strided", [
    ("pgm-exact", False, False), ("pgm-stride10", False, True),
    ("pgm-w-stride10", True, True)])
def test_gray_zone_covers_measured_boundaries(path, weighted, strided):
    """The bands are the N ranges the H100 sweep drew around its
    crossovers (``nmf._H100_REGIONS``), and nowhere else: a swept shape
    without a crossover has none, and a shape beyond the kernels none."""
    assert calibrate.GRAY_FACTOR == 1.0
    bands = 0
    for (C, K), (n_x, gray) in tnmf._H100_REGIONS[path].items():
        for N in (1, 10_000, 100_000, 1_000_000, 10_000_000, 10 ** 9):
            inside = gray is not None and gray[0] <= N <= gray[1]
            assert calibrate.in_gray_zone(C, K, N, weighted,
                                          strided) == inside
        if gray is None:
            continue
        bands += 1
        lo, hi = gray
        assert calibrate.in_gray_zone(C, K, lo, weighted, strided)
        assert calibrate.in_gray_zone(C, K, hi, weighted, strided)
        assert not calibrate.in_gray_zone(C, K, lo - 1, weighted, strided)
        assert not calibrate.in_gray_zone(C, K, hi + 1, weighted, strided)
        # the band holds the crossover: the swept N below it and n_x
        assert lo <= n_x and hi >= n_x - 1
    assert bands >= 1
    for N in (10, 10_000, 10_000_000):
        assert not calibrate.in_gray_zone(300, 40, N, weighted, strided)


def _gray(monkeypatch, shape):
    """Put ``shape`` (C, K, N) inside the gray zone of every region."""
    real = calibrate.in_gray_zone
    monkeypatch.setattr(
        calibrate, "in_gray_zone",
        lambda C, K, N, w, s: (C, K, N) == shape or real(C, K, N, w, s))


def test_nmf_auto_probes_in_gray_zone(monkeypatch):
    """nmf(engine='auto') consults measured_choice inside the gray zone
    with both engines' probes, which run the real engines: at (5, 7, 1e4),
    the low end of the exact region's H100 band."""
    C, K, N = 5, 7, 10_000
    assert calibrate.in_gray_zone(C, K, N, False, False)
    seen = {}
    real = calibrate.measured_choice

    def spy(key, probes, fallback, **kw):
        seen["key"] = key
        seen["engines"] = sorted(probes)
        return real(key, probes, fallback, **kw)

    monkeypatch.setattr(calibrate, "measured_choice", spy)
    Y, A, S = _problem(C, K, N)
    res = tnmf.nmf(Y, A, S, engine="auto", e_rel=0, max_iter=3)
    assert res.iterations == 3
    assert seen["engines"] == ["cuda", "torch"]
    kind, C_, K_, N_, weighted = seen["key"][:5]
    assert (kind, C_, K_, N_, weighted) == ("cpu", C, K, N, False)
    assert seen["key"][-1] == 0.0  # the caller's e_rel


def test_nmf_auto_skips_probe_far_from_cliffs(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("should not probe outside the gray zone")

    monkeypatch.setattr(calibrate, "measured_choice", boom)
    monkeypatch.setattr(calibrate, "in_gray_zone", lambda *a: False)
    Y, A, S = _problem(8, 3, 128)
    res = tnmf.nmf(Y, A, S, engine="auto", e_rel=0, max_iter=2)
    assert res.iterations == 2


def test_nmf_auto_respects_calibrated_winner(monkeypatch):
    """Both decisions reach the real engines, and the solve equals the
    explicit engine's bit for bit."""
    C, K, N = 16, 4, 256
    _gray(monkeypatch, (C, K, N))
    Y, A, S = _problem(C, K, N)
    for forced in ("torch", "cuda"):
        monkeypatch.setattr(calibrate, "measured_choice",
                            lambda key, probes, fallback, **kw: forced)
        res = tnmf.nmf(Y, A, S, engine="auto", e_rel=0, max_iter=2)
        ref = tnmf.nmf(Y, A, S, engine=forced, e_rel=0, max_iter=2)
        assert res.iterations == 2
        for got, want in zip(res.x, ref.x):
            assert torch.equal(got, want)


def test_key_holds_e_rel_and_a_converged_probe_is_not_cached():
    """Difference (a): the JAX key has no e_rel, and a probe that converged
    inside its budget (both engines stop early alike) is cached as if it
    had measured something."""
    calls = []
    probes, timer = _fake_probes({"torch": 0.1, "cuda": 0.3}, calls,
                                 ran=lambda n: min(n, 12))
    key = ("cpu", 16, 4, 256, False, 0, False, "float64", 1e-3)
    assert calibrate.measured_choice(key, probes, "cuda",
                                     _timer=timer) == "cuda"
    assert not calibrate._CACHE and not calibrate._DISK
    # the same shape at another e_rel is another decision, measured
    probes2, timer2 = _fake_probes({"torch": 0.1, "cuda": 0.3}, [])
    key2 = key[:-1] + (0.0,)
    assert calibrate.measured_choice(key2, probes2, "cuda",
                                     _timer=timer2) == "torch"
    assert key2 in calibrate._CACHE and key not in calibrate._CACHE


def test_nmf_auto_converged_probe_keeps_the_static_choice(monkeypatch):
    """Through nmf: a problem that converges inside the probe budget keeps
    the static choice, uncached, and the solve equals that engine's."""
    C, K, N = 16, 4, 256
    _gray(monkeypatch, (C, K, N))
    Y, A, S = _problem(C, K, N)
    static = "cuda" if tnmf._unweighted_fused_wins(C, K, N) else "torch"
    res = tnmf.nmf(Y, A, S, engine="auto", e_rel=0.5, max_iter=50)
    assert res.iterations < calibrate.PROBE_ITERS[0]
    assert not calibrate._CACHE
    ref = tnmf.nmf(Y, A, S, engine=static, e_rel=0.5, max_iter=50)
    for got, want in zip(res.x, ref.x):
        assert torch.equal(got, want)


@pytest.mark.parametrize("marginals", [(0.1, 0.1), (0.2, 0.05)])
def test_clipped_marginal_measures_nothing(marginals):
    """Difference (b): a marginal at or below zero (the host clock's
    noise) is no measurement; the JAX module clips it to 0 and lets it
    win. The static choice stands and nothing is cached."""
    lo, hi = calibrate.PROBE_ITERS
    t_lo, t_hi = marginals  # seconds of the lo and hi runs of cuda
    clock = {"t": 0.0}

    def timer():
        return clock["t"]

    def torch_probe(n):
        clock["t"] += n * 1e-3
        return n

    def cuda_probe(n):
        clock["t"] += t_lo if n == lo else t_hi
        return n

    got = calibrate.measured_choice(
        ("clip",), {"torch": torch_probe, "cuda": cuda_probe}, "torch",
        _timer=timer)
    assert got == "torch"
    assert not calibrate._CACHE and not calibrate._DISK


def test_nmf_auto_probe_that_raises_reaches_the_caller(monkeypatch):
    """Difference (c): a cuda probe that fails (a kernel that does not
    build or launch) raises out of nmf(engine='auto')."""
    C, K, N = 16, 4, 256
    _gray(monkeypatch, (C, K, N))

    def broken(*a, **k):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(tnmf, "nmf_pgm_fused", broken)
    Y, A, S = _problem(C, K, N)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tnmf.nmf(Y, A, S, engine="auto", e_rel=0, max_iter=3)
    assert not calibrate._CACHE


def test_probes_leave_the_callers_arrays_and_the_solve_alone(monkeypatch):
    """NumPy inputs are updated in place by nmf; the probes run on copies,
    so the solve after them equals a solve with calibration off that
    routes to the same engine, bit for bit."""
    C, K, N = 16, 4, 256
    rng = np.random.default_rng(3)
    Y = rng.random((C, N))
    A0, S0 = rng.random((C, K)), rng.random((K, N))
    _gray(monkeypatch, (C, K, N))
    chosen = {}
    real = calibrate.measured_choice

    def spy(key, probes, fallback, **kw):
        calls = []
        wrapped = {e: (lambda n, _e=e, _p=p: (calls.append(_e), _p(n))[1])
                   for e, p in probes.items()}
        chosen["engine"] = real(key, wrapped, fallback, **kw)
        chosen["calls"] = len(calls)
        return chosen["engine"]

    monkeypatch.setattr(calibrate, "measured_choice", spy)
    A, S = A0.copy(), S0.copy()
    res = tnmf.nmf(Y, A, S, engine="auto", e_rel=0, max_iter=4,
                   device="cpu")
    assert chosen["calls"] == 2 * (1 + 2 * calibrate.PROBE_REPS)
    calibrate.set_auto_calibration("off")
    A2, S2 = A0.copy(), S0.copy()
    ref = tnmf.nmf(Y, A2, S2, engine=chosen["engine"], e_rel=0, max_iter=4,
                   device="cpu")
    for got, want in zip(res.x, ref.x):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(A, A2)
    np.testing.assert_array_equal(S, S2)


def test_device_kind_and_cache_file(tmp_path):
    assert calibrate.device_kind() == "cpu"
    assert calibrate.device_kind(torch.device("cpu")) == "cpu"
    probes, timer = _fake_probes({"torch": 0.2, "cuda": 0.1}, [])
    calibrate.measured_choice(("cpu", 1), probes, "torch", _timer=timer)
    text = (tmp_path / "routing.json").read_text()
    assert '"cpu|1"' in text and '"engine": "cuda"' in text
    assert ptt.calibrate is calibrate
