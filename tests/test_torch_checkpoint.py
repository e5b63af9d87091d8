"""proxmin_tpu_torch.checkpoint: structure round trips, and kill, save,
load, resume equal to the straight run bit for bit for all five solvers and
both NMF engines.

After the patterns of tests/test_aux.py (the round trips of
proxmin_tpu.checkpoint), tests/test_resume.py and tests/test_resume_sweep.py
(random kill points; a stopped solve stays stopped). Everything runs on the
CPU (``device="cpu"``), where ``engine="cuda"`` runs its kernels' plain
versions. Equality is ``torch.equal``: a state that went through the file
must continue exactly as the state in memory does. The JAX package's own
round trip is run beside the port's on the same tree where both can hold
it."""

import functools

import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu_torch as ptt
from proxmin_tpu.checkpoint import load_checkpoint as jax_load
from proxmin_tpu.checkpoint import save_checkpoint as jax_save
from proxmin_tpu_torch import operators as top
from proxmin_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from proxmin_tpu_torch.solvers.common import tree_structure

_load = functools.partial(load_checkpoint, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_same_tree(a, b):
    """Exact equality of two nests: types, structure, dtypes, bits."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.bfloat16 else b)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b)
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b)


def _through_file(tmp_path, res, name="ck"):
    """``(x, state)`` of a result after a trip through a file."""
    path = save_checkpoint(str(tmp_path / name), x=res.x,
                           solver_state=res.state)
    assert path.endswith(".pt")
    ck = _load(path)
    assert sorted(ck) == ["solver_state", "x"]
    _assert_same_tree(ck["solver_state"], res.state)
    assert tree_structure(ck["solver_state"]) == tree_structure(res.state)
    _assert_same_tree(ck["x"], res.x)
    return ck["x"], ck["solver_state"]


def _equal(a, b):
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# structure round trips

def test_checkpoint_roundtrip(tmp_path):
    """tests/test_aux.py's case through both packages: keyword entries, a
    tuple of NumPy arrays."""
    x = {"a": np.arange(6.0).reshape(2, 3), "b": (np.ones(4), np.zeros(2))}
    back = _load(save_checkpoint(str(tmp_path / "ck"), **x))
    back_j = jax_load(jax_save(str(tmp_path / "ckj"), use_orbax=False, **x),
                      use_orbax=False)
    _assert_same_tree(back, x)
    for k in x:
        np.testing.assert_array_equal(np.asarray(back_j[k][0]),
                                      np.asarray(back[k][0]))
    assert type(back["b"]) is type(back_j["b"]) is tuple


def test_checkpoint_appends_its_suffix_once(tmp_path):
    x = {"m": torch.ones(3, 3)}
    p = save_checkpoint(str(tmp_path / "ck2"), **x)
    assert p == str(tmp_path / "ck2.pt")
    assert save_checkpoint(p, **x) == p
    _assert_same_tree(_load(str(tmp_path / "ck2")), x)
    _assert_same_tree(_load(p), x)
    assert _equal(_load(tmp_path / "ck2")["m"], x["m"])  # a Path too


def test_checkpoint_tree_arg(tmp_path):
    """A bare tree round-trips under "__tree__", with keyword entries
    beside it."""
    tree = {"state": (np.arange(3.0), {"k": torch.eye(2)})}
    back = _load(save_checkpoint(str(tmp_path / "t"), tree, it=7))
    assert sorted(back) == ["__tree__", "it"] and back["it"] == 7
    _assert_same_tree(back["__tree__"], tree)
    back_j = jax_load(jax_save(str(tmp_path / "tj"), tree={"state": (
        np.arange(3.0), {"k": np.eye(2)})}, use_orbax=False),
        use_orbax=False)["__tree__"]
    np.testing.assert_array_equal(back_j["state"][1]["k"],
                                  back["__tree__"]["state"][1]["k"].numpy())


def test_exact_structure_round_trip(tmp_path):
    """What the drivers' resume checks compare survives: tuples stay
    tuples and lists lists, () stays (), strings, None, bools, host
    integers and floats, NumPy arrays and scalars with their dtypes,
    torch.dtype objects, bfloat16 and bool tensors with their bits, 0-d
    tensors, non-finite numbers."""
    bf = torch.randn(5, 7).to(torch.bfloat16)
    tree = {
        "kind": "nmf_pgm_fused", "weighted": True, "none": None,
        "stride_config": (10, True), "store_dtype": "bfloat16",
        "dtype": torch.bfloat16, "empty": (), "empty_list": [],
        "it": 123456789012345678901234567890, "loss": float("inf"),
        "nan": float("nan"), "neg": -0.0,
        "converged": np.array([True, False]),
        "np_scalar": np.float32(0.1), "np_int": np.int64(-3),
        "np_bool": np.bool_(True), "np_0d": np.array(2.5),
        "steps": (torch.tensor(0.25), torch.tensor(4.0), bf, 12, 40),
        "nested": ((torch.zeros(2), ()), [torch.ones(1, dtype=torch.int32),
                                          ("a", (None, 1.5))]),
        "flags": torch.tensor([True, False]),
        "f64": torch.tensor(1 / 3, dtype=torch.float64),
    }
    back = _load(save_checkpoint(str(tmp_path / "s"), **tree))
    _assert_same_tree(back, tree)
    assert tree_structure(back) == tree_structure(tree)
    assert back["steps"][2].dtype == torch.bfloat16
    assert type(back["it"]) is int and type(back["weighted"]) is bool
    assert type(back["np_scalar"]) is np.float32
    assert back["np_0d"].shape == () and type(back["np_0d"]) is np.ndarray


def test_result_flags_and_views_are_stored_plainly(tmp_path):
    """A result's tuple and int subclasses come back as their bases, and a
    view is written without the storage it looks into."""
    from proxmin_tpu_torch.solvers.common import BoolResult, SolverResult

    big = torch.arange(1_000_000, dtype=torch.float32)
    res = SolverResult((True, False), x=None)
    p = save_checkpoint(str(tmp_path / "v"), view=big[10:12],
                        strided=big[::500_000], flag=BoolResult(True),
                        res=res)
    import os
    assert os.path.getsize(p) < 10_000
    back = _load(p)
    assert torch.equal(back["view"], big[10:12])
    assert torch.equal(back["strided"], big[::500_000])
    assert type(back["flag"]) is int and back["flag"] == 1
    assert type(back["res"]) is tuple and back["res"] == (True, False)
    assert not back["view"].requires_grad
    g = torch.ones(2, requires_grad=True) * 2
    assert not _load(save_checkpoint(str(tmp_path / "g"), g=g))[
        "g"].requires_grad


def test_refused_leaves_and_files(tmp_path):
    with pytest.raises(TypeError, match="cannot checkpoint"):
        save_checkpoint(str(tmp_path / "bad"), fn=len)
    with pytest.raises(TypeError, match="NumPy leaf"):
        save_checkpoint(str(tmp_path / "bad"), s=np.array(["a"]))
    with pytest.raises(ValueError, match="may not use the key"):
        save_checkpoint(str(tmp_path / "bad"), d={"__proxmin_leaf__": 1})
    torch.save({"x": torch.ones(2)}, str(tmp_path / "other.pt"))
    with pytest.raises(ValueError, match="not a proxmin_tpu_torch"):
        _load(str(tmp_path / "other"))
    with pytest.raises(FileNotFoundError):
        _load(str(tmp_path / "missing"))


def test_file_loads_under_weights_only_and_without_a_card(tmp_path,
                                                         monkeypatch):
    """The file holds tensors and plain Python only, so torch's restricted
    loader reads it; without a card and without device= the load raises as
    every entry point does."""
    p = save_checkpoint(str(tmp_path / "w"), a=np.ones(2), t=(1, "s"))
    raw = torch.load(p, weights_only=True)
    assert raw["format"].startswith("proxmin_tpu_torch.checkpoint/")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_checkpoint(p)


# ---------------------------------------------------------------------------
# pgm

H_ILL = torch.from_numpy(np.diag([1.0, 0.02]))
C_ILL = torch.ones(2, dtype=torch.float64)
X0 = np.array([-1.0, -1.0])


def _grad_ill(x):
    return H_ILL @ (x - C_ILL)


def _f_ill(x):
    d = x - C_ILL
    return 0.5 * d @ (H_ILL @ d)


def _strided(adapt):
    return lambda: ptt.utils.StridedStepper(
        lambda *X, it=None: 0.7 / (1.0 + 0.01 * it), 1, stride=4,
        adapt=adapt)


PGM_CASES = {
    "plain": (lambda: 1.0, {}),
    "fista": (lambda: 1.0, {"accelerated": True}),
    "fista restart": (lambda: 1.0, {"accelerated": True, "restart": True}),
    "backtracking": (lambda: 50.0, {"backtracking": True, "f": _f_ill}),
    "fista backtracking": (lambda: 50.0, {
        "accelerated": True, "backtracking": True, "f": _f_ill}),
    "bb1": (lambda: ptt.utils.BarzilaiBorweinStepper(type=1), {}),
    "bb2": (lambda: ptt.utils.BarzilaiBorweinStepper(type=2), {}),
    "strided": (_strided(False), {"accelerated": True}),
    "strided adaptive": (_strided(True), {}),
}


@pytest.mark.parametrize("case", sorted(PGM_CASES))
@pytest.mark.parametrize("k", [1, 8, 13])
def test_pgm_resume_through_checkpoint(tmp_path, case, k):
    """Kill after k of 24 iterations (8: on a refresh boundary of the
    strided cases), save, load, resume."""
    step, kw = PGM_CASES[case]
    kw = dict(kw, e_rel=0.0, prox=top.prox_plus, device="cpu")
    full = ptt.pgm(X0.copy(), _grad_ill, step(), max_iter=24, **kw)
    half = ptt.pgm(X0.copy(), _grad_ill, step(), max_iter=k, **kw)
    x, state = _through_file(tmp_path, half)
    rest = ptt.pgm(x, _grad_ill, step(), max_iter=24 - k, state=state, **kw)
    assert _equal(rest.x, full.x)
    assert rest.state["it"] == full.state["it"]
    _assert_same_tree(rest.state, full.state)
    if "backtracking" in case:
        assert float(state["T"][0]) < 1.0


@pytest.mark.parametrize("trial", range(6))
def test_pgm_resume_random_configs_through_checkpoint(tmp_path, trial):
    """tests/test_resume_sweep.py's random configurations and kill points,
    with the file in between."""
    rng = np.random.default_rng(3000 + trial)
    H = torch.from_numpy(np.diag(rng.uniform(0.05, 1.0, size=4)))
    c = torch.from_numpy(rng.normal(size=4))

    def grad(x):
        return H @ (x - c)

    accelerated = bool(rng.integers(0, 2))
    restart = accelerated and bool(rng.integers(0, 2))
    use_bb = bool(rng.integers(0, 2))
    bb_type = int(rng.integers(1, 3))
    alpha = float(rng.uniform(0.3, 0.9))
    step = (lambda: ptt.utils.BarzilaiBorweinStepper(type=bb_type,
                                                     init_r=0.1)
            if use_bb else alpha)
    prox = top.prox_plus if rng.integers(0, 2) else None
    total = int(rng.integers(8, 40))
    k = int(rng.integers(1, total))
    kw = dict(accelerated=accelerated, restart=restart, prox=prox,
              e_rel=0.0, device="cpu")
    x0 = rng.normal(size=4)
    full = ptt.pgm(x0.copy(), grad, step(), max_iter=total, **kw)
    half = ptt.pgm(x0.copy(), grad, step(), max_iter=k, **kw)
    x, state = _through_file(tmp_path, half)
    rest = ptt.pgm(x, grad, step(), max_iter=total - k, state=state, **kw)
    assert _equal(rest.x, full.x), (accelerated, restart, use_bb, k, total)


@pytest.mark.parametrize("accelerated", [False, True])
def test_pgm_stopped_solve_stays_stopped_after_a_reload(tmp_path,
                                                        accelerated):
    """A solve killed after it converged, or after it diverged, takes no
    step after the reload."""
    kw = dict(accelerated=accelerated, prox=top.prox_plus, e_rel=1e-4,
              device="cpu")
    full = ptt.pgm(X0.copy(), _grad_ill, 0.9, max_iter=5000, **kw)
    assert full.status == "converged"
    half = ptt.pgm(X0.copy(), _grad_ill, 0.9, max_iter=full.iterations + 10,
                   **kw)
    x, state = _through_file(tmp_path, half)
    rest = ptt.pgm(x, _grad_ill, 0.9, max_iter=50, state=state, **kw)
    assert rest.iterations == 0 and rest.status == "converged"
    assert _equal(rest.x, full.x)
    bad = ptt.pgm(np.ones(3), lambda x: 4.0 * x, 10.0, max_iter=300,
                  e_rel=0.0, accelerated=accelerated, device="cpu")
    assert bad.status == "diverged"
    x, state = _through_file(tmp_path, bad, "bad")
    rest = ptt.pgm(x, lambda x: 4.0 * x, 10.0, max_iter=50, e_rel=0.0,
                   accelerated=accelerated, state=state)
    assert rest.iterations == 0 and rest.status == "diverged"


# ---------------------------------------------------------------------------
# adaprox

@pytest.mark.parametrize("scheme", ["adam", "nadam", "amsgrad", "padam",
                                    "adamx", "radam"])
@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adaprox_resume_through_checkpoint(tmp_path, scheme, moment_dtype):
    kw = dict(scheme=scheme, prox=top.prox_plus, check_convergence=False,
              moment_dtype=moment_dtype, device="cpu")
    full = ptt.adaprox(X0.copy(), _grad_ill, 0.1, max_iter=30, **kw)
    half = ptt.adaprox(X0.copy(), _grad_ill, 0.1, max_iter=13, **kw)
    x, state = _through_file(tmp_path, half)
    if moment_dtype:
        assert state["M"][0].dtype == state["V"][0].dtype == torch.bfloat16
    rest = ptt.adaprox(x, _grad_ill, 0.1, max_iter=17, state=state, **kw)
    assert _equal(rest.x, full.x)
    _assert_same_tree(rest.state, full.state)
    assert rest.state["it"] == 30


def test_adaprox_moment_warm_start_through_checkpoint(tmp_path):
    """tests/test_aux.py's cycle through the M/V/Vhat warm-start interface:
    the resumed run keeps descending, and equals the warm start from
    memory."""
    r1 = ptt.adaprox(X0.copy(), _grad_ill, 0.1, e_rel=0, max_iter=15,
                     check_convergence=False, device="cpu")
    ck = _load(save_checkpoint(str(tmp_path / "adaprox"), x=r1.x, M=r1.M,
                               V=r1.V, Vhat=r1.Vhat))
    kw = dict(e_rel=0, max_iter=15, check_convergence=False)
    r2 = ptt.adaprox(ck["x"], _grad_ill, 0.1, M=ck["M"], V=ck["V"],
                     Vhat=ck["Vhat"], **kw)
    r3 = ptt.adaprox(r1.x, _grad_ill, 0.1, M=r1.M, V=r1.V, Vhat=r1.Vhat,
                     **kw)
    assert torch.equal(r2.x, r3.x)
    assert float(_f_ill(r2.x)) < float(_f_ill(r1.x))


def test_adaprox_stopped_solve_stays_stopped_after_a_reload(tmp_path):
    kw = dict(scheme="adam", prox=top.prox_plus, e_rel=1e-3, device="cpu")
    full = ptt.adaprox(X0.copy(), _grad_ill, 0.2, max_iter=2000, **kw)
    assert full.status == "converged"
    half = ptt.adaprox(X0.copy(), _grad_ill, 0.2,
                       max_iter=full.iterations + 10, **kw)
    x, state = _through_file(tmp_path, half)
    rest = ptt.adaprox(x, _grad_ill, 0.2, max_iter=50, state=state, **kw)
    assert rest.iterations == 0 and torch.equal(rest.x, full.x)


# ---------------------------------------------------------------------------
# the ADMM family

def _quad(rng):
    B = torch.from_numpy(rng.standard_normal((4, 12)))
    return lambda x, step: (x + step * B) / (1.0 + step)


@pytest.mark.parametrize("adapt", [False, True])
def test_admm_resume_through_checkpoint(tmp_path, rng, adapt):
    prox_f = _quad(rng)
    x0 = np.zeros((4, 12))
    kw = dict(prox_g=top.prox_plus, e_rel=1e-14, adapt_step=adapt,
              device="cpu")
    step = 70.0 if adapt else 0.7
    full = ptt.admm(x0.copy(), prox_f, step, max_iter=50, **kw)
    half = ptt.admm(x0.copy(), prox_f, step, max_iter=23, **kw)
    x, state = _through_file(tmp_path, half)
    if adapt:
        assert float(state["step_scale"]) != 1.0
    rest = ptt.admm(x, prox_f, step, max_iter=27, state=state, **kw)
    assert torch.equal(rest.x, full.x) and rest.errors == full.errors
    _assert_same_tree(rest.state, full.state)


def test_sdmm_resume_through_checkpoint(tmp_path, rng):
    prox_f = _quad(rng)
    L = rng.standard_normal((3, 4))
    x0 = np.zeros((4, 12))
    kw = dict(proxs_g=[top.prox_plus, functools.partial(
        top.prox_max, thresh=1.0)], Ls=[None, L], e_rel=1e-14, device="cpu")
    full = ptt.sdmm(x0.copy(), prox_f, 0.7, max_iter=50, **kw)
    half = ptt.sdmm(x0.copy(), prox_f, 0.7, max_iter=25, **kw)
    x, state = _through_file(tmp_path, half)
    assert type(state["z"]) is tuple and len(state["z"]) == 2
    rest = ptt.sdmm(x, prox_f, 0.7, max_iter=25, state=state, **kw)
    assert torch.equal(rest.x, full.x)
    _assert_same_tree(rest.state, full.state)


@pytest.mark.parametrize("family", ["admm", "sdmm"])
def test_admm_family_stays_stopped_after_a_reload(tmp_path, family):
    rng = np.random.default_rng(23)
    B = torch.from_numpy(rng.standard_normal((3, 8)))

    def prox_f(x, step):
        return (x + step * B) / (1.0 + step)

    if family == "admm":
        solver = ptt.admm
        kw = dict(prox_g=top.prox_plus, e_rel=1e-4, e_abs=1e-4)
    else:
        solver = ptt.sdmm
        kw = dict(proxs_g=[top.prox_plus, top.prox_max], e_rel=1e-4,
                  e_abs=1e-4)
    x0 = np.zeros((3, 8))
    full = solver(x0.copy(), prox_f, 0.5, max_iter=500, device="cpu", **kw)
    assert full.status == "converged"
    half = solver(x0.copy(), prox_f, 0.5, max_iter=full.iterations + 10,
                  device="cpu", **kw)
    x, state = _through_file(tmp_path, half)
    rest = solver(x, prox_f, 0.5, max_iter=50, state=state, **kw)
    assert rest.iterations == 0 and torch.equal(rest.x, full.x)


def test_bsdmm_resume_through_checkpoint(tmp_path):
    """Two blocks with nested constraints: Z/U per block and constraint,
    the carried steps and the sweep clock cross the file; then the
    converged solve stays stopped."""
    c1 = torch.tensor([2.0, -1.0], dtype=torch.float64)
    c2 = torch.tensor([3.0, 0.5, -0.2], dtype=torch.float64)

    def proxs_f(x, step, j=None, Xs=None):
        return (x + step * (c1, c2)[j]) / (1 + step)

    def pg(v, step):
        return torch.clamp_min(v, 0)

    def run(x, n, state=None, e_rel=0.0):
        return ptt.bsdmm(list(x), proxs_f, lambda Xs, j=None: 0.4,
                         proxs_g=[[pg], [pg, pg]], e_rel=e_rel, max_iter=n,
                         state=state, device="cpu")

    x0 = [torch.zeros(2, dtype=torch.float64),
          torch.zeros(3, dtype=torch.float64)]
    full = run(x0, 30)
    half = run(x0, 11)
    x, state = _through_file(tmp_path, half)
    assert type(state["z"][1]) is tuple and len(state["z"][1]) == 2
    rest = run(x, 19, state)
    assert _equal(rest.x, full.x)
    _assert_same_tree(rest.state, full.state)
    done = run(x0, 500, e_rel=1e-4)
    assert done.status == "converged"
    x, state = _through_file(tmp_path, run(x0, done.iterations + 10,
                                           e_rel=1e-4), "done")
    rest = run(x, 50, state, e_rel=1e-4)
    assert rest.iterations == 0 and _equal(rest.x, done.x)


# ---------------------------------------------------------------------------
# nmf, both engines

def _nmf_problem(seed=5, C=4, K=3, N=160, dtype=np.float32):
    rng = np.random.default_rng(seed)
    Y = (rng.random((C, K)) @ rng.random((K, N))
         + 0.01 * rng.standard_normal((C, N))).astype(dtype)
    W = (rng.random((C, N)) + 0.5).astype(dtype)
    return Y, W, rng.random((C, K)).astype(dtype), rng.random(
        (K, N)).astype(dtype)


def _f_nmf(Y):
    return functools.partial(ptt.nmf.log_likelihood, Y=torch.from_numpy(Y))


def _long_steps(*X, it=None):
    return tuple(6 * s for s in ptt.nmf.step_pgm(*X))


# label -> nmf keywords ("W" stands for the problem's weights, "f" for its
# likelihood); the cuda engine runs its kernels' plain versions here, at a
# tile of 128 columns so the 160 pixels span two tiles
NMF_CASES = {
    "torch pgm": {},
    "torch pgm backtracking": {"backtracking": True, "f": "f",
                               "step": _long_steps},
    "torch fista backtracking": {"accelerated": True, "backtracking": True,
                                 "f": "f", "step": _long_steps},
    "torch pgm stride 4": {"step_stride": 4},
    "torch weighted adaptive": {"W": "W", "step_stride": 4,
                                "step_adapt": True},
    "torch adaprox": {"algorithm": "adaprox"},
    "torch adaprox separable bf16 moments": {
        "algorithm": "adaprox", "separable_prox": "auto",
        "moment_dtype": "bfloat16"},
    "torch adaprox adaptive": {"algorithm": "adaprox", "step_adapt": True},
    "torch bsdmm": {"algorithm": "bsdmm"},
    "torch bsdmm stride 3": {"algorithm": "bsdmm", "step_stride": 3},
    "torch bsdmm weighted adaptive": {"algorithm": "bsdmm", "W": "W",
                                      "step_stride": 4, "step_adapt": True},
    "cuda exact": {"engine": "cuda", "tile_n": 128},
    "cuda stride 4": {"engine": "cuda", "tile_n": 128, "step_stride": 4},
    "cuda adaptive": {"engine": "cuda", "tile_n": 128, "step_adapt": True},
    "cuda weighted stride 4": {"engine": "cuda", "tile_n": 128, "W": "W",
                               "step_stride": 4},
    "cuda weighted adaptive bf16 store": {
        "engine": "cuda", "tile_n": 128, "W": "W", "step_stride": 4,
        "step_adapt": True, "store_dtype": "bfloat16"},
    "cuda bf16 store": {"engine": "cuda", "tile_n": 128,
                        "store_dtype": torch.bfloat16},
    "cuda adaprox": {"engine": "cuda", "algorithm": "adaprox",
                     "tile_n": 128},
    "cuda adaprox weighted bf16 store and moments": {
        "engine": "cuda", "algorithm": "adaprox", "tile_n": 128, "W": "W",
        "store_dtype": "bfloat16", "moment_dtype": "bfloat16"},
}


def _nmf_run(Y, W, kw):
    kw = dict(kw)
    if kw.get("W") == "W":
        kw["W"] = W
    if kw.get("f") == "f":
        kw["f"] = _f_nmf(Y)

    def run(A, S, n, state=None):
        return ptt.nmf.nmf(Y, A, S, e_rel=0, max_iter=n, device="cpu",
                           state=state, **kw)
    return run


@pytest.mark.parametrize("case", sorted(NMF_CASES))
def test_nmf_resume_through_checkpoint(tmp_path, case):
    """Kill after 8 of 20 iterations (a refresh boundary of the stride-4
    cases), save, load, resume: equal to the straight run bit for bit, the
    final states too."""
    Y, W, A0, S0 = _nmf_problem()
    run = _nmf_run(Y, W, NMF_CASES[case])
    full = run(A0.copy(), S0.copy(), 20)
    half = run(A0.copy(), S0.copy(), 8)
    assert half.iterations == 8
    (A, S), state = _through_file(tmp_path, half)
    rest = run(A, S, 12, state)
    assert rest.iterations == 12
    assert _equal(rest.x, full.x)
    _assert_same_tree(rest.state, full.state)


@pytest.mark.parametrize("trial", range(8))
def test_nmf_resume_random_kill_points_through_checkpoint(tmp_path, trial):
    """Random configuration and kill point (tests/test_resume_sweep.py),
    in three pieces with a file between each."""
    rng = np.random.default_rng(5000 + trial)
    labels = sorted(NMF_CASES)
    case = labels[int(rng.integers(0, len(labels)))]
    Y, W, A0, S0 = _nmf_problem(seed=6000 + trial,
                                N=int(rng.integers(130, 300)))
    run = _nmf_run(Y, W, NMF_CASES[case])
    total = int(rng.integers(10, 30))
    k1 = int(rng.integers(1, total - 1))
    k2 = int(rng.integers(k1 + 1, total))
    full = run(A0.copy(), S0.copy(), total)
    seg = run(A0.copy(), S0.copy(), k1)
    for n, name in ((k2 - k1, "a"), (total - k2, "b")):
        (A, S), state = _through_file(tmp_path, seg, name)
        seg = run(A, S, n, state)
    assert _equal(seg.x, full.x), (case, k1, k2, total)
    _assert_same_tree(seg.state, full.state)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_nmf_stopped_solve_stays_stopped_after_a_reload(tmp_path, engine):
    Y, _, A0, S0 = _nmf_problem(seed=0, dtype=np.float64)
    kw = dict(e_rel=1e-2, engine=engine, device="cpu")
    full = ptt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=3000, **kw)
    assert full.status == "converged"
    half = ptt.nmf.nmf(Y, A0.copy(), S0.copy(),
                       max_iter=full.iterations + 5, **kw)
    (A, S), state = _through_file(tmp_path, half)
    rest = ptt.nmf.nmf(Y, A, S, max_iter=20, state=state, **kw)
    assert rest.iterations == 0 and rest.status == "converged"
    assert _equal(rest.x, full.x)


def test_a_jax_solve_continues_through_interop_then_a_file(tmp_path):
    """The route from a JAX solve: its state crosses with
    ``state_from_numpy`` (a JAX ``.pkl`` holds a pickled JAX tree
    definition), and from then on through the port's own file."""
    import jax

    from proxmin_tpu_torch.interop import state_from_numpy

    Y, W, A0, S0 = _nmf_problem(dtype=np.float64)
    kw = dict(W=W, e_rel=0, step_stride=4, step_adapt=True)
    full = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=20, **kw)
    half = pt.nmf.nmf(Y, A0.copy(), S0.copy(), max_iter=8, **kw)
    state = state_from_numpy(jax.tree_util.tree_map(np.asarray, half.state),
                             device="cpu")
    path = save_checkpoint(str(tmp_path / "from_jax"),
                           x=tuple(np.asarray(x) for x in half.x),
                           solver_state=state)
    ck = _load(path)
    assert type(ck["x"][0]) is np.ndarray
    rest = ptt.nmf.nmf(Y, *ck["x"], max_iter=12, device="cpu",
                       state=ck["solver_state"], **kw)
    assert rest.state["it"] == 20
    for t, j in zip(rest.x, full.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-9)
