"""``nmf(engine="auto")`` in the port against the JAX package's routing
rules, with the regions measured on the H100 (``tools/engine_sweep.py``).

- The two eligibility predicates, ``_fused_prox_safe`` and
  ``_adaprox_separable_ok``, equal the JAX package's on every library prox
  (both blocks, the ``axis`` keyword, a positional ``partial``, a user
  callable, ``AlternatingProjections``).
- The decisions are pinned by counting the calls that reach
  ``nmf_pgm_fused``, ``nmf_adaprox_fused`` and the torch drivers, as
  ``tests/test_pallas_ops.py`` counts them; shapes whose size alone decides
  are routed with stand-ins that record the call and stop it (the route
  reads shapes only).
- ``auto``'s solve equals the chosen engine's bit for bit (on CPU tensors
  the cuda engine runs K1's and K2's plain versions), and so does its
  resume.

Calibration is off in this file (the static regions decide); the probes
are ``tests/test_torch_calibrate.py``'s.
"""

import functools
from functools import partial

import numpy as np
import pytest
import torch

import proxmin_tpu as pt
import proxmin_tpu_torch as ptt
from proxmin_tpu_torch import calibrate
from proxmin_tpu_torch import nmf as tnmf

_nmf = functools.partial(tnmf.nmf, device="cpu")


@pytest.fixture(autouse=True)
def _static_routing(tmp_path, monkeypatch):
    """Calibration off, its cache in tmp_path and empty; one thread."""
    monkeypatch.setenv("PROXMIN_TPU_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "routing.json"))
    calibrate.clear_cache()
    calibrate._DISK, calibrate._DISK_LOADED = {}, False
    prev = calibrate.set_auto_calibration("off")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    calibrate.set_auto_calibration(prev)
    calibrate.clear_cache()
    calibrate._DISK, calibrate._DISK_LOADED = {}, False


# -------------------------------------------------------------------------
# The eligibility predicates against JAX's

def _library_cases():
    """(id, builder(operators module)) for every library prox and the
    forms the routing rule distinguishes."""
    names = ("prox_id", "prox_zero", "prox_plus", "prox_unity",
             "prox_unity_plus", "prox_min", "prox_max", "prox_components",
             "prox_hard", "prox_hard_plus", "prox_soft", "prox_soft_plus",
             "prox_max_entropy")
    cases = [("None", lambda op: None)]
    cases += [(n, lambda op, n=n: getattr(op, n)) for n in names]
    cases += [
        ("unity axis=0", lambda op: partial(op.prox_unity, axis=0)),
        ("unity axis=1", lambda op: partial(op.prox_unity, axis=1)),
        ("unity_plus axis=0", lambda op: partial(op.prox_unity_plus,
                                                 axis=0)),
        ("unity_plus axis=1", lambda op: partial(op.prox_unity_plus,
                                                 axis=1)),
        ("soft absolute", lambda op: partial(op.prox_soft, thresh=0.1,
                                             type="absolute")),
        ("soft_plus relative", lambda op: partial(
            op.prox_soft_plus, thresh=0.1, type="relative")),
        ("hard", lambda op: partial(op.prox_hard, thresh=0.2)),
        ("min", lambda op: partial(op.prox_min, thresh=0.5)),
        ("max", lambda op: partial(op.prox_max, thresh=2.0)),
        ("max_entropy", lambda op: partial(op.prox_max_entropy, thresh=0.3)),
        ("positional partial", lambda op: partial(op.prox_soft, 0.5)),
        ("user callable", lambda op: (lambda X, step: X)),
        ("alternating", lambda op: op.AlternatingProjections(
            [op.prox_plus, partial(op.prox_unity, axis=0)])),
        ("alternating axis=1", lambda op: op.AlternatingProjections(
            [op.prox_plus, partial(op.prox_unity_plus, axis=1)])),
        ("alternating callable", lambda op: op.AlternatingProjections(
            [op.prox_plus, lambda X, step: X])),
    ]
    return cases


CASES = _library_cases()


@pytest.mark.parametrize("block", ["A", "S"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fused_prox_safe_matches_jax(case, block):
    _, build = case
    assert (tnmf._fused_prox_safe(build(ptt.operators), block)
            == pt.nmf._fused_prox_safe(build(pt.operators), block))


@pytest.mark.parametrize("mode", ["auto", True, False, "sometimes"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_adaprox_separable_ok_matches_jax(case, mode):
    _, build = case
    for pair in ((None, 0), (0, None), (0, 0)):
        pj = tuple(None if p is None else build(pt.operators) for p in pair)
        pt_ = tuple(None if p is None else build(ptt.operators)
                    for p in pair)
        assert (tnmf._adaprox_separable_ok(*pt_, mode)
                == pt.nmf._adaprox_separable_ok(*pj, mode))


def test_kernels_cover(routes):
    """The kernels take every (C, K) since the very-wide body: auto has no
    width gate, and routes a shape past C = 256 or K = 32 by the table's
    rows for the very-wide shapes swept on the card, as it routes any
    other."""
    for C, K in ((300, 8), (425, 32), (128, 64)):
        assert (C, K) in tnmf._H100_REGIONS["pgm-exact"]
        for N in (100_000, 1_000_000):
            want = "cuda" if tnmf._unweighted_fused_wins(C, K, N) else "torch"
            assert _route(routes, C, K, N) == f"pgm {want}"
            want = "cuda" if tnmf._adaprox_fused_wins(C, K, N) else "torch"
            assert _route(routes, C, K, N, algorithm="adaprox") == (
                f"adaprox {want}")


# -------------------------------------------------------------------------
# Decisions, counted

class _Routed(Exception):
    pass


@pytest.fixture
def routes(monkeypatch):
    """Stand-ins for the two fused entries and the torch drivers that record
    which one a call reached and stop it there."""
    seen = []

    def stand_in(name):
        def fn(*a, **k):
            seen.append(name)
            raise _Routed(name)
        return fn

    monkeypatch.setattr(tnmf, "nmf_pgm_fused", stand_in("pgm cuda"))
    monkeypatch.setattr(tnmf, "nmf_adaprox_fused", stand_in("adaprox cuda"))
    monkeypatch.setattr(tnmf.algorithms, "pgm", stand_in("pgm torch"))
    monkeypatch.setattr(tnmf.algorithms, "adaprox",
                        stand_in("adaprox torch"))
    monkeypatch.setattr(tnmf.algorithms, "bsdmm", stand_in("bsdmm torch"))
    # the torch route's set-up before its driver would materialize W and
    # the power iterate at the shape: keep the stand-in operands as they are
    monkeypatch.setattr(tnmf, "_promote_W", lambda W, Y: W)
    monkeypatch.setattr(tnmf, "WeightedPGMStepper", lambda *a, **k: None)
    return seen


def _shape_only(C, K, N):
    """Operands of the shape (C, K, N) that hold one number each."""
    def z(r, c):
        return torch.zeros(1, 1, dtype=torch.float32).expand(r, c)
    return z(C, N), z(C, K), z(K, N)


def _weights(C, N):
    """A weight of 2 in the shape (C, N), one number held."""
    return torch.full((1, 1), 2.0).expand(C, N)


def _route(seen, C, K, N, **kw):
    Y, A, S = _shape_only(C, K, N)
    with pytest.raises(_Routed):
        tnmf.nmf(Y, A, S, engine="auto", max_iter=1, **kw)
    return seen.pop()


_REGION_KW = {
    "pgm-exact": ({}, "pgm"),
    "pgm-stride10": ({"step_stride": 10}, "pgm"),
    "pgm-w-stride10": ({"W": "W", "step_stride": 10}, "pgm"),
    "adaprox-f32": ({"algorithm": "adaprox"}, "adaprox"),
}
_BOUNDARIES = [(path, ck) for path, table in tnmf._H100_REGIONS.items()
               for ck in table]


@pytest.mark.parametrize("path,ck", _BOUNDARIES,
                         ids=[f"{p}-{c}x{k}" for p, (c, k) in _BOUNDARIES])
def test_decisions_on_both_sides_of_each_h100_boundary(routes, path, ck):
    """At every swept (C, K) of every region: the torch engine one pixel
    below the crossover, the cuda engine at it and at 1e8 (and at any N
    where the cuda engine won every swept N)."""
    kw, algorithm = _REGION_KW[path]
    C, K = ck
    n_x, _ = tnmf._H100_REGIONS[path][ck]

    def route(N):
        extra = dict(kw)
        if extra.get("W") == "W":
            extra["W"] = _weights(C, N)
        return _route(routes, C, K, N, **extra)

    if n_x is None:
        assert route(10 ** 8) == f"{algorithm} torch"
        return
    assert route(max(n_x, 1)) == f"{algorithm} cuda"
    assert route(10 ** 8) == f"{algorithm} cuda"
    if n_x > 1:
        assert route(n_x - 1) == f"{algorithm} torch"


def test_decisions_at_named_shapes(routes):
    """The H100 table at the flagship and at full width, written out."""
    W5 = _weights(5, 10_000_000)
    assert _route(routes, 5, 7, 1_000_000) == "pgm cuda"
    assert _route(routes, 5, 7, 100_000) == "pgm torch"
    assert _route(routes, 3, 2, 100_000) == "pgm torch"  # covered by (5, 7)
    assert _route(routes, 10, 8, 10_000) == "pgm cuda"   # by (16, 8)
    assert _route(routes, 128, 32, 100_000) == "pgm cuda"
    assert _route(routes, 5, 7, 1_000_000, step_stride=10) == "pgm cuda"
    assert _route(routes, 5, 7, 1_000_000, step_adapt=True) == "pgm cuda"
    assert _route(routes, 5, 7, 10_000_000, W=W5,
                  step_stride=10) == "pgm cuda"
    assert _route(routes, 5, 7, 1_000_000, W=W5[:, :1_000_000],
                  step_stride=10, step_adapt=True) == "pgm torch"
    assert _route(routes, 128, 32, 10_000, W=_weights(128, 10_000),
                  step_stride=10) == "pgm cuda"
    assert _route(routes, 5, 7, 10_000, algorithm="adaprox") == (
        "adaprox cuda")
    assert _route(routes, 200, 32, 100_000, algorithm="adaprox") == (
        "adaprox torch")
    assert _route(routes, 200, 32, 1_000_000, algorithm="adaprox") == (
        "adaprox cuda")


def test_beyond_the_kernels_routes_to_torch(routes):
    """C = 257 and K = 33, once beyond the kernels, route by the table's
    very-wide rows that cover them ((300, 8) and (128, 64)) on every path
    and at any N, and the kernels' opt-ins (tile_n, bfloat16 moments) go
    to cuda there as anywhere; a shape past every swept row runs torch."""
    for C, K in ((257, 8), (64, 33)):
        for N in (10_000, 10_000_000):
            for path, (kw, algorithm) in _REGION_KW.items():
                extra = dict(kw)
                if extra.get("W") == "W":
                    extra["W"] = _weights(C, N)
                want = ("cuda" if tnmf._cuda_wins(path, C, K, N)
                        else "torch")
                assert _route(routes, C, K, N, **extra) == (
                    f"{algorithm} {want}")
            assert _route(routes, C, K, N, algorithm="adaprox",
                          moment_dtype=torch.bfloat16) == "adaprox cuda"
        assert _route(routes, C, K, 100, tile_n=128) == "pgm cuda"
    for C, K in ((600, 8), (128, 129), (426, 32)):
        assert _route(routes, C, K, 10_000_000) == "pgm torch"
        assert _route(routes, C, K, 10_000_000, algorithm="adaprox") == (
            "adaprox torch")


def test_opt_ins_route_to_the_kernels(routes):
    """A reduced moment or store dtype and an explicit tile_n are requests
    only the kernels serve: cuda at any size."""
    W = _weights(5, 100)
    assert _route(routes, 5, 7, 100, algorithm="adaprox",
                  moment_dtype="bfloat16") == "adaprox cuda"
    assert _route(routes, 5, 7, 100, algorithm="adaprox",
                  store_dtype=torch.bfloat16) == "adaprox cuda"
    assert _route(routes, 5, 7, 100, algorithm="adaprox",
                  tile_n=1024) == "adaprox cuda"
    assert _route(routes, 5, 7, 100, tile_n=1024) == "pgm cuda"
    assert _route(routes, 5, 7, 100, W=W,
                  store_dtype="bfloat16") == "pgm cuda"


def test_rules_that_keep_torch(routes):
    """The JAX rules that keep the torch engine whatever the size: a
    custom step, a callback, driver options, bsdmm, a weighted solve
    without a stride or a store, non-separable AdaProx proxes, other
    schemes, a prox the kernel cannot apply per pixel."""
    big = 10_000_000
    W = _weights(5, big)
    step = partial(tnmf.step_pgm)
    assert _route(routes, 5, 7, big, step=step) == "pgm torch"
    assert _route(routes, 5, 7, big,
                  callback=lambda *a, **k: None) == "pgm torch"
    assert _route(routes, 5, 7, big, accelerated=True) == "pgm torch"
    assert _route(routes, 5, 7, big, algorithm="bsdmm") == "bsdmm torch"
    assert _route(routes, 5, 7, big, W=W) == "pgm torch"
    assert _route(routes, 5, 7, big, prox_S=partial(
        ptt.operators.prox_unity_plus, axis=1)) == "pgm torch"
    assert _route(routes, 5, 7, big, prox_S=lambda X, s: X) == "pgm torch"
    assert _route(routes, 5, 7, big, algorithm="adaprox",
                  scheme="amsgrad") == "adaprox torch"
    assert _route(routes, 5, 7, big, algorithm="adaprox", prox_S=partial(
        ptt.operators.prox_soft, thresh=0.1, type="absolute"),
        moment_dtype="bfloat16") == "adaprox torch"
    assert _route(routes, 5, 7, big, algorithm="adaprox",
                  step_stride=10) == "adaprox torch"


def _data(C=5, K=3, N=400, seed=7):
    rng = np.random.default_rng(seed)
    Y = (rng.random((C, K)) @ rng.random((K, N))
         + 0.01 * rng.standard_normal((C, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    return (Y, rng.random((C, K)).astype(np.float32),
            rng.random((K, N)).astype(np.float32), W)


@pytest.mark.parametrize("path", [
    "pgm-exact", "pgm-stride10", "pgm-adapt", "pgm-w-stride10",
    "pgm-w-adapt", "adaprox-f32"])
@pytest.mark.parametrize("wins", [True, False])
def test_auto_equals_the_chosen_engine_bit_for_bit(path, wins, monkeypatch):
    """Whichever engine the region names, auto's solve is that engine's."""
    region, kw = {
        "pgm-exact": ("_unweighted_fused_wins", {}),
        "pgm-stride10": ("_unweighted_strided_fused_wins",
                         {"step_stride": 10}),
        "pgm-adapt": ("_unweighted_strided_fused_wins",
                      {"step_adapt": True}),
        "pgm-w-stride10": ("_weighted_fused_wins", {"step_stride": 10}),
        "pgm-w-adapt": ("_weighted_fused_wins",
                        {"step_stride": 10, "step_adapt": True}),
        "adaprox-f32": ("_adaprox_fused_wins", {"algorithm": "adaprox"}),
    }[path]
    monkeypatch.setattr(tnmf, region, lambda C, K, N: wins)
    Y, A0, S0, W = _data()
    if "-w-" in path:
        kw["W"] = W
    res = _nmf(Y, A0.copy(), S0.copy(), engine="auto", e_rel=0,
               max_iter=12, **kw)
    ref = _nmf(Y, A0.copy(), S0.copy(), engine="cuda" if wins else "torch",
               e_rel=0, max_iter=12, **kw)
    assert res.iterations == ref.iterations == 12
    for got, want in zip(res.x, ref.x):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [
    {"algorithm": "adaprox", "moment_dtype": "bfloat16"},
    {"algorithm": "adaprox", "store_dtype": torch.bfloat16},
    {"tile_n": 128},
    {"W": "W", "store_dtype": "bfloat16"},
    {"W": "W", "step_stride": 10, "store_dtype": "bfloat16"},
], ids=["bf16 moments", "adaprox bf16 store", "tile_n", "weighted store",
        "weighted stride store"])
def test_auto_opt_ins_equal_the_cuda_engine(kw):
    Y, A0, S0, W = _data()
    kw = {k: W if v == "W" else v for k, v in kw.items()}
    res = _nmf(Y, A0.copy(), S0.copy(), engine="auto", e_rel=0,
               max_iter=8, **kw)
    ref = _nmf(Y, A0.copy(), S0.copy(), engine="cuda", e_rel=0,
               max_iter=8, **kw)
    for got, want in zip(res.x, ref.x):
        assert torch.equal(got, want)


@pytest.mark.parametrize("store", [None, "float32", torch.float32,
                                   np.float64])
@pytest.mark.parametrize("algorithm", ["pgm", "adaprox"])
def test_full_width_store_dtype_is_normalized_away(store, algorithm,
                                                   monkeypatch):
    """A full-width store_dtype is the default layout: on the torch route
    (which has no store option) auto drops it, as JAX does."""
    monkeypatch.setattr(tnmf, "_unweighted_fused_wins", lambda *a: False)
    monkeypatch.setattr(tnmf, "_adaprox_fused_wins", lambda *a: False)
    Y, A0, S0, _ = _data()
    res = _nmf(Y, A0.copy(), S0.copy(), engine="auto", e_rel=0, max_iter=5,
               algorithm=algorithm, store_dtype=store)
    ref = _nmf(Y, A0.copy(), S0.copy(), engine="torch", e_rel=0,
               max_iter=5, algorithm=algorithm)
    for got, want in zip(res.x, ref.x):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="store_dtype"):
        _nmf(Y, A0.copy(), S0.copy(), engine="torch", max_iter=1,
             algorithm=algorithm, store_dtype=store)


@pytest.mark.parametrize("case", ["adaprox tile_n soft", "pgm tile_n step",
                                  "pgm store callback", "bsdmm tile_n",
                                  "weighted tile_n"])
def test_cuda_only_kwargs_raise_where_jax_raises(case):
    """tile_n and a reduced store_dtype on a call that cannot route to the
    kernels raise ValueError, in both packages."""
    import jax.numpy as jnp

    Y, A0, S0, W = _data(C=4, N=256)

    def kwargs(op, nmf_mod):
        return {
            "adaprox tile_n soft": dict(
                tile_n=128, algorithm="adaprox",
                prox_S=partial(op.prox_soft, thresh=0.1, type="absolute")),
            "pgm tile_n step": dict(tile_n=128, step=nmf_mod.step_pgm),
            "pgm store callback": dict(store_dtype="bfloat16",
                                       callback=lambda *a, **k: None),
            "bsdmm tile_n": dict(tile_n=128, algorithm="bsdmm"),
            "weighted tile_n": dict(tile_n=128, W=W),
        }[case]

    with pytest.raises(ValueError):
        pt.nmf.nmf(jnp.asarray(Y), jnp.asarray(A0), jnp.asarray(S0),
                   engine="auto", max_iter=2,
                   **kwargs(pt.operators, pt.nmf))
    with pytest.raises(ValueError, match="cuda-engine options"):
        _nmf(Y, A0.copy(), S0.copy(), engine="auto", max_iter=2,
             **kwargs(ptt.operators, tnmf))


@pytest.mark.parametrize("route", ["pgm cuda", "pgm torch", "adaprox cuda",
                                   "adaprox torch"])
def test_auto_resumes_on_the_engine_that_made_it(route, monkeypatch):
    """An auto solve's .state resumes through auto on its own engine: 4 + 8
    iterations equal 12 straight ones bit for bit."""
    algorithm, engine = route.split()
    region = ("_unweighted_fused_wins" if algorithm == "pgm"
              else "_adaprox_fused_wins")
    monkeypatch.setattr(tnmf, region, lambda *a: engine == "cuda")
    Y, A0, S0, _ = _data()
    kw = dict(engine="auto", e_rel=0, algorithm=algorithm)
    straight = _nmf(Y, A0.copy(), S0.copy(), max_iter=12, **kw)
    first = _nmf(Y, A0.copy(), S0.copy(), max_iter=4, **kw)
    # the table flips between the two calls: the state still decides
    monkeypatch.setattr(tnmf, region, lambda *a: engine != "cuda")
    second = _nmf(Y, *(x.numpy() for x in first.x), max_iter=8,
                  state=first.state, **kw)
    for got, want in zip(second.x, straight.x):
        assert torch.equal(got, want)
    fused = (first.state.get("kind") == "nmf_pgm_fused"
             or "fused_config" in first.state)
    assert fused == (engine == "cuda")


@pytest.fixture
def group(tmp_path):
    import torch.distributed as dist

    from proxmin_tpu_torch import parallel as tpar

    tpar.initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0)
    yield tpar
    dist.destroy_process_group()


@pytest.mark.parametrize("algorithm", ["pgm", "adaprox"])
def test_auto_under_a_mesh_is_the_sharded_solve(group, algorithm):
    """Under mesh=, auto takes the explicit sharded solves as before."""
    Y, A0, S0, _ = _data()
    mesh = group.make_mesh(device="cpu")
    kw = dict(mesh=mesh, e_rel=0, max_iter=6, algorithm=algorithm)
    res = tnmf.nmf(Y, A0.copy(), S0.copy(), engine="auto", **kw)
    ref = tnmf.nmf(Y, A0.copy(), S0.copy(), engine="torch", **kw)
    assert res.state["kind"] == ref.state["kind"]
    for got, want in zip(res.x, ref.x):
        assert torch.equal(got.full_tensor(), want.full_tensor())
