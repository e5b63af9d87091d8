"""The port's export against proxmin_tpu.export and against the port's own
drivers.

Every exporter's program is held twice on the same seeded NumPy inputs:
- against its JAX twin, ``proxmin_tpu.export.load_solver(export_*(...))``
  (the fused NMF ones running the Pallas kernels as the JAX suite runs them
  on the CPU): fused NMF float32 rtol 1e-3, atol 1e-5 as in
  test_torch_nmf.py (float32 sums over the pixels in other orders, compounded
  over 15 iterations); the bfloat16 store atol 1e-2 after 8 iterations, as
  test_torch_nmf_weighted.py holds the bfloat16 solves; the generic solvers
  in float64 rtol 1e-9 (only the libraries' summation orders differ);
- against the port's driver on the same inputs: bit for bit (the program
  runs the driver's body, with K1/K2 as registered ops whose CPU
  implementation is the drivers' plain version).
Resume chains equal the straight solve bit for bit, and a JAX artifact's
carries continue in the port's program to JAX's straight solve within the
float32 tolerance. The generic exporters are in
test_torch_export_generic.py (the two files run in parallel).
"""

import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxmin_tpu.export as jex
import proxmin_tpu_torch as ptt
import proxmin_tpu_torch.export as tex
from proxmin_tpu_torch.utils import grow_stride

C, K, N, TILE = 4, 3, 256, 128
F32 = dict(rtol=1e-3, atol=1e-5)
BF16 = dict(rtol=0, atol=1e-2)
F64 = dict(rtol=1e-9, atol=0)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    Y = (rng.random((C, K)) @ rng.random((K, N))).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    return Y, W, A0, S0


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.cache
def _blob(kind, **kw):
    """A port program, exported once per configuration; a fresh one
    returns its carries (its first outputs are the plain program's), so
    the tests share it."""
    exporter = {"pgm": tex.export_nmf_solver,
                "adaprox": tex.export_nmf_adaprox_solver}[kind]
    if not kw.get("resume"):
        kw = dict(kw, return_carries=True)
    return exporter(C, K, N, e_rel=0.0, tile_n=TILE, device="cpu", **kw)


@functools.cache
def _port(kind, **kw):
    return tex.load_solver(_blob(kind, **kw))


@functools.cache
def _jax(kind, **kw):
    exporter = {"pgm": jex.export_nmf_solver,
                "adaprox": jex.export_nmf_adaprox_solver}[kind]
    return jex.load_solver(exporter(C, K, N, e_rel=0.0, tile_n=TILE, **kw))


def _jax_kw(kw):
    return {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
            for k, v in kw.items()}


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(torch.as_tensor(g), torch.as_tensor(w))


PGM_CASES = [
    {},
    {"weighted": True},
    {"weighted": True, "step_stride": 4},
    {"weighted": True, "step_stride": 4, "step_adapt": True},
    {"store_dtype": torch.bfloat16},
]


@pytest.mark.parametrize("kw", PGM_CASES, ids=str)
def test_nmf_pgm_program_matches_jax_and_the_driver(kw):
    Y, W, A0, S0 = _problem()
    weighted = kw.get("weighted", False)
    bf16 = "store_dtype" in kw
    n = 8 if bf16 else 15
    data = (A0, S0, Y) + ((W,) if weighted else ())
    got = _port("pgm", **kw)(*data, n)
    assert len(got) == (11 if weighted else 7) and int(got[2]) == n
    want = _jax("pgm", **_jax_kw(kw))(*data, n)
    tol = BF16 if bf16 else F32
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    assert int(got[2]) == int(want[2])

    res = ptt.nmf.nmf_pgm_fused(
        Y, A0.copy(), S0.copy(), W=W if weighted else None, e_rel=0,
        max_iter=n, tile_n=TILE, store_dtype=kw.get("store_dtype"),
        step_stride=kw.get("step_stride"),
        step_adapt=kw.get("step_adapt", False), device="cpu")
    _equal(got[:2], res.x)
    assert int(got[2]) == res.iterations
    assert (bool(got[3]), bool(got[4])) == tuple(res.converged)
    assert float(got[5]) == res.loss


ADAPROX_CASES = [
    {},
    {"weighted": True},
    {"moment_dtype": torch.bfloat16},
    {"moment_dtype": torch.bfloat16, "store_dtype": torch.bfloat16},
]


@pytest.mark.parametrize("kw", ADAPROX_CASES, ids=str)
def test_nmf_adaprox_program_matches_jax_and_the_driver(kw):
    Y, W, A0, S0 = _problem(1)
    weighted = kw.get("weighted", False)
    bf16 = "store_dtype" in kw or "moment_dtype" in kw
    n = 8 if bf16 else 15
    data = (A0, S0, Y) + ((W,) if weighted else ())
    got = _port("adaprox", **kw)(*data, n)
    assert len(got) == 11 and int(got[2]) == n
    want = _jax("adaprox", **_jax_kw(kw))(*data, n)
    tol = BF16 if bf16 else F32
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)

    res = ptt.nmf.nmf_adaprox_fused(
        Y, A0.copy(), S0.copy(), W=W if weighted else None, e_rel=0,
        max_iter=n, tile_n=TILE, moment_dtype=kw.get("moment_dtype"),
        store_dtype=kw.get("store_dtype"), device="cpu")
    _equal(got[:2], res.x)
    _equal(got[6:10], (res.M[0], res.V[0], res.M[1], res.V[1]))
    assert float(got[5]) == res.loss


def test_nmf_adaprox_warm_start_program_equals_the_warm_driver():
    """``warm_start=True`` takes a previous program's moments and restarts
    the bias-correction clock, as the driver's ``M=``/``V=``."""
    Y, _, A0, S0 = _problem(2)
    first = _port("adaprox")(A0, S0, Y, 6)
    warm = tex.load_solver(tex.export_nmf_adaprox_solver(
        C, K, N, e_rel=0.0, tile_n=TILE, warm_start=True, device="cpu"))
    got = warm(first[0], first[1], Y, 7, *first[6:10])
    res = ptt.nmf.nmf_adaprox_fused(
        Y, first[0].clone(), first[1].clone(), e_rel=0, max_iter=7,
        tile_n=TILE, M=(first[6], first[8]), V=(first[7], first[9]),
        device="cpu")
    _equal(got[:2], res.x)


def _numpy_f32_corrections(b1, b2, t):
    """The bias corrections as float32 NumPy powers (the eager driver's
    form before the programs)."""
    one, b1_t, b2_t, t = (np.float32(v) for v in (1, b1, b2, t))
    return b1_t, one / (one - b1_t ** t), one / (one - b2_t ** t)


def _jax_f32_corrections(b1, b2, t):
    """The bias corrections as the JAX runner forms them: float32 powers
    in XLA."""
    b1_t, t = jnp.asarray(b1, jnp.float32), jnp.float32(t)
    bc1 = 1.0 / (1.0 - b1_t ** t)
    bc2 = 1.0 / (1.0 - jnp.asarray(b2, jnp.float32) ** t)
    return tuple(np.float32(v) for v in (b1_t, bc1, bc2))


_DRIVER_CORRECTIONS = ptt.nmf._bias_corrections


def _ulp_off_corrections(b1, b2, t):
    """The driver's corrections one float32 ulp up at every tenth step:
    what a float32 power that misses the correctly rounded value does
    (NumPy's float32 power is not correctly rounded on every platform)."""
    b1_t, bc1, bc2 = _DRIVER_CORRECTIONS(b1, b2, t)
    if t % 10 == 0:
        bc1, bc2 = (np.nextafter(v, np.float32(np.inf)) for v in (bc1, bc2))
    return b1_t, bc1, bc2


@pytest.mark.parametrize("form", [_numpy_f32_corrections,
                                  _jax_f32_corrections, _ulp_off_corrections],
                         ids=["numpy float32", "jax float32",
                              "one ulp off at every tenth step"])
def test_adaprox_driver_drifts_little_from_float32_powers(monkeypatch, form):
    """The fused AdaProx driver forms its bias corrections as float64
    powers rounded to float32, the form a program computes on the card
    (so the two agree bit for bit); a float32 power may round a step's
    scalars differently in the last bit. After 100 iterations the driver
    on such a form stays within 1e-6 normwise of it."""
    Y, _, A0, S0 = _problem(4)
    b1, b2 = 0.9, 0.999
    differ = sum(tuple(_DRIVER_CORRECTIONS(b1, b2, t))
                 != tuple(form(b1, b2, t)) for t in range(1, 101))

    def solve():
        return ptt.nmf.nmf_adaprox_fused(
            Y, A0.copy(), S0.copy(), e_rel=0, max_iter=100, tile_n=TILE,
            device="cpu")

    base = solve()
    monkeypatch.setattr(ptt.nmf, "_bias_corrections", form)
    other = solve()
    for x, y in zip(base.x, other.x):
        assert float(torch.linalg.norm(x - y) / torch.linalg.norm(y)) <= 1e-6
    assert differ <= 10, f"{differ} of 100 steps' scalars differ"


@pytest.mark.parametrize("kind,kw", [
    ("pgm", {}),
    ("pgm", {"weighted": True, "step_stride": 4}),
    ("adaprox", {"moment_dtype": torch.bfloat16}),
], ids=str)
def test_resume_chain_equals_the_straight_solve(kind, kw):
    """Fresh for 10 iterations with its carries, then ``resume=True`` for
    15: the straight 25 bit for bit; a zero-budget link in between leaves
    the chain as it was."""
    Y, W, A0, S0 = _problem(3)
    data = (Y,) + ((W,) if kw.get("weighted") else ())
    fresh = _port(kind, **kw)
    cont = _port(kind, resume=True, **kw)
    straight = fresh(A0, S0, *data, 25)
    outs = fresh(A0, S0, *data, 10)
    assert int(outs[2]) == 10
    noop = cont(outs[0], outs[1], *data, 0, *outs[2:])
    assert int(noop[2]) == 10 and np.isfinite(float(noop[5]))
    outs2 = cont(noop[0], noop[1], *data, 15, *noop[2:])
    assert int(outs2[2]) == 25
    _equal(outs2, straight)


@pytest.mark.parametrize("kind,kw", [
    ("pgm", {}),
    ("pgm", {"weighted": True, "step_stride": 4}),
    ("adaprox", {}),
], ids=str)
def test_jax_carries_continue_in_the_port(kind, kw):
    """A JAX fresh artifact's carries (``outs[2:]`` as NumPy) feed the
    port's ``resume=True`` program, which ends where JAX's straight run
    does, within the float32 tolerance."""
    Y, W, A0, S0 = _problem(4)
    data = (Y,) + ((W,) if kw.get("weighted") else ())
    jfresh = _jax(kind, return_carries=True, **kw)
    outs = [np.asarray(o) for o in jfresh(A0, S0, *data, 10)]
    straight = jfresh(A0, S0, *data, 25)
    got = _port(kind, resume=True, **kw)(outs[0], outs[1], *data, 15,
                                         *outs[2:])
    assert int(got[2]) == 25
    for g, w in zip(got[:2], straight[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_grow_stride_tensor_form_equals_the_host_form():
    """The same strides on the same drifts: grow, halve and keep, the
    first refresh, drifts across the budget's edge and at zero."""
    rng = np.random.default_rng(5)
    seen = set()
    for trial in range(600):
        stride = int(rng.integers(1, 101))
        old = tuple(torch.tensor(np.float32(rng.uniform(0.1, 2)))
                    for _ in range(2))
        scale = 10.0 ** rng.uniform(-9, 0)
        new = tuple(o * np.float32(1 + rng.choice([-1, 1]) * scale
                                   * rng.uniform(0, 1)) for o in old)
        if trial % 40 == 0:
            new = old
        first = bool(rng.random() < 0.1)
        host = grow_stride(stride, old, new, 0.05, 100, first=first)
        dev = grow_stride(torch.tensor(stride, dtype=torch.int32), old, new,
                          0.05, 100, first=torch.tensor(first))
        assert dev.dtype == torch.int32 and int(dev) == host
        seen.add((host > stride) - (host < stride))
    assert seen == {-1, 0, 1}


def test_bias_corrections_on_the_device_equal_the_host_ones():
    """The Adam scalars an exported loop computes from its counter equal
    the driver's host numbers bit for bit (powers in float64 rounded to
    float32 on both sides)."""
    from proxmin_tpu_torch.nmf import (_bias_corrections,
                                       _bias_corrections_tensor,
                                       _bias_decays)

    for b1, b2 in ((0.9, 0.999), (0.5, 0.99)):
        decays = _bias_decays(b1, b2, "cpu")
        for t in range(1, 3001):
            dev = _bias_corrections_tensor(decays,
                                           torch.tensor(t, dtype=torch.int32))
            assert dev.tolist() == [float(v) for v in
                                    _bias_corrections(b1, b2, t)]


def test_nmf_adaprox_export_refuses_nonseparable_prox():
    with pytest.raises(ValueError, match="separable"):
        tex.export_nmf_adaprox_solver(
            3, 2, 128, device="cpu",
            prox_S=functools.partial(ptt.operators.prox_soft, thresh=0.1,
                                     type="absolute"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tex.export_nmf_adaprox_solver(C, K, N, resume=True, warm_start=True,
                                      device="cpu")
    with pytest.raises(ValueError, match="weighted"):
        tex.export_nmf_solver(C, K, N, step_adapt=True, device="cpu")


@pytest.mark.parametrize("name", ["export_nmf_pgm_sharded",
                                  "export_nmf_adaprox_sharded"])
def test_sharded_exporters_name_item_13(name):
    """The sharded pair raised naming ROADMAP item 13 until it was ported
    (the test keeps its name); without the mesh of the solve it serves, an
    exporter now raises ValueError. tests/test_torch_export_sharded.py
    holds the programs."""
    with pytest.raises(ValueError, match="needs the mesh"):
        getattr(tex, name)(None, C, K, N)


def _ops_of(graph_module):
    """The namespaces of every op a program's graph and its loop bodies
    call."""
    out = set()
    for mod in graph_module.modules():
        if not isinstance(mod, torch.fx.GraphModule):
            continue
        for node in mod.graph.nodes:
            if node.op != "call_function":
                continue
            target = node.target
            if isinstance(target, torch._ops.HigherOrderOperator):
                out.add("higher_order")
            elif isinstance(target, (torch._ops.OpOverload,
                                     torch._ops.OpOverloadPacket)):
                out.add(target.namespace)
            else:
                out.add(f"{target.__module__}.{target.__name__}")
    return out


@pytest.mark.parametrize("kind,kw,op", [
    ("pgm", {}, "fused_nmf_pgm_step"),
    ("pgm", {"weighted": True, "step_stride": 4, "step_adapt": True},
     "fused_nmf_pgm_step"),
    ("adaprox", {"moment_dtype": torch.bfloat16}, "fused_nmf_adaprox_step"),
], ids=str)
def test_nmf_programs_call_only_registered_ops(kind, kw, op):
    ep = torch.export.load(io.BytesIO(_blob(kind, **kw)))
    spaces = _ops_of(ep.graph_module)
    assert spaces - {"aten", "prims", "higher_order", "proxmin_torch",
                     "_operator.getitem"} == set()
    assert {"proxmin_torch", "higher_order"} <= spaces
    assert any(getattr(n.target, "__name__", "").startswith(op)
               for m in ep.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule)
               for n in m.graph.nodes)


def test_save_load_and_argument_conversion(tmp_path):
    """``save_exported``/``load_exported`` round-trip the bytes; Python ints
    become int32 and NumPy arrays tensors on the program's device."""
    Y, _, A0, S0 = _problem(6)
    blob = tex.export_nmf_solver(C, K, N, e_rel=0.0, tile_n=TILE,
                                 device="cpu")
    path = tex.save_exported(tmp_path / "solver.pt2", blob)
    solve = tex.load_exported(path)
    got = solve(A0, S0, Y, 5)
    assert len(got) == 6
    again = _port("pgm")(_t(A0), _t(S0), _t(Y),
                         torch.tensor(5, dtype=torch.int32))
    _equal(got, again[:6])
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool
