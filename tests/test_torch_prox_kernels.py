"""K4's plain versions against the JAX prox kernels.

The JAX kernels run as tests/test_pallas_ops.py runs them on the CPU,
through the Pallas interpreter. The same seeded numpy inputs go to both.
Tolerances:
- float32: plus and hard exactly equal (one comparison per element), soft
  atol 1e-7 (test_pallas_ops.py's bound), unity rtol 1e-6 (the column or
  row sums are taken in another order);
- float64: plus, soft and hard exactly equal, unity rtol 1e-14;
- bfloat16 (computed in float32 and cast back on both sides): plus, soft
  and hard exactly equal, unity within one bfloat16 ulp (rtol 2^-7).

The CUDA kernel itself is held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import proxmin_tpu.ops as jops
import proxmin_tpu_torch.ops as tops
from proxmin_tpu_torch import operators as top
from proxmin_tpu_torch.ops import prox_kernels as pk


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SHAPES = [(1, 7), (5, 129), (13, 1000), (8, 128)]
OPS = [
    ("plus", {}),
    ("soft", {"thresh": 0.3}),
    ("soft", {"thresh": 0.3, "type": "absolute"}),
    ("hard", {"thresh": 0.3}),
    ("hard", {"thresh": 0.3, "type": "absolute"}),
]
OP_IDS = [f"{op}-{kw.get('type', 'relative')}" for op, kw in OPS]


def _jax(op):
    return getattr(jops, f"prox_{op}_pallas")


def _port(op):
    return getattr(tops, f"prox_{op}_pallas")


@pytest.mark.parametrize("op,kw", OPS, ids=OP_IDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_elementwise_matches_jax(rng, op, kw, dtype, shape):
    X = rng.normal(size=shape).astype(dtype)
    want = np.asarray(_jax(op)(jnp.asarray(X), 0.5, **kw))
    got = _port(op)(torch.from_numpy(X), 0.5, **kw)
    assert got.dtype == torch.from_numpy(X).dtype
    assert got.shape == shape
    if op == "soft" and dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_unity_matches_jax(rng, axis, dtype, shape):
    X = (0.1 + rng.random(shape)).astype(dtype)
    want = np.asarray(jops.prox_unity_pallas(jnp.asarray(X), 0.5, axis=axis))
    got = tops.prox_unity_pallas(torch.from_numpy(X), 0.5, axis=axis)
    assert got.dtype == torch.from_numpy(X).dtype
    rtol = 1e-6 if dtype == np.float32 else 1e-14
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    np.testing.assert_allclose(got.numpy().sum(axis=axis), 1.0,
                               rtol=10 * rtol)


@pytest.mark.parametrize("op", ["soft", "hard"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tensor_step(rng, op, dtype):
    """A 0-d tensor step (what the solvers pass) with a relative threshold
    gives the JAX kernel's values for the same step."""
    X = rng.normal(size=(7, 300)).astype(dtype)
    want = np.asarray(_jax(op)(jnp.asarray(X), jnp.asarray(0.4, dtype),
                               thresh=0.5))
    step = torch.tensor(0.4, dtype=torch.from_numpy(X).dtype)
    got = _port(op)(torch.from_numpy(X), step, thresh=0.5)
    if op == "soft" and dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op,kw", OPS, ids=OP_IDS)
def test_nan_propagates_as_in_jax(op, kw):
    X = np.array([[np.nan, -1.0, 0.2, 2.0], [0.0, np.nan, -0.1, -3.0]])
    want = np.asarray(_jax(op)(jnp.asarray(X), 0.5, **kw))
    got = _port(op)(torch.from_numpy(X), 0.5, **kw).numpy()
    assert np.isnan(got[0, 0]) and np.isnan(got[1, 1])
    np.testing.assert_array_equal(got, want)


def test_nan_threshold_gives_nan_like_jax():
    X = np.array([[-1.0, 0.2, 2.0]])
    for op in ("soft", "hard"):
        want = np.asarray(_jax(op)(jnp.asarray(X), 1.0, thresh=np.nan))
        got = _port(op)(torch.from_numpy(X), 1.0, thresh=float("nan"))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op,kw", OPS + [("unity", {"axis": 0}),
                                         ("unity", {"axis": 1})])
def test_bfloat16_computes_in_float32_and_casts_back(rng, op, kw):
    X32 = (0.1 + rng.random((5, 129)) if op == "unity"
           else rng.normal(size=(5, 129))).astype(np.float32)
    Xj = jnp.asarray(X32).astype(jnp.bfloat16)
    Xt = torch.from_numpy(X32).to(torch.bfloat16)
    np.testing.assert_array_equal(Xt.float().numpy(),
                                  np.asarray(Xj.astype(jnp.float32)))
    want = np.asarray(_jax(op)(Xj, 0.5, **kw).astype(jnp.float32))
    got = _port(op)(Xt, 0.5, **kw)
    assert got.dtype == torch.bfloat16
    if op == "unity":
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("op", ["plus", "soft", "hard", "unity"])
@pytest.mark.parametrize("shape", [(7,), (2, 3, 4)])
def test_non_2d_input_raises_as_in_jax(op, shape):
    X = np.ones(shape, np.float32)
    with pytest.raises(ValueError):
        _jax(op)(jnp.asarray(X), 0.5)
    with pytest.raises(ValueError, match="2-D"):
        _port(op)(torch.from_numpy(X), 0.5)


@pytest.mark.parametrize("op,kw", OPS + [("unity", {"axis": 1})])
def test_cpu_tensors_take_the_plain_version(rng, op, kw):
    """On CPU tensors the wrapper is its plain version bit for bit, counts
    no launch and returns a new tensor."""
    X = torch.from_numpy(rng.random((6, 70)))
    wrapper = _port(op)
    reference = getattr(pk, f"prox_{op}_reference")
    before = wrapper.launches
    got = wrapper(X, 0.5, **kw)
    assert wrapper.launches == before
    assert torch.equal(got, reference(X, 0.5, **kw))
    assert got.data_ptr() != X.data_ptr()


def test_plain_versions_are_the_operators(rng):
    """In float32 and float64 the plain versions are the operators of
    proxmin_tpu_torch.operators, so a prox list can mix the two."""
    X = torch.from_numpy(rng.normal(size=(4, 50)))
    for dt in (torch.float32, torch.float64):
        Xd = X.to(dt)
        assert torch.equal(pk.prox_plus_reference(Xd, 1.0),
                           top.prox_plus(Xd, 1.0))
        assert torch.equal(pk.prox_soft_reference(Xd, 0.5, thresh=0.4),
                           top.prox_soft(Xd, 0.5, thresh=0.4))
        assert torch.equal(pk.prox_hard_reference(Xd, 0.5, thresh=0.4),
                           top.prox_hard(Xd, 0.5, thresh=0.4))
        Xp = Xd.abs() + 0.1
        assert torch.equal(pk.prox_unity_reference(Xp, 0.5, axis=1),
                           top.prox_unity(Xp, 0.5, axis=1))


def test_unity_takes_axis_0_or_1_only(rng):
    X = torch.from_numpy(0.1 + rng.random((3, 5)))
    for axis in (2, -1, None):
        with pytest.raises(ValueError, match="axis 0 or 1"):
            tops.prox_unity_pallas(X, 0.5, axis=axis)


def test_wrappers_refuse_other_devices():
    X = torch.empty((5, 7), device="meta")
    for op in ("plus", "soft", "hard", "unity"):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            _port(op)(X, 0.5)


def _kernel_threshold(step, thresh, type, dtype):
    args = pk.threshold_args(step, thresh, type, torch.device("cpu"))
    return pk.threshold_reference(args, dtype)


def test_threshold_reaches_the_kernel_as_one_element():
    f32 = torch.float32
    for t in (0.25, np.float64(0.25), torch.tensor(0.25, dtype=torch.float64),
              torch.tensor([0.25])):
        got = _kernel_threshold(1.0, t, "absolute", f32)
        assert got.shape == (1,) and got.dtype == f32 and float(got) == 0.25
    with pytest.raises(ValueError, match="scalar"):
        _kernel_threshold(1.0, torch.ones(2), "absolute", f32)
    with pytest.raises(ValueError, match="scalar"):
        _kernel_threshold(1.0, np.ones(3), "absolute", f32)
    with pytest.raises(ValueError, match="relative"):
        tops.prox_soft_pallas(torch.ones((2, 2)), 0.5, thresh=0.1,
                              type="Relative")


_STEPS = {
    "float": 0.37, "np.float64": np.float64(0.37), "int": 3,
    "f32 tensor": torch.tensor(0.37), "f32 (1,) tensor": torch.tensor([0.37]),
    "f64 tensor": torch.tensor(0.37, dtype=torch.float64),
    "bf16 tensor": torch.tensor(0.37, dtype=torch.bfloat16),
    "f16 tensor": torch.tensor(0.37, dtype=torch.float16),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("step", list(_STEPS), ids=list(_STEPS))
@pytest.mark.parametrize("thresh", [0.3, 7, 1e-3])
def test_threshold_helper_matches_get_thresh(dtype, step, thresh):
    """The threshold the kernel forms from threshold_args, bit for bit the
    plain version's get_thresh converted to the compute dtype: a relative
    threshold from a host or tensor step, and an absolute one from a host
    number or a tensor."""
    s = _STEPS[step]
    X = torch.zeros((2, 3), dtype=dtype)
    cases = [(s, thresh, "relative"), (1.0, thresh, "absolute")]
    if isinstance(s, torch.Tensor):
        cases.append((1.0, s, "absolute"))
    for st, th, ty in cases:
        want = top._like(X, top.get_thresh(st, th, ty))
        got = _kernel_threshold(st, th, ty, dtype)
        assert got.dtype == dtype and got.shape == (1,)
        assert torch.equal(got.reshape(()), want.reshape(())), (st, th, ty)
    args = pk.threshold_args(s, thresh, "relative", torch.device("cpu"))
    # a tensor step is the kernel's to scale: no tensor op forms it first
    assert (args.tensor is not None) == isinstance(s, torch.Tensor)
    assert args.scaled == isinstance(s, torch.Tensor)
