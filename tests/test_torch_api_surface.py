"""What of the JAX package's public surface the port has, and what it
lacks, as a list in the repository and not a search.

For every module of ``ABSENT`` (``utils``, ``checkpoint``,
``solvers.*``, ``algorithms``, ``functional``, ``export``, ``parallel``,
``nmf``, ``operators``, ``linop``, ``special``, ``precision``, ``ops``,
``ops.*``, ``calibrate``) and the top-level package, every public name
(the module's ``__all__``, and the
functions and classes it defines without a leading underscore; for the
package, every attribute without one) either exists in the port's module of
the same name or stands in ``ABSENT`` below with its reason: it serves
``jit`` only, it lives in another module of the port, or a ROADMAP item
ports it. A name that is ported must leave the table, and a new JAX name
must enter it or the port."""

import importlib
import importlib.util
import inspect
import types

import pytest

import proxmin_tpu
import proxmin_tpu.parallel  # noqa: F401  (an attribute once imported)
import proxmin_tpu_torch
import proxmin_tpu_torch.parallel  # noqa: F401

JIT_ONLY = "serves jit and its driver cache; a host loop compiles nothing"
WHILE_CARRY = ("the carry of the JAX driver's lax.while_loop (its "
               "NamedTuple and the function that builds it); the port's "
               "drivers are host loops, and a solve's resume state is the "
               "plain dict of its result's .state")
POLICY = ("the port fixes one float32 policy at import "
          "(proxmin_tpu_torch.precision.apply_f32_policy: no TF32); the "
          "TF32 question is ROADMAP Queue 1 item 1's")

# module -> {name: why the port's module of that name does not have it}
ABSENT = {
    "utils": {
        "MatrixAdapter": "lives in proxmin_tpu_torch.linop (utils cannot "
                         "import linop: linop builds on solvers.common, "
                         "which imports utils)",
        "get_spectral_norm": "lives in proxmin_tpu_torch.linop, as above",
        "set_matmul_precision": POLICY,
        "matmul_precision_scope": POLICY,
        "with_matmul_precision": POLICY,
    },
    "checkpoint": {},
    "solvers.common": {
        "DriverCache": JIT_ONLY,
        "abstract_key": JIT_ONLY,
        "cacheable": JIT_ONLY,
        "callable_key": JIT_ONLY,
        "nested_key": JIT_ONLY,
        "value_key": JIT_ONLY,
        "asarray_cached": JIT_ONLY,
        "split_partial_data": JIT_ONLY,
        "split_stepper_data": JIT_ONLY,
        "zeros_like_shapes": JIT_ONLY,
        "promote_dtype_host": "keeps host inputs on the host for the "
                              "sharded path; the port's sharded path "
                              "slices host inputs before it copies "
                              "(parallel.sharding._local) and promotes "
                              "each rank's slice",
    },
    "algorithms": {},
    # every factory is ported; under torch.func.vmap two options raise
    # (the JAX package masks them inside lax.while_loop), listed in VMAP_GAPS
    "functional": {},
    # every exporter is a name of the port; what its programs cannot do yet
    # stands in EXPORT_GAPS
    "export": {},
    "": {
        "clear_caches": JIT_ONLY,
        "set_matmul_precision": POLICY,
    },
    "nmf": {},
    "operators": {},
    "linop": {},
    "special": {},
    "precision": {
        "set_matmul_precision": POLICY,
        "matmul_precision_scope": POLICY,
        "with_matmul_precision": POLICY,
    },
    "ops": {},
    "ops.nmf_kernels": {
        "pad_nmf_problem": "pads C and K to the TPU's 8-row tiles and N to "
                           "the tile for the Pallas kernels; the CUDA "
                           "kernels take any C <= 256, K <= 32 and N "
                           "unpadded (the compiled bounds mask the rest), "
                           "so the port has nothing to pad",
    },
    "ops.prox_kernels": {},
    "solvers.pgm": {
        "PGMState": WHILE_CARRY,
    },
    "solvers.adaprox": {
        "AdaProxState": WHILE_CARRY,
        "init_adaprox_state": WHILE_CARRY,
        "make_adaprox_cond": "the lax.while_loop condition, shared with "
                             "the JAX AOT exporter; the port's host loop "
                             "tests its stop flags in Python, and its "
                             "exporter builds its own torch while_loop "
                             "condition (proxmin_tpu_torch.export)",
    },
    "solvers.admm": {},
    "solvers.bsdmm": {
        "BSDMMState": WHILE_CARRY,
    },
    "calibrate": {},
    "parallel": {
        "hlo_collectives": "reads the collectives out of XLA's optimized "
                           "HLO text, which PyTorch does not make; the "
                           "port's tests count the torch.distributed "
                           "all_reduce calls and their elements instead "
                           "(tests/test_torch_parallel.py, "
                           "tests/test_torch_distributed.py)",
    },
}


def _public(module, package=False):
    names = set(getattr(module, "__all__", ()))
    for name, value in vars(module).items():
        if name.startswith("_"):
            continue
        if package:
            names.add(name)
        elif (not isinstance(value, types.ModuleType)
              and (inspect.isfunction(value) or inspect.isclass(value))
              and getattr(value, "__module__", None) == module.__name__):
            names.add(name)
    return sorted(names)


def _pair(name):
    suffix = "." + name if name else ""
    return (importlib.import_module("proxmin_tpu" + suffix),
            importlib.import_module("proxmin_tpu_torch" + suffix))


@pytest.mark.parametrize("name", sorted(ABSENT))
def test_every_public_name_is_ported_or_listed(name):
    mj, mt = _pair(name)
    public = _public(mj, package=not name)
    assert len(public) >= 2
    missing = sorted(n for n in public if not hasattr(mt, n))
    assert set(missing) <= set(ABSENT[name]), (
        f"proxmin_tpu{'.' + name if name else ''}: missing in the port and "
        f"not listed: {sorted(set(missing) - set(ABSENT[name]))}")
    for absent, reason in ABSENT[name].items():
        assert reason.strip()
        assert not hasattr(mt, absent), f"{absent} is ported: unlist it"
        assert hasattr(mj, absent) or importlib.util.find_spec(
            f"{mj.__name__}.{absent}"), f"{absent} is not a JAX name"


@pytest.mark.parametrize("name", [
    "NesterovAccelerator", "BarzilaiBorweinStepper", "ApproximateCache",
    "Traceback", "NullCallback", "profile_trace",
    "summarize_convergence_warnings", "hasNotNone", "check_convergence"])
def test_the_remaining_utils_are_there(name):
    """The utils of this slice, in ``__all__`` and with the JAX signature's
    parameter names."""
    got = getattr(proxmin_tpu_torch.utils, name)
    want = getattr(proxmin_tpu.utils, name)
    assert name in proxmin_tpu_torch.utils.__all__
    target = (lambda o: o.__init__) if inspect.isclass(want) else (
        lambda o: o)
    assert (list(inspect.signature(target(got)).parameters)
            == list(inspect.signature(target(want)).parameters))


def test_top_level_exports_match():
    """``checkpoint`` and ``special`` are exported as the JAX package
    exports them, and the five solvers and the prox operators with them."""
    for name in ("checkpoint", "special", "utils", "operators", "nmf",
                 "algorithms", "linop"):
        assert isinstance(getattr(proxmin_tpu_torch, name), types.ModuleType)
    for name in ("pgm", "adaprox", "admm", "sdmm", "bsdmm", "prox_plus"):
        assert callable(getattr(proxmin_tpu_torch, name))
    for fn in ("save_checkpoint", "load_checkpoint"):
        params = list(inspect.signature(
            getattr(proxmin_tpu_torch.checkpoint, fn)).parameters)
        assert params[0] == "path"


@pytest.mark.parametrize("solver,options", [
    ("pgm", ("backtracking", "f", "callback", "trace", "state")),
    ("adaprox", ("callback", "trace", "f", "state")),
    ("admm", ("callback", "trace", "state")),
    ("sdmm", ("callback", "trace", "state")),
    ("bsdmm", ("callback", "trace", "state")),
])
def test_solver_signatures_cover_the_jax_ones(solver, options):
    """Every parameter of the JAX solver is a parameter of the port's (which
    adds ``device``), in the same order."""
    got = list(inspect.signature(
        getattr(proxmin_tpu_torch, solver)).parameters)
    want = [p for p in inspect.signature(
        getattr(proxmin_tpu, solver)).parameters if not p.startswith("_")]
    assert [p for p in got if p != "device"] == want
    assert set(options) <= set(got)


# what the port's functional factories cannot do under torch.func.vmap that
# the JAX ones do under jax.vmap: {factory: {option: reason}}
VMAP_GAPS = {
    "make_pgm_solver": {
        "backtracking=True": "the halvings of each iteration depend on each "
                             "lane's data; a lane's host loop cannot read "
                             "them under vmap (ValueError)"},
    "make_adaprox_solver": {
        "separable_prox=False with a prox": "the prox sub-iterations' count "
                                            "depends on each lane's data "
                                            "(ValueError)"},
}


@pytest.mark.parametrize("name", sorted(proxmin_tpu.functional.__all__))
def test_functional_factories_take_the_jax_parameters(name):
    """Each factory has the JAX factory's parameters in order, and
    ``device`` (where NumPy inputs go) last."""
    import proxmin_tpu_torch.functional as tfn

    got = list(inspect.signature(getattr(tfn, name)).parameters)
    want = list(inspect.signature(
        getattr(proxmin_tpu.functional, name)).parameters)
    assert got == want + ["device"]
    assert name in tfn.__all__
    for option, reason in VMAP_GAPS.get(name, {}).items():
        assert option.split("=")[0] in got and reason.strip()


def test_functional_imports_no_jax():
    """The port's functional module imports torch and the port only."""
    import ast
    import pathlib

    import proxmin_tpu_torch.functional as tfn

    tree = ast.parse(pathlib.Path(tfn.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "proxmin_tpu")]


# what the port's exporters cannot capture that the JAX ones do: {exporter:
# {option: reason}}; each raises ValueError and stands as owed in
# ROADMAP.md
EXPORT_GAPS = {
    "export_nmf_solver": {
        "untraceable prox_S": "a prox_S outside the compiled chains runs "
                              "between K1's two split passes and is traced "
                              "there; one that torch.export cannot trace "
                              "raises ValueError naming it"},
    "export_nmf_adaprox_solver": {
        "untraceable prox_S": "as export_nmf_solver's, between K2's two "
                              "split passes"},
    "export_bsdmm_solver": {
        "steps_f_stride": "the sweep keeps the stride's clock on the host",
        "steps_g_update=relative": "the sweep branches on the host clock",
        "stateful steps_f_cb": "the stepper keeps its clock on the host"},
}


@pytest.mark.parametrize("name", sorted(proxmin_tpu.export.__all__))
def test_exporters_take_the_jax_parameters(name):
    """Each of the twelve names has the JAX function's parameters in order,
    and every exporter ``device`` (where its program runs) last."""
    import proxmin_tpu_torch.export as tex

    assert name in tex.__all__
    got = list(inspect.signature(getattr(tex, name)).parameters)
    want = list(inspect.signature(getattr(proxmin_tpu.export,
                                          name)).parameters)
    if name.startswith("export_"):
        assert got == want + ["device"]
    else:
        assert got == want
    for option, reason in EXPORT_GAPS.get(name, {}).items():
        assert reason.strip()
        assert option == "*" or option.split("=")[0].split()[-1] in (
            got + ["steps_f_cb"])


def test_export_gaps_raise():
    import torch

    import proxmin_tpu_torch.export as tex

    def prox_f(x, step, Xs=None, j=None):
        return x

    def steps(Xs, j=None):
        return 0.5

    for kw in ({"steps_f_stride": 3}, {"steps_g_update": "relative"}):
        with pytest.raises(ValueError, match="not exported yet"):
            tex.export_bsdmm_solver([(2,)], prox_f, steps, device="cpu",
                                    dtype=torch.float64, **kw)
