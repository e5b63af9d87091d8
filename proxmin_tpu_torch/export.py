"""Whole solves saved as ``torch.export`` programs, for serving.

Counterpart of :mod:`proxmin_tpu.export`, with its names and parameters
(plus ``device=`` last). A deployed service should not pay tracing at
request time: each exporter captures one solve, its loop included, for
fixed shapes as one program (``torch.export.export`` of a
``while_loop``), and returns the bytes of ``torch.export.save``.
:func:`load_solver` restores it in another process and returns a callable.

* :func:`export_nmf_solver` and :func:`export_nmf_adaprox_solver` capture
  the fused NMF loops of :mod:`proxmin_tpu_torch.nmf` (the bodies the eager
  drivers run), with K1 or K2 as registered ops of the ``proxmin_torch``
  namespace; ``max_iter`` is a runtime input, and ``resume=True`` /
  ``return_carries=True`` chain artifacts across processes exactly.
* :func:`export_pgm_solver`, :func:`export_adaprox_solver`,
  :func:`export_admm_solver`, :func:`export_sdmm_solver` and
  :func:`export_bsdmm_solver` capture the generic solvers' bodies for user
  problems (fixed block shapes, traceable ``grad``/``step``/``prox``
  callables). Tensors that the callables close over (the data inside a
  gradient, a linear operator's matrix) are baked into the program as
  constants: pass per-request data as solver blocks, or export per dataset.

An artifact is specialised to its shapes, dtypes and device, as JAX's are:
export one per shape bucket. It is not compiled ahead of time (AOTInductor
cannot carry ops registered from Python): a process that serves it runs its
operations eagerly, one launch each. A program that calls the kernels needs
their ops registered in the serving process: ``import
proxmin_tpu_torch.ops`` before :func:`load_solver` (a kernel-free program
needs nothing of this package). A user callable that branches on a
tensor's value (``bool()`` of a tensor) cannot be captured, nor one that
closes over a tensor and a view of it (``M`` and ``M.T``: torch's
``while_loop`` refuses aliased inputs; write ``torch.t(M)``): the exporter
raises ``ValueError`` naming the callables. ``.item()``, ``float()`` of a
tensor and NumPy on a tensor are captured (torch 2.13), each as a host read
inside the loop.
"""

import functools
import io
import json

import numpy as np
import torch

from . import operators
from .nmf import (_adaprox_separable_ok, _fused_adaprox_program,
                  _fused_pgm_program, _fused_weighted_program,
                  _store_dtype, _weighted_lipschitz_S_v0, step_adaprox)
from .ops.nmf_kernels import DEFAULT_TILE_N, describe_prox
from .solvers.common import as_torch_dtype, default_device

__all__ = [
    "export_nmf_solver", "export_nmf_adaprox_solver",
    "export_nmf_pgm_sharded", "export_nmf_adaprox_sharded",
    "export_pgm_solver", "export_adaprox_solver",
    "export_admm_solver", "export_sdmm_solver", "export_bsdmm_solver",
    "load_solver", "save_exported", "load_exported",
]


class _Program(torch.nn.Module):
    """A solve function as the module ``torch.export`` captures."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _name(fn):
    fn = getattr(fn, "func", fn)  # a functools.partial names its function
    return getattr(fn, "__qualname__", None) or repr(fn)


def _capture(fn, args, what, extra=None, **callables):
    """The bytes of ``torch.export.save`` of ``fn`` traced on ``args``. A
    capture that fails raises ``ValueError`` naming ``what`` and the user
    ``callables`` it runs. ``extra``: a JSON-able dict saved beside the
    program (a per-rank program's layout, :func:`load_solver` reads it)."""
    try:
        ep = torch.export.export(_Program(fn), tuple(args), strict=False)
    except (torch._dynamo.exc.TorchDynamoException,
            torch.fx.experimental.symbolic_shapes.GuardOnDataDependentSymNode
            ) as e:
        named = ", ".join(f"{k}={_name(v)}" for k, v in callables.items()
                          if v is not None)
        raise ValueError(
            f"{what} cannot be captured by torch.export: a callable it runs "
            f"({named or 'none given'}) branches on a tensor's value "
            "(bool() of a tensor) or is not traceable "
            f"({type(e).__name__}: "
            f"{str(e).splitlines()[0] if str(e) else ''})") from e
    # the example inputs would be saved with the program: zeros of every
    # input's size, tens of MB at a real problem's size
    ep.example_inputs = None
    buf = io.BytesIO()
    files = None if extra is None else {_LAYOUT: json.dumps(extra)}
    torch.export.save(ep, buf, extra_files=files)
    return buf.getvalue()


def _spec(shape, dtype, device):
    """An example input of the artifact's signature (its values are never
    read: the capture traces shapes, dtypes and devices only)."""
    return torch.zeros(tuple(int(d) for d in shape), dtype=dtype,
                       device=device)


def _scalar(value, dtype, device):
    return torch.full((), value, dtype=dtype, device=device)


def _resume_flags(it0, loss0):
    """A carried non-finite loss after at least one iteration: the solve
    diverged and stays stopped."""
    return torch.logical_and(it0 > 0, torch.logical_not(torch.isfinite(loss0)))


def export_nmf_solver(C, K, N, prox_A=operators.prox_plus,
                      prox_S=operators.prox_plus, e_rel=1e-3,
                      tile_n=DEFAULT_TILE_N, dtype=torch.float32,
                      store_dtype=None, weighted=False, step_stride=None,
                      step_adapt=False, resume=False, return_carries=None,
                      device=None):
    """Capture the fused PGM-NMF solve (K1) for a fixed (C, K, N).

    The program takes ``(A (C, K), S (K, N), Y (C, N), max_iter)`` in
    ``dtype``, or with ``weighted=True`` ``(A, S, Y, W (C, N), max_iter)``
    on the weighted loop (strided Lipschitz refreshes with
    ``step_stride``, the interval grown on the device with
    ``step_adapt``); ``max_iter`` is a 0-d int32 tensor. It returns
    ``(A, S, it, conv_A, conv_S, loss)``. As in JAX, the unweighted program
    is the exact engine (``step_stride`` applies to the weighted one).
    ``store_dtype=torch.bfloat16`` stores S, Y (and W) in bfloat16 inside.
    ``prox_S`` (None: identity) is any prox K1 takes: a library operator on
    a pixel column runs compiled in K1, its codes saved in the program;
    any other prox is traced between K1's two split passes, and one that
    cannot be traced raises ``ValueError``. ``prox_A`` is any traceable
    prox. ``tile_n`` fixes K1's
    summation order: the program equals
    :func:`~proxmin_tpu_torch.nmf.nmf_pgm_fused` with the same ``tile_n``
    bit for bit.

    ``resume=True`` takes, after ``max_iter``, the carries that a
    ``return_carries=True`` program returns from position 2 on: ``it0``
    (int32), ``conv_A``, ``conv_S`` (bool), ``loss`` (float32), then
    unweighted K1's ``SSt`` (K, K) float32, weighted ``step_A``,
    ``step_S`` (float32), ``v`` (N, K) float32, ``stride`` and
    ``next_refresh`` (int32); ``return_carries`` (default: ``resume``)
    appends those carries to the outputs. A chain ``fresh(...,
    return_carries=True)`` -> ``cont(..., max_iter2, *outs[2:])`` equals
    the uninterrupted solve bit for bit, and a stopped solve stays
    stopped. ``device``: where the program runs (default: the card).
    """
    if step_adapt and not weighted:
        raise ValueError(
            "step_adapt applies to the weighted Lipschitz refresh only")
    if prox_A is None:
        prox_A = operators.prox_id
    if prox_S is None:
        prox_S = operators.prox_id
    prox_S = describe_prox(prox_S)
    resume, weighted = bool(resume), bool(weighted)
    if return_carries is None:
        return_carries = resume
    dtype = as_torch_dtype(dtype)
    store = _store_dtype(store_dtype) or torch.float32
    dev = default_device(device)
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    stride = max(int(step_stride or 1), 1)
    e_rel, tile_n = float(e_rel), int(tile_n)

    def run(A, S, Y, *rest):
        if weighted:
            W, max_iter, *rargs = rest
        else:
            max_iter, *rargs = rest
        A = A.to(f32).contiguous()
        S = S.to(store).contiguous()
        Y = Y.to(store).contiguous()
        if resume:
            it0, conv_A0, conv_S0, loss0, *steps = rargs
            div0 = _resume_flags(it0, loss0)
        else:
            it0 = _scalar(0, i32, dev)
            conv_A0 = conv_S0 = div0 = _scalar(False, b8, dev)
            loss0 = _scalar(float("inf"), f32, dev)
        if weighted:
            if not resume:
                zero = _scalar(0.0, f32, dev)
                steps = (zero, zero, _weighted_lipschitz_S_v0(N, K, f32, dev),
                         _scalar(stride, i32, dev), it0)
            A, S, it, conv_A, conv_S, loss, *carries = (
                _fused_weighted_program(
                    A, S, Y, W.to(store).contiguous(), max_iter, it0,
                    conv_A0, conv_S0, div0, loss0, tuple(steps), prox_A,
                    prox_S, e_rel, tile_n, stride=stride,
                    adapt=bool(step_adapt), resume=resume))
        else:
            if resume:
                (SSt0,) = steps
            else:
                S32 = S.to(f32)
                SSt0 = S32 @ S32.T
            A, S, SSt, it, conv_A, conv_S, loss = _fused_pgm_program(
                A, S, Y, max_iter, conv_A0, conv_S0, div0, loss0, SSt0,
                prox_A, prox_S, e_rel, tile_n)
            it = it + it0
            carries = (SSt,)
        head = (A.to(dtype), S.to(dtype), it, conv_A, conv_S, loss)
        return head + (tuple(carries) if return_carries else ())

    args = [_spec((C, K), dtype, dev), _spec((K, N), dtype, dev),
            _spec((C, N), dtype, dev)]
    if weighted:
        args.append(_spec((C, N), dtype, dev))
    args.append(_scalar(1, i32, dev))
    if resume:
        args += [_scalar(0, i32, dev), _scalar(False, b8, dev),
                 _scalar(False, b8, dev), _scalar(float("inf"), f32, dev)]
        if weighted:
            args += [_scalar(0.0, f32, dev), _scalar(0.0, f32, dev),
                     _spec((N, K), f32, dev), _scalar(stride, i32, dev),
                     _scalar(0, i32, dev)]
        else:
            args.append(_spec((K, K), f32, dev))
    return _capture(run, args, "export_nmf_solver", prox_A=prox_A,
                    prox_S=prox_S.prox if prox_S.split else None)


def export_nmf_adaprox_solver(C, K, N, prox_A=operators.prox_plus,
                              prox_S=operators.prox_plus, e_rel=1e-3,
                              tile_n=DEFAULT_TILE_N, dtype=torch.float32,
                              b1=0.9, b2=0.999, eps=1e-8, moment_dtype=None,
                              store_dtype=None, warm_start=False,
                              weighted=False, resume=False,
                              return_carries=None, device=None):
    """Capture the fused proximal-Adam NMF solve (K2, ``scheme='adam'``,
    separable proxs) for a fixed (C, K, N).

    The program takes ``(A, S, Y, max_iter)`` (``weighted=True`` inserts
    ``W (C, N)`` after Y) and returns ``(A, S, it, conv_A, conv_S, loss,
    M_A, V_A, M_S, V_S)``; the bias corrections are computed on the device
    from the iteration counter and K2 reads them there, so a loop iteration
    reads nothing back but its stop test. ``warm_start=True`` appends
    ``M_A, V_A, M_S, V_S`` inputs (a previous program's moments; the
    bias-correction clock restarts). ``moment_dtype`` and ``store_dtype``
    (``torch.bfloat16``) store the S moments, and S, Y, W, reduced inside.
    The program equals :func:`~proxmin_tpu_torch.nmf.nmf_adaprox_fused`
    with the same ``tile_n`` bit for bit.

    ``resume=True`` takes, after ``max_iter``, ``it0, conv_A, conv_S,
    loss, M_A, V_A, M_S, V_S, rowsum (K,)``: exactly a
    ``return_carries=True`` program's outputs from position 2 on (K2's
    row sums appended), the global clock continued, a stopped solve
    staying stopped. ``resume`` and ``warm_start`` exclude each other.
    Proxes that are not separable raise ``ValueError``: use
    :func:`export_adaprox_solver` for the sub-iteration prox.
    """
    if not _adaprox_separable_ok(prox_A, prox_S, "auto"):
        raise ValueError(
            "export_nmf_adaprox_solver needs separable proxs (the "
            "in-kernel scaled prox is applied per pixel tile); use "
            "export_adaprox_solver for sub-iteration prox semantics")
    if prox_A is None:
        prox_A = operators.prox_id
    if prox_S is None:
        prox_S = operators.prox_id
    prox_S = describe_prox(prox_S, "adaprox")
    resume, weighted = bool(resume), bool(weighted)
    if resume and warm_start:
        raise ValueError(
            "resume= (exact continuation) and warm_start= (reference "
            "M=/V= clock-restart semantics) are mutually exclusive")
    if return_carries is None:
        return_carries = resume
    dtype = as_torch_dtype(dtype)
    store = _store_dtype(store_dtype) or torch.float32
    mdt = as_torch_dtype(moment_dtype)
    if mdt is None or mdt.itemsize >= 4:
        mdt = torch.float32
    dev = default_device(device)
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    hyper = (float(e_rel), float(b1), float(b2), float(eps), int(tile_n))

    def run(A, S, Y, *rest):
        if weighted:
            W, max_iter, *rargs = rest
            W = W.to(store).contiguous()
        else:
            max_iter, *rargs = rest
            W = None
        A = A.to(f32).contiguous()
        S = S.to(store).contiguous()
        Y = Y.to(store).contiguous()
        it0 = _scalar(0, i32, dev)
        conv_A0 = conv_S0 = div0 = _scalar(False, b8, dev)
        loss0 = _scalar(float("inf"), f32, dev)
        if resume:
            it0, conv_A0, conv_S0, loss0, MA, VA, MS, VS, rowsum0 = rargs
            div0 = _resume_flags(it0, loss0)
            rowsum0 = rowsum0.reshape(K, 1)
        else:
            rowsum0 = torch.sum(S.to(f32), dim=1, keepdim=True)
            if warm_start:
                MA, VA, MS, VS = rargs
            else:
                MA = VA = torch.zeros((C, K), dtype=f32, device=dev)
                MS = VS = torch.zeros((K, N), dtype=mdt, device=dev)
        MA, VA = MA.to(f32), VA.to(f32)
        MS, VS = (m.to(mdt).contiguous() for m in (MS, VS))
        (A, S, it, conv_A, conv_S, loss, MA, VA, MS, VS,
         rowsum) = _fused_adaprox_program(
            A, S, Y, W, MA, VA, MS, VS, rowsum0, max_iter, it0, conv_A0,
            conv_S0, div0, loss0, prox_A, prox_S, *hyper)
        head = (A.to(dtype), S.to(dtype), it + it0, conv_A, conv_S, loss,
                MA, VA, MS, VS)
        return head + ((rowsum[:, 0],) if return_carries else ())

    args = [_spec((C, K), dtype, dev), _spec((K, N), dtype, dev),
            _spec((C, N), dtype, dev)]
    if weighted:
        args.append(_spec((C, N), dtype, dev))
    args.append(_scalar(1, i32, dev))
    if resume:
        args += [_scalar(0, i32, dev), _scalar(False, b8, dev),
                 _scalar(False, b8, dev), _scalar(float("inf"), f32, dev)]
    if resume or warm_start:
        args += [_spec((C, K), f32, dev), _spec((C, K), f32, dev),
                 _spec((K, N), mdt, dev), _spec((K, N), mdt, dev)]
    if resume:
        args.append(_spec((K,), f32, dev))
    return _capture(run, args, "export_nmf_adaprox_solver", prox_A=prox_A,
                    prox_S=prox_S.prox if prox_S.split else None)


# the name of the JSON layout saved beside a per-rank program
_LAYOUT = "proxmin_sharded_layout.json"


def _sharded_setup(mesh, C, K, N, data_axis, model_axis, platforms, device,
                   what):
    """``(lay, (C_l, N_l), device)`` of a per-rank program on ``mesh``: the
    layout with its groups, the local extents and the device the program
    runs on (the mesh's)."""
    from .parallel.sharding import _axis_size, _Layout, _local_device

    if mesh is None:
        raise ValueError(f"{what} needs the mesh of the solve it serves")
    lay = _Layout.of(mesh, data_axis, model_axis)
    n_data = _axis_size(mesh, data_axis)
    n_model = _axis_size(mesh, model_axis) if model_axis else 1
    if N % n_data or C % n_model:
        raise ValueError(f"{what}: N={N} must divide by the data axis "
                         f"({n_data} ranks) and C={C} by the model axis "
                         f"({n_model})")
    dev = torch.device(device) if device is not None else _local_device(mesh)
    if platforms is not None and tuple(platforms) != (dev.type,):
        raise ValueError(
            f"{what}: a program runs on the device it was captured for "
            f"({dev.type}); platforms={tuple(platforms)} would need one "
            "capture per device: export on each")
    return lay, (C // n_model, N // n_data), dev


def _layout_meta(kind, mesh, lay, inputs, outputs):
    """The JSON layout of a per-rank program: the mesh it was captured on,
    every input's and output's sharding spec (None for a replicated
    scalar), and the name of each axis's process group (the names the
    program's collectives captured)."""
    def name(axis):
        g = lay.data if axis == "data" else lay.model
        return None if g is None else g.group_name

    return {"kind": kind, "world": int(mesh.mesh.numel()),
            "mesh_shape": list(mesh.mesh.shape),
            "axis_names": list(mesh.mesh_dim_names),
            "data_axis": lay.data_axis, "model_axis": lay.model_axis,
            "groups": {a: name(a) for a in ("data", "model")},
            "inputs": inputs, "outputs": outputs}


def export_nmf_pgm_sharded(mesh, C, K, N, prox_A=operators.prox_plus,
                           prox_S=operators.prox_plus, e_rel=1e-3,
                           weighted=False, step_stride=None,
                           step_adapt=False, data_axis="data",
                           model_axis=None, dtype=torch.float32,
                           resume=False, platforms=None, device=None):
    """Capture the explicit-collective sharded PGM-NMF solve
    (:func:`proxmin_tpu_torch.parallel.nmf_pgm_sharded`) as one program per
    rank.

    Every rank calls this on the ``mesh`` the solve runs on and gets its
    own program: the whole solve over its local shards, the ``while_loop``
    included, with the live solve's packing and order of sums and its
    all-reduces as torch's functional collectives (the in-place
    ``dist.all_reduce`` cannot be traced). Signature ``(A, S, Y[, W],
    max_iter) -> (A', S', it, conv_A, conv_S, loss)`` with ``max_iter`` a
    0-d int32; the arrays are laid out as
    :func:`~proxmin_tpu_torch.parallel.shard_nmf_problem` lays them out (A
    over ``model_axis``, S over ``data_axis``, Y and W over both).
    ``step_stride``/``step_adapt`` bake the strided refresh (the sharded
    power iterate warm-started) and append ``(step_A, step_S, stride,
    seg_end)`` to the outputs, weighted ones also the pixel-sharded power
    iterate ``v``. ``resume=True`` appends ``(it0, conv_A, conv_S, loss)``
    (and the strided carries) to the inputs after ``max_iter``: outputs
    from position 2 on feed a continuation, which walks the uninterrupted
    trajectory bit for bit, as ``nmf_pgm_sharded(state=)`` does.
    ``platforms`` may name only this device's type: a program runs on the
    device it was captured for. :func:`load_solver` serves the program on a
    process group of the same size.
    """
    from .parallel.sharding import (_pgm_program, _weighted_steps_v0,
                                    functional_collectives)

    what = "export_nmf_pgm_sharded"
    lay, (C_l, N_l), dev = _sharded_setup(mesh, C, K, N, data_axis,
                                          model_axis, platforms, device,
                                          what)
    prox_A = operators.prox_id if prox_A is None else prox_A
    prox_S = operators.prox_id if prox_S is None else prox_S
    weighted, resume = bool(weighted), bool(resume)
    strided = (step_stride is not None and step_stride > 1) or step_adapt
    dtype = as_torch_dtype(dtype)
    i32, b8 = torch.int32, torch.bool
    e_rel = float(e_rel)

    def run(A, S, Y, *rest):
        if weighted:
            W, max_iter, *carry = rest
        else:
            (max_iter, *carry), W = rest, Y
        return _pgm_program(A, S, Y, W, lay, weighted, prox_A, prox_S,
                            e_rel, max_iter, step_stride, step_adapt,
                            tuple(carry) if resume else None)

    a_spec, s_spec = [model_axis, None], [None, data_axis]
    y_spec, v_spec = [model_axis, data_axis], [data_axis, None]
    args = [_spec((C_l, K), dtype, dev), _spec((K, N_l), dtype, dev),
            _spec((C_l, N_l), dtype, dev)]
    ins = [a_spec, s_spec, y_spec]
    if weighted:
        args.append(_spec((C_l, N_l), dtype, dev))
        ins.append(y_spec)
    args.append(_scalar(1, i32, dev))
    ins.append(None)
    carries = [_scalar(0, i32, dev), _scalar(False, b8, dev),
               _scalar(False, b8, dev), _scalar(float("inf"), dtype, dev)]
    c_specs = [None] * 4
    if strided:
        carries += [_scalar(0, dtype, dev), _scalar(0, dtype, dev),
                    _scalar(1, i32, dev), _scalar(0, i32, dev)]
        c_specs += [None] * 4
        if weighted:
            carries.append(_weighted_steps_v0(args[0], args[1]))
            c_specs.append(v_spec)
    if resume:
        args += carries
        ins += c_specs
    meta = _layout_meta("nmf_pgm_sharded", mesh, lay, ins,
                        [a_spec, s_spec] + c_specs)
    with functional_collectives():
        return _capture(run, args, what, extra=meta, prox_A=prox_A,
                        prox_S=prox_S)


def export_nmf_adaprox_sharded(mesh, C, K, N, prox_A=operators.prox_plus,
                               prox_S=operators.prox_plus, scheme="adam",
                               b1=0.9, b2=0.999, eps=1e-8, p=0.25,
                               e_rel=1e-3, weighted=False,
                               warm_start=False, prox_max_iter=1000,
                               data_axis="data", model_axis=None,
                               dtype=torch.float32, platforms=None,
                               device=None):
    """Capture a sharded AdaProx-NMF solve as one program per rank: the
    auto-SPMD route's driver (``nmf`` on the sharded inputs, as JAX's
    artifact is its XLA driver under auto-SPMD) over a rank's shards.

    The body is the driver's (``solvers.adaprox._step``, any of the six
    Φ/Ψ schemes, the prox sub-iterations bounded by ``prox_max_iter``)
    with the all-reduces that DTensor inserts in the live solve written
    out as functional collectives: the (C, K) gradient and the step
    heuristic's row sums over the data axis, the fixed-point norms and the
    sub-iterations' sums and max over the axis that shards each block.
    DTensor programs do not pass through ``torch.export``, so this is the
    per-rank form of that solve, and it equals it bit for bit. The scheme's
    bias-correction terms follow a clock kept on the host: the scheme's
    own scalar function on 0-d CPU tensors (a CPU scalar enters a card
    operation as the driver's Python number does).

    Signature ``(A, S, Y[, W], max_iter) -> (A', S', M_A, V_A, Vhat_A, M_S,
    V_S, Vhat_S, it, conv_A, conv_S, diverged)`` laid out as
    :func:`~proxmin_tpu_torch.parallel.shard_nmf_problem` lays the problem
    out, ``max_iter`` a 0-d int32; ``warm_start=True`` appends ``(M_A,
    V_A, Vhat_A, M_S, V_S, Vhat_S, it0, conv_A0, conv_S0, diverged0)``:
    outputs 2..11 feed a continuation that walks the uninterrupted
    trajectory. ``b1`` is a constant (``max_iter`` is a runtime input).
    """
    from .parallel.sharding import _pmax, _sum_packed, functional_collectives
    from .solvers.adaprox import (_check_options, _prox_subloop_traced,
                                  _step, _stopped)
    from .solvers.common import normalize_per_block, normalize_prox
    from .utils import make_stepper

    what = "export_nmf_adaprox_sharded"
    if hasattr(b1, "__iter__"):
        raise ValueError(
            "export_nmf_adaprox_sharded takes a constant b1 (max_iter is a "
            "runtime argument, so a per-iteration schedule has no static "
            "length); use export_adaprox_solver for b1 schedules")
    lay, (C_l, N_l), dev = _sharded_setup(mesh, C, K, N, data_axis,
                                          model_axis, platforms, device,
                                          what)
    n = 2
    prox_in = (prox_A, prox_S)
    has_prox = tuple(pj is not None for pj in prox_in)
    prox_t = normalize_prox(prox_in, n)
    e_rel_t = normalize_per_block(e_rel, n)
    b1s, phi_psi = _check_options(scheme, b1, b2, eps, p, 1)
    dtype = as_torch_dtype(dtype)
    weighted, warm_start = bool(weighted), bool(warm_start)
    # the driver's default through nmf: the prox sub-iterations
    separable = (False,) * n
    groups = (lay.model, lay.data)   # the axis that shards A, S
    # the scheme's decays as the driver rounds them (b1 a constant)
    b1_t = torch.full((1,), float(b1), dtype=dtype)
    b2_t = torch.full((), float(b2), dtype=dtype)

    def reduce(j, t, op="sum"):
        if op == "max":
            return _pmax(t, groups[j])
        return _sum_packed(groups[j], t)[0]

    # step_adaprox with its sums completed, as DTensor completes them
    stepper = make_stepper(functools.partial(step_adaprox, reduce=reduce,
                                             size=(C, N)), n)

    def run(A, S, Y, *rest):
        if weighted:
            W, max_iter, *warm = rest
        else:
            (max_iter, *warm), W = rest, None

        def grad(A, S):
            D = A @ S - Y
            if W is not None:
                D = W * D
            return (_sum_packed(lay.data, D @ S.T)[0],
                    _sum_packed(lay.model, A.T @ D)[0])

        x0 = (A, S)
        if warm_start:
            MA, VA, VhA, MS, VS, VhS, it0, cA0, cS0, dv0 = warm
            M, V, Vhat = (MA, MS), (VA, VS), (VhA, VhS)
            conv = torch.stack([cA0, cS0])
        else:
            M = V = Vhat = tuple(torch.zeros_like(x) for x in x0)
            it0 = torch.zeros((), dtype=torch.int32, device=dev)
            conv = torch.zeros((n,), dtype=torch.bool, device=dev)
            dv0 = torch.zeros((), dtype=torch.bool, device=dev)
        st = dict(x=x0, M=M, V=V, Vhat=Vhat,
                  stepper_state=stepper.init_state(x0, None), it0=0,
                  converged=conv, diverged=dv0.clone(), sub_iters=[0] * n,
                  history=[], clock=it0.to("cpu", torch.int64))

        def one(s, k):
            rows = phi_psi.scalars(0, b1_t, b2_t, s["clock"])

            def scheme_at(it, G, M, V, Vhat, b1, b2, eps, p, it0=0):
                return phi_psi.apply(G, M, V, Vhat, rows, eps, p)

            _step(s, k, grad, stepper, prox_t, has_prox, separable,
                  scheme_at, b1s, b2, eps, p, e_rel_t, True, prox_max_iter,
                  None, False, subloop=_prox_subloop_traced, reduce=reduce)
            s["clock"] = s["clock"] + 1

        k, st = _solve_loop(
            st, ("x", "M", "V", "Vhat", "converged", "diverged",
                 "stepper_state", "clock"), one,
            lambda s: _stopped(s, True), max_iter, dev)
        return (st["x"][0], st["x"][1], st["M"][0], st["V"][0],
                st["Vhat"][0], st["M"][1], st["V"][1], st["Vhat"][1],
                k + it0, st["converged"][0], st["converged"][1],
                st["diverged"])

    a_spec, s_spec = [model_axis, None], [None, data_axis]
    y_spec = [model_axis, data_axis]
    a, s_ = (C_l, K), (K, N_l)
    args = [_spec(a, dtype, dev), _spec(s_, dtype, dev),
            _spec((C_l, N_l), dtype, dev)]
    ins = [a_spec, s_spec, y_spec]
    if weighted:
        args.append(_spec((C_l, N_l), dtype, dev))
        ins.append(y_spec)
    args.append(_scalar(1, torch.int32, dev))
    ins.append(None)
    blocks = [a_spec] * 3 + [s_spec] * 3
    if warm_start:
        # one example tensor per input: export takes a tensor passed twice
        # as one input
        args += [_spec(sh, dtype, dev) for sh in (a, a, a, s_, s_, s_)]
        args += [_scalar(0, torch.int32, dev)] + [
            _scalar(False, torch.bool, dev) for _ in range(3)]
        ins += blocks + [None] * 4
    meta = _layout_meta("nmf_adaprox_sharded", mesh, lay, ins,
                        [a_spec, s_spec] + blocks + [None] * 4)
    with functional_collectives():
        return _capture(run, args, what, extra=meta, prox_A=prox_A,
                        prox_S=prox_S)


def _block_shapes(x_shapes):
    """A shape or a list of shapes as a tuple of block shapes."""
    if len(x_shapes) > 0 and isinstance(x_shapes[0], (int, np.integer)):
        x_shapes = [x_shapes]
    return tuple(tuple(int(d) for d in sh) for sh in x_shapes)


def _solve_loop(st, keys, step, stopped, max_iter, device):
    """A solver body as one ``while_loop``: ``step(st, k)`` updates the
    dict ``st`` by one iteration at the counter ``k`` (a 0-d int32
    tensor), ``stopped(st)`` is its 0-d stop flag; the loop runs while not
    stopped, at most ``max_iter`` (a Python int) iterations. The entries
    named by ``keys`` (tensors, or tuples and lists of them) are the carry;
    the others stay as they are. Returns ``(k, st)``."""
    from torch._higher_order_ops.while_loop import while_loop
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten({k: st[k] for k in keys})
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            raise ValueError(
                f"the solver's carried state holds a host value "
                f"({type(leaf).__name__}); a stateful step that keeps its "
                "clock on the host cannot be exported")
    fixed = {k: v for k, v in st.items() if k not in keys}

    def unpack(leaves):
        # fresh lists: a body may not mutate what it closes over
        out = {k: list(v) if isinstance(v, list) else v
               for k, v in fixed.items()}
        out.update(tree_unflatten(list(leaves), spec))
        return out

    def cond(k, *leaves):
        return torch.logical_and(
            k < max_iter, torch.logical_not(stopped(unpack(leaves))))

    def body(k, *leaves):
        s = unpack(leaves)
        step(s, k)
        out, _ = tree_flatten({key: s[key] for key in keys})
        # a carried value the iteration left as it was, or one returned
        # twice (bsdmm's z is x without constraints), comes back as a new
        # tensor: a loop body may not return its input or one output twice
        fresh = []
        for o in out:
            if any(o is t for t in (*leaves, *fresh)):
                o = o.clone()
            fresh.append(o)
        return (k + 1, *fresh)

    k0 = torch.zeros((), dtype=torch.int32, device=device)
    k, *leaves = while_loop(cond, body, (k0, *leaves))
    return k, unpack(leaves)


def export_pgm_solver(x_shapes, grad, step, prox=None, accelerated=False,
                      restart=False, backtracking=False, f=None, e_rel=1e-6,
                      max_iter=1000, dtype=torch.float32, device=None):
    """Capture a :func:`proxmin_tpu_torch.pgm` solve for fixed block shapes.

    ``x_shapes``: one shape or a list of per-block shapes. The program
    takes the initial blocks and returns ``(x_blocks, iterations,
    converged, diverged)``; it runs the driver's body
    (``solvers.pgm._step``) and equals the driver bit for bit where the
    callables compute the same numbers from a tensor ``it`` as from a host
    one. ``backtracking=True`` runs each iteration's halvings as a nested
    ``while_loop`` (its condition reads the test once per trial point).
    """
    from .solvers.common import normalize_per_block, normalize_prox
    from .solvers.pgm import _init_state, _step
    from .utils import make_stepper

    shapes = _block_shapes(x_shapes)
    n = len(shapes)
    prox_t = normalize_prox(prox, n)
    e_rel_t = normalize_per_block(e_rel, n)
    assert backtracking is False or f is not None
    stepper = make_stepper(step, n)
    dtype = as_torch_dtype(dtype)
    dev = default_device(device)
    keys = (("x", "x_prev", "t") if accelerated else ("x",)) + (
        ("T", "f_prev") if backtracking else ()) + (
        "converged", "diverged", "stepper_state")

    def run(*x0):
        st = _init_state(x0, n, accelerated, None)
        st["stepper_state"] = stepper.init_state(x0, None)

        def one(s, k):
            _step(s, k, grad, stepper, prox_t, e_rel_t, accelerated, restart,
                  backtracking, f, False, traced=True)

        k, st = _solve_loop(
            st, keys, one,
            lambda s: torch.logical_or(s["converged"].all(), s["diverged"]),
            int(max_iter), dev)
        return tuple(st["x"]), k, st["converged"], st["diverged"]

    return _capture(run, [_spec(sh, dtype, dev) for sh in shapes],
                    "export_pgm_solver", grad=grad, step=step, prox=prox,
                    f=f)


def export_adaprox_solver(x_shapes, grad, step, prox=None, scheme="adam",
                          b1=0.9, b2=0.999, eps=1e-8, p=0.25,
                          check_convergence=True, e_rel=1e-6, max_iter=1000,
                          prox_max_iter=1000, dtype=torch.float32,
                          device=None):
    """Capture a :func:`proxmin_tpu_torch.adaprox` solve (cold-started
    moments) for fixed block shapes. Returns ``(x_blocks, M, V, Vhat,
    iterations, converged, diverged)``.

    The driver's body (``solvers.adaprox._step``): the scheme's scalar
    factors come from a table of the driver's own values, one row per
    iteration (the ``b1`` schedule and the bias-correction clock are
    static for ``max_iter`` iterations), and a non-separable prox runs its
    sub-iterations as a nested ``while_loop``.
    """
    from .solvers.adaprox import (_check_options, _prox_subloop_traced,
                                  _step, _stopped, scheme_table,
                                  table_phi_psi)
    from .solvers.common import normalize_per_block, normalize_prox
    from .utils import _as_tuple, make_stepper

    shapes = _block_shapes(x_shapes)
    n = len(shapes)
    prox_in = _as_tuple(prox)
    if len(prox_in) == 1:
        prox_in = prox_in * n
    has_prox = tuple(pj is not None for pj in prox_in)
    prox_t = normalize_prox(prox_in, n)
    e_rel_t = normalize_per_block(e_rel, n)
    b1, phi_psi = _check_options(scheme, b1, b2, eps, p, int(max_iter))
    stepper = make_stepper(step, n)
    dtype = as_torch_dtype(dtype)
    dev = default_device(device)
    # the JAX exporter's prox runs its sub-iterations (no closed form)
    separable = (False,) * n
    table = table_phi_psi(phi_psi, scheme_table(phi_psi, b1, b2,
                                                int(max_iter), dtype, dev))

    def run(*x0):
        zeros = tuple(torch.zeros_like(x) for x in x0)
        st = dict(x=x0, M=zeros, V=zeros, Vhat=zeros,
                  stepper_state=stepper.init_state(x0, None), it0=0,
                  converged=torch.zeros((n,), dtype=torch.bool, device=dev),
                  diverged=torch.zeros((), dtype=torch.bool, device=dev),
                  sub_iters=[0] * n, history=[])

        def one(s, k):
            _step(s, k, grad, stepper, prox_t, has_prox, separable, table,
                  b1, b2, eps, p, e_rel_t, check_convergence, prox_max_iter,
                  None, False, subloop=_prox_subloop_traced)

        k, st = _solve_loop(
            st, ("x", "M", "V", "Vhat", "converged", "diverged",
                 "stepper_state"), one,
            lambda s: _stopped(s, check_convergence), int(max_iter), dev)
        return (tuple(st["x"]), tuple(st["M"]), tuple(st["V"]),
                tuple(st["Vhat"]), k, st["converged"], st["diverged"])

    return _capture(run, [_spec(sh, dtype, dev) for sh in shapes],
                    "export_adaprox_solver", grad=grad, step=step, prox=prox)


def _sdmm_program(x0, prox_f, step_f, proxs_g, steps_g, Ls, e_rel, e_abs,
                  max_iter, admm_convention):
    """The ADMM-family solve as two ``while_loop`` s over
    ``solvers.admm._make_iteration`` (the driver's body). Until the first
    stall the slack is the driver's Python 1.0, so the program's arithmetic
    is the driver's; a stall ends that loop. The second takes every restart
    inside its body, as the lanes controller does (Z and U re-initialized
    from the current x, the clock at 0, half the slack), with the slack a
    0-d tensor: a step formed from it may round differently in the last
    bit (PyTorch's CUDA kernels divide by a host number as a multiplication
    by its reciprocal, by a tensor exactly). Returns the final ``(x, it,
    converged, errors)``."""
    from torch._higher_order_ops.while_loop import while_loop
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from .solvers.admm import _RESTART_BUDGET, _init_zu, _make_iteration
    from .solvers.common import map_leaves

    M = len(proxs_g)
    dev, dtype = x0.device, x0.dtype
    iteration = _make_iteration(prox_f, step_f, proxs_g, steps_g, Ls, e_rel,
                                e_abs, admm_convention, False)
    init_zu = _init_zu(proxs_g, Ls)
    z, u = init_zu(x0)

    def false():
        return torch.zeros((), dtype=torch.bool, device=dev)

    def zero():
        return torch.zeros((), dtype=torch.int32, device=dev)

    def where_tree(pred, new, old):
        new_l = tree_flatten(new)[0]
        old_l, old_spec = tree_flatten(old)
        return tree_unflatten([torch.where(pred, a, b)
                               for a, b in zip(new_l, old_l)], old_spec)

    state = dict(x=x0, z=z, u=u, r_prev=map_leaves(torch.zeros_like, z),
                 it=zero(), total=zero(), conv=false(), div=false(),
                 stall=false(),
                 errors=torch.zeros((max(M, 1), 4), dtype=dtype,
                                    device=dev))
    leaves, spec = tree_flatten(state)
    budget = _RESTART_BUDGET * int(max_iter)

    def cond(*leaves):
        s = tree_unflatten(list(leaves), spec)
        stop = s["conv"] | s["div"] | s["stall"] | (s["it"] >= max_iter) \
            | (s["total"] >= budget)
        return torch.logical_not(stop)

    def step(s, slack):
        (x_new, z, u, r, errors, conv_t, nonfinite, stall,
         _) = iteration(s["x"], s["z"], s["u"], s["r_prev"], s["it"], slack,
                        1.0)
        return dict(x=x_new, z=z, u=u, r_prev=r, it=s["it"] + 1,
                    total=s["total"] + 1, conv=conv_t,
                    div=torch.logical_or(s["div"], nonfinite),
                    stall=false() if stall is None else stall,
                    errors=errors)

    def restart(s):
        z0, u0 = init_zu(s["x"])
        s["z"] = where_tree(s["stall"], z0, s["z"])
        s["u"] = where_tree(s["stall"], u0, s["u"])
        s["it"] = torch.where(s["stall"], zero(), s["it"])
        s["stall"] = false()
        return s

    def body(*leaves):
        out = step(tree_unflatten(list(leaves), spec), 1.0)
        return tuple(tree_flatten(out)[0])

    leaves = while_loop(cond, body, tuple(leaves))
    # from the first stall on: every restart in the body, the slack a tensor
    s = tree_unflatten(list(leaves), spec)
    s["slack"] = torch.where(s["stall"], 0.5, 1.0).to(dtype)
    s = restart(s)
    n_leaves = len(leaves)
    spec_t = tree_flatten(s)[1]

    def cond_t(*leaves):
        # the slack is the last leaf
        return cond(*leaves[:n_leaves])

    def body_t(*leaves):
        s = tree_unflatten(list(leaves), spec_t)
        out = step(s, s["slack"])
        out["slack"] = torch.where(out["stall"], s["slack"] / 2, s["slack"])
        return tuple(tree_flatten(restart(out))[0])

    leaves = while_loop(cond_t, body_t, tuple(tree_flatten(s)[0]))
    s = tree_unflatten(list(leaves), spec_t)
    return s["x"], s["it"], s["conv"], s["errors"]


def export_admm_solver(x_shape, prox_f, step_f, prox_g=None, step_g=None,
                       L=None, e_rel=1e-6, e_abs=0, max_iter=1000,
                       dtype=torch.float32, device=None):
    """Capture a :func:`proxmin_tpu_torch.admm` solve for a fixed
    ``x_shape``. The linear operator ``L`` and closure-captured data are
    baked in. Returns ``(x, iterations, converged, errors)`` (``errors``
    the Boyd residual row, shape ``(1, 4)``). Bit for bit the driver's
    until the first slack restart; from there the slack is a tensor."""
    from .linop import as_linear_operator

    dev = default_device(device)
    Lop = as_linear_operator(L, device=dev)
    proxs_g = (prox_g,) if prox_g is not None else ()
    steps_g = (step_g,) if prox_g is not None else ()
    Ls = (Lop,) if prox_g is not None else ()

    def run(x0):
        return _sdmm_program(x0, prox_f, step_f, proxs_g, steps_g, Ls, e_rel,
                             e_abs, int(max_iter), True)

    return _capture(run, [_spec(x_shape, as_torch_dtype(dtype), dev)],
                    "export_admm_solver", prox_f=prox_f, step_f=step_f,
                    prox_g=prox_g)


def export_sdmm_solver(x_shape, prox_f, step_f, proxs_g, steps_g=None,
                       Ls=None, e_rel=1e-6, e_abs=0, max_iter=1000,
                       dtype=torch.float32, device=None):
    """Capture a :func:`proxmin_tpu_torch.sdmm` solve (M constraints) for
    a fixed ``x_shape``. Returns ``(x, iterations, converged, errors)``
    (``errors`` of shape ``(M, 4)``). Bit for bit the driver's until the
    first slack restart; from there the slack is a tensor."""
    from .linop import as_linear_operator

    dev = default_device(device)
    proxs_g = tuple(proxs_g)
    M = len(proxs_g)
    if not hasattr(Ls, "__iter__"):
        Ls = [Ls] * M
    Lops = tuple(as_linear_operator(Li, device=dev) for Li in Ls)
    steps_g = (None,) * M if steps_g is None else tuple(steps_g)

    def run(x0):
        return _sdmm_program(x0, prox_f, step_f, proxs_g, steps_g, Lops,
                             e_rel, e_abs, int(max_iter), False)

    return _capture(run, [_spec(x_shape, as_torch_dtype(dtype), dev)],
                    "export_sdmm_solver", prox_f=prox_f, step_f=step_f,
                    proxs_g=proxs_g[0] if M else None)


def export_bsdmm_solver(x_shapes, proxs_f, steps_f_cb, proxs_g=None,
                        steps_g=None, Ls=None, update_order=None,
                        steps_g_update="steps_f", e_rel=1e-6, e_abs=0,
                        max_iter=1000, steps_f_stride=None,
                        dtype=torch.float32, device=None):
    """Capture a :func:`proxmin_tpu_torch.bsdmm` solve for fixed block
    shapes: the driver's sweep (``solvers.bsdmm._Program.sweep``) in one
    ``while_loop``. Returns ``(x_blocks, iterations,
    converged_per_block)``. Steps that are strided (``steps_f_stride``),
    stateful or ``steps_g_update="relative"`` keep a host clock in the
    port's sweep and raise ``ValueError`` (owed, ROADMAP.md)."""
    from .functional import _block_order
    from .solvers.bsdmm import _Program

    shapes = _block_shapes(x_shapes)
    N = len(shapes)
    dev = default_device(device)
    dtype = as_torch_dtype(dtype)
    prog = _Program(N, dev, proxs_f, steps_f_cb, proxs_g=proxs_g,
                    steps_g=steps_g, Ls=Ls, update_order=update_order,
                    steps_g_update=steps_g_update, e_rel=e_rel, e_abs=e_abs,
                    steps_f_stride=steps_f_stride)
    if prog.strided or prog.stateful_steps or steps_g_update == "relative":
        raise ValueError(
            "export_bsdmm_solver: strided, stateful or relative steps are "
            "not exported yet (the port's sweep keeps their clock on the "
            "host; ROADMAP.md, owed)")

    def run(*xs):
        st = prog.init_state(xs)
        st["converged"] = torch.zeros((N,), dtype=torch.bool, device=dev)
        st["diverged"] = torch.zeros((), dtype=torch.bool, device=dev)

        def one(s, k):
            flags, _ = prog.sweep(s, k)
            # new tensors, not views of one: a loop body's outputs may not
            # alias each other
            s["converged"] = _block_order(flags, prog.update_order).clone()
            s["diverged"] = flags[-1].clone()

        k, st = _solve_loop(
            st, ("x", "z", "u", "converged", "diverged"), one,
            lambda s: torch.logical_or(s["converged"].all(), s["diverged"]),
            int(max_iter), dev)
        return tuple(st["x"]), k, st["converged"]

    return _capture(run, [_spec(sh, dtype, dev) for sh in shapes],
                    "export_bsdmm_solver", proxs_f=proxs_f,
                    steps_f_cb=steps_f_cb)


def _input_device(ep):
    """The device of the first input of an exported program."""
    spec = ep.graph_signature.user_inputs
    for node in ep.graph.nodes:
        if node.op == "placeholder" and node.name in spec:
            val = node.meta.get("val")
            if isinstance(val, torch.Tensor):
                return val.device
    return torch.device("cpu")


def _host_arg(a, device):
    """A Python bool, int or NumPy input as the program's tensor."""
    if isinstance(a, bool):
        return torch.tensor(a, device=device)
    if isinstance(a, int):
        return torch.tensor(a, dtype=torch.int32, device=device)
    if isinstance(a, (np.ndarray, np.generic)):
        return torch.as_tensor(np.array(a), device=device)
    return a


def _rename_groups(module, names):
    """Point the functional collectives of ``module`` (its loop bodies
    included) at this process's groups: ``names`` maps a captured group
    name to the name of the group over the same mesh axis here."""
    for gm in module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        changed = False
        for node in gm.graph.nodes:
            if (node.op == "call_function"
                    and "_c10d_functional" in str(node.target)
                    and len(node.args) > 2 and node.args[2] in names):
                args = list(node.args)
                args[2] = names[args[2]]
                node.args = tuple(args)
                changed = True
        if changed:
            gm.recompile()


def _input_specs(ep):
    """The ``(dtype, device)`` of each user input of an exported program."""
    names = set(ep.graph_signature.user_inputs)
    return [(n.meta["val"].dtype, n.meta["val"].device)
            for n in ep.graph.nodes
            if n.op == "placeholder" and n.name in names
            and isinstance(n.meta.get("val"), torch.Tensor)]


def _sharded_solver(module, meta, device, specs):
    """The callable of a per-rank program (its ``meta`` from
    :func:`_layout_meta`): on a process group of the capture's size, it
    takes the ``DTensor`` s of :func:`~proxmin_tpu_torch.parallel.
    shard_nmf_problem` (and gives the sharded outputs back as ``DTensor``
    s) or this rank's local shards. A host number or NumPy value takes its
    input's dtype (``specs``, :func:`_input_specs`): a live solve's
    ``.state`` feeds a resume program as it is."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from .parallel.sharding import (_axis_size, _dtensor, _group, _local,
                                    make_mesh)

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != meta["world"]:
        raise ValueError(
            f"this {meta['kind']} program was captured on a mesh of "
            f"{meta['world']} ranks and the process group has {world}: "
            "serve it on a group of the same size")
    axes = {"data": meta["data_axis"], "model": meta["model_axis"]}

    def spec(sp):
        return tuple(tuple(a) if isinstance(a, list) else a for a in sp)

    # the group names the module's collectives name now
    current = dict(meta["groups"])

    def point_at(mesh):
        names = {}
        for k in ("data", "model"):
            if current[k] is not None:
                new = _group(mesh, axes[k]).group_name
                if new != current[k]:
                    names[current[k]], current[k] = new, new
        if names:
            _rename_groups(module, names)

    own = []   # the mesh of local-shard calls, made once

    def solve(*args):
        mesh = next((a.device_mesh for a in args
                     if isinstance(a, DTensor)), None)
        given = mesh is not None
        if mesh is None:
            if not own:
                own.append(make_mesh(tuple(meta["mesh_shape"]),
                                     tuple(meta["axis_names"]),
                                     device=device.type))
            mesh = own[0]
        point_at(mesh)
        conv = []
        for a, sp, (dt, dev) in zip(args, meta["inputs"], specs):
            if isinstance(a, DTensor):
                a = _local(a, mesh, spec(sp))
            elif not isinstance(a, torch.Tensor):
                a = torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
            conv.append(a)
        out = module(*conv)
        if not given:
            return out
        res = []
        for o, sp in zip(out, meta["outputs"] + [None] * len(out)):
            if sp is not None:
                sp = spec(sp)
                shape = [d * (_axis_size(mesh, ax) if ax else 1)
                         for d, ax in zip(o.shape, sp)]
                o = _dtensor(o, mesh, sp, shape)
            res.append(o)
        return tuple(res)

    return solve


def load_solver(blob):
    """Deserialize an exported solver into a callable.

    Works for every exporter of this module. The callable forwards its
    arguments to the program: Python bools become 0-d bool tensors and
    Python ints 0-d int32 tensors (bool first: it is an int), and NumPy
    arrays go to the program's device; tensors pass as they are. A program
    that calls the kernels needs ``proxmin_tpu_torch.ops`` imported in this
    process (its ops registered) before loading.

    A per-rank program of :func:`export_nmf_pgm_sharded` or
    :func:`export_nmf_adaprox_sharded` is loaded by every rank of a process
    group of the size it was captured on (another size raises
    ``ValueError`` naming both); its callable takes the ``DTensor`` s that
    :func:`~proxmin_tpu_torch.parallel.shard_nmf_problem` makes, and gives
    the sharded outputs back as ``DTensor`` s, or takes the rank's local
    shards and gives local shards back. Its collectives run over this
    process's groups of the same mesh axes."""
    files = {_LAYOUT: ""}
    ep = torch.export.load(io.BytesIO(blob), extra_files=files)
    module = ep.module()
    device = _input_device(ep)
    if files[_LAYOUT]:
        return _sharded_solver(module, json.loads(files[_LAYOUT]), device,
                               _input_specs(ep))

    def solve(*args):
        return module(*(_host_arg(a, device) for a in args))

    return solve


def save_exported(path, blob):
    """Write an exported solver's bytes to ``path``; returns ``path``."""
    with open(path, "wb") as fh:
        fh.write(blob)
    return path


def load_exported(path):
    """:func:`load_solver` of the bytes in ``path``."""
    with open(path, "rb") as fh:
        return load_solver(fh.read())
