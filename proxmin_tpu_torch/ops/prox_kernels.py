"""K4: the standalone proximal-operator kernels, each beside its plain
version.

Counterparts of ``proxmin_tpu.ops.prox_kernels``: :func:`prox_plus_pallas`,
:func:`prox_soft_pallas`, :func:`prox_hard_pallas` and
:func:`prox_unity_pallas` keep the JAX names and signatures (minus
``interpret=``), so ``from proxmin_tpu.ops import prox_soft_pallas``
becomes ``from proxmin_tpu_torch.ops import prox_soft_pallas``. They are
drop-in proxes for the solvers, e.g.
``AlternatingProjections([prox_unity_pallas, prox_plus_pallas])``.

On CUDA tensors each launches the CUDA kernel of ``csrc/prox_elementwise.cu``
(built at first use by :mod:`._build`) on the current stream without
synchronizing, or raises; each launch adds one to the wrapper's
``.launches``. On CPU tensors each runs its plain version
(``*_reference``), the operator of :mod:`proxmin_tpu_torch.operators`.
float64 computes in float64; every other dtype computes in float32 and is
cast back, as the TPU wrappers do. The input must be 2-D; the result is a
new tensor.

A threshold that lives on the card (the solvers' step is a 0-d tensor there)
reaches the kernel as a device pointer, and the kernel multiplies a relative
threshold itself (:func:`threshold_args`): a call is one CUDA launch
(unity along axis 1 a cooperative one) and reads nothing back to the host.

Each kernel is also a registered PyTorch op of the ``proxmin_torch``
namespace (``prox_plus``, ``prox_soft``, ``prox_hard``, ``prox_unity``,
the threshold as :func:`threshold_args` gives it), with a fake: a program
captured by ``torch.export`` records the op, and the wrappers call it while
a program is captured. A process that serves such a program imports this
module first.
"""

import ctypes
import typing
from typing import Optional

import numpy as np
import torch

from .. import operators
from ._build import _library, register, tracing

__all__ = [
    "prox_plus_pallas",
    "prox_soft_pallas",
    "prox_hard_pallas",
    "prox_unity_pallas",
    "prox_plus_reference",
    "prox_soft_reference",
    "prox_hard_reference",
    "prox_unity_reference",
    "threshold_args",
    "threshold_reference",
    "prox_plus_op",
    "prox_soft_op",
    "prox_hard_op",
    "prox_unity_op",
]

_OP = {"plus": 0, "soft": 1, "hard": 2}
#: The kernel's code for a threshold that comes by device pointer.
_T_TYPE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
           torch.float16: 3}


def _declare(lib):
    p, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_double)
    lib.prox_elementwise.argtypes = [i, i, p, p, ll, p, i, i, d, d, p]
    lib.prox_elementwise.restype = i
    lib.prox_unity_partials.argtypes = [i, ll, ll]
    lib.prox_unity_partials.restype = ll
    lib.prox_unity.argtypes = [i, i, p, p, ll, ll, p, p]
    lib.prox_unity.restype = i


register("prox_elementwise", _declare)


def _compute_dtype(X):
    """float64 stays float64; everything else computes in float32."""
    return torch.float64 if X.dtype == torch.float64 else torch.float32


def _as_2d(X, name):
    if not isinstance(X, torch.Tensor):
        X = torch.as_tensor(X)
    if X.dim() != 2:
        raise ValueError(f"{name} takes a 2-D tensor, got shape "
                         f"{tuple(X.shape)}")
    return X


def _on_card(X, name):
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device."""
    if X.is_cuda:
        return True
    if X.is_cpu:
        return False
    raise ValueError(f"{name} runs on CPU or CUDA tensors, got {X.device}")


class ThresholdArgs(typing.NamedTuple):
    """How the kernel forms the threshold ``t`` (see
    :func:`threshold_args`): ``tensor`` is None and ``t = value``, or ``t``
    is the one element of the device tensor ``tensor``, times ``scale`` when
    ``scaled``."""
    tensor: typing.Optional[torch.Tensor]
    scaled: bool
    value: float
    scale: float


_NO_THRESHOLD = ThresholdArgs(None, False, 0.0, 1.0)


def _one_element(t):
    if t.numel() != 1:
        raise ValueError(f"the threshold must be a scalar, got shape "
                         f"{tuple(t.shape)}")
    return t


def _host_number(v):
    """A Python int or float (not bool): PyTorch multiplies a tensor by it
    as a scalar of the tensor's arithmetic type."""
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def threshold_args(step, thresh, type, device):
    """The arguments from which the K4 kernel forms
    ``operators.get_thresh(step, thresh, type)`` on ``device``, the way the
    plain version then converts it to the compute dtype, without a host
    sync and without a launch of its own:

    * relative, one of ``step``/``thresh`` a one-element tensor on
      ``device`` (float32, float64, bfloat16 or float16) and the other a
      Python number: that tensor, scaled by the number (``step * thresh``
      as PyTorch computes it, in the tensor's type);
    * absolute with such a tensor: the tensor, unscaled;
    * host numbers: the threshold's value;
    * a CPU tensor: that tensor, which a launch on the card reads on the
      host (it waits on nothing) and passes by value (:func:`_by_value`);
    * anything else (a tensor of another dtype or device, two tensors):
      ``get_thresh``'s own result on ``device``, which costs that
      computation's launches."""
    if type not in ("relative", "absolute"):
        raise ValueError(f"type must be 'relative' or 'absolute', got "
                         f"{type!r}")
    if type == "relative":
        for a, b in ((step, thresh), (thresh, step)):
            if (isinstance(a, torch.Tensor) and a.device == device
                    and a.dtype in _T_TYPE and _host_number(b)):
                return ThresholdArgs(_one_element(a), True, 0.0, float(b))
    elif (isinstance(thresh, torch.Tensor) and thresh.device == device
            and thresh.dtype in _T_TYPE):
        return ThresholdArgs(_one_element(thresh), False, 0.0, 1.0)
    t = operators.get_thresh(step, thresh, type)
    if _host_number(t):
        return ThresholdArgs(None, False, float(t), 1.0)
    if isinstance(t, torch.Tensor):
        _one_element(t)
        if t.device.type == "cpu":
            return ThresholdArgs(t, False, 0.0, 1.0)
        if t.device != device or t.dtype not in _T_TYPE:
            t = t.to(device=device, dtype=torch.float64)
        return ThresholdArgs(t, False, 0.0, 1.0)
    if np.size(t) != 1:
        raise ValueError(f"the threshold must be a scalar, got shape "
                         f"{np.shape(t)}")
    return ThresholdArgs(None, False, float(np.asarray(t).reshape(())), 1.0)


def threshold_reference(args, dtype):
    """The threshold that the kernel forms from :func:`threshold_args`'
    ``args``, as a one-element tensor of the compute ``dtype`` on the
    argument tensor's device: its arithmetic in PyTorch ops."""
    if args.tensor is None:
        return torch.tensor([args.value], dtype=torch.float64).to(dtype)
    s = args.tensor.reshape(1)
    if args.scaled:
        # float and double multiply in their own type; bfloat16 and half in
        # float, rounded back
        op = s.dtype if s.dtype in (torch.float32, torch.float64) \
            else torch.float32
        s = (s.to(op) * torch.tensor(args.scale, dtype=op,
                                     device=s.device)).to(s.dtype)
    return s.to(dtype)


_cuda = None


def _call(fn, device, *args):
    """``fn(*args, stream)`` on ``device``'s current stream (an integer
    handle), with the device made current only when it is not. The two
    lookups are PyTorch's own C functions, found once."""
    global _cuda
    if _cuda is None:
        _cuda = (getattr(torch._C, "_cuda_getDevice", None)
                 or torch.cuda.current_device,
                 getattr(torch._C, "_cuda_getCurrentRawStream", None)
                 or (lambda i: torch.cuda.current_stream(i).cuda_stream))
    current, stream = _cuda
    index = device.index
    if index == current():
        return fn(*args, stream(index))
    with torch.cuda.device(device):
        return fn(*args, stream(index))


def _by_value(targs):
    """``targs`` for a launch on the card: a threshold held in a CPU tensor
    is read on the host, which waits on nothing, and passed by value."""
    t = targs.tensor
    if t is None or t.device.type != "cpu":
        return targs
    return ThresholdArgs(None, False, float(t.reshape(())), 1.0)


def _launch_elementwise(wrapper, op, X, targs=_NO_THRESHOLD):
    """Launch the elementwise kernel ``op`` on the CUDA tensor ``X`` with
    the threshold ``targs`` (:func:`threshold_args`) and count it on
    ``wrapper``; an empty ``X`` launches nothing."""
    targs = _by_value(targs)
    cdt = _compute_dtype(X)
    Xc = X if X.dtype == cdt and X.is_contiguous() else \
        X.to(cdt).contiguous()
    device = Xc.device
    n = Xc.numel()
    if n == 0:
        return X.clone()
    out = torch.empty_like(Xc)
    t = targs.tensor
    rc = _call(_library("prox_elementwise").prox_elementwise, device,
               _OP[op], int(cdt == torch.float64), Xc.data_ptr(),
               out.data_ptr(), n,
               None if t is None else t.data_ptr(),
               0 if t is None else _T_TYPE[t.dtype], int(targs.scaled),
               targs.value, targs.scale)
    if rc != 0:
        raise RuntimeError(f"prox_{op}_pallas launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out if out.dtype == X.dtype else out.to(X.dtype)


def prox_plus_reference(X, step):
    """Plain PyTorch version of :func:`prox_plus_pallas`."""
    cdt = _compute_dtype(X)
    return operators.prox_plus(X.to(cdt), step).to(X.dtype)


def _kernel_threshold(X, step, thresh, type):
    """The threshold as the kernel forms it, in X's compute dtype: the
    operators then compute in that dtype, as the kernel does, whatever the
    step's dtype (they would promote a float64 step, as JAX does)."""
    return threshold_reference(threshold_args(step, thresh, type, X.device),
                               _compute_dtype(X))


def prox_soft_reference(X, step, thresh=0, type="relative"):
    """Plain PyTorch version of :func:`prox_soft_pallas`."""
    cdt = _compute_dtype(X)
    return operators.prox_soft(X.to(cdt), step,
                               thresh=_kernel_threshold(X, step, thresh, type),
                               type="absolute").to(X.dtype)


def prox_hard_reference(X, step, thresh=0, type="relative"):
    """Plain PyTorch version of :func:`prox_hard_pallas`."""
    cdt = _compute_dtype(X)
    return operators.prox_hard(X.to(cdt), step,
                               thresh=_kernel_threshold(X, step, thresh, type),
                               type="absolute").to(X.dtype)


def prox_unity_reference(X, step, axis=0):
    """Plain PyTorch version of :func:`prox_unity_pallas`."""
    cdt = _compute_dtype(X)
    return operators.prox_unity(X.to(cdt), step, axis=axis).to(X.dtype)


def _thresholded_reference(prox, X, targs):
    """``prox`` (``operators.prox_soft`` or ``prox_hard``) in X's compute
    dtype with the threshold the kernel forms from ``targs``."""
    cdt = _compute_dtype(X)
    return prox(X.to(cdt), 1.0, thresh=threshold_reference(targs, cdt),
                type="absolute").to(X.dtype)


@torch.library.custom_op("proxmin_torch::prox_plus", mutates_args=())
def prox_plus_op(X: torch.Tensor) -> torch.Tensor:
    """K4 plus as a registered op (2-D X)."""
    if not _on_card(X, "prox_plus_pallas"):
        return prox_plus_reference(X, None)
    return _launch_elementwise(prox_plus_pallas, "plus", X)


def _threshold_op(op):
    def impl(X: torch.Tensor, t: Optional[torch.Tensor], scaled: bool,
             value: float, scale: float) -> torch.Tensor:
        targs = ThresholdArgs(None if t is None else _one_element(t),
                              bool(scaled), float(value), float(scale))
        wrapper = prox_soft_pallas if op == "soft" else prox_hard_pallas
        if not _on_card(X, wrapper.__name__):
            return _thresholded_reference(
                operators.prox_soft if op == "soft" else operators.prox_hard,
                X, targs)
        return _launch_elementwise(wrapper, op, X, targs)

    impl.__name__ = f"prox_{op}_op"
    impl.__doc__ = (f"K4 {op} as a registered op (2-D X), the threshold as "
                    ":func:`threshold_args` gives it.")
    return torch.library.custom_op(f"proxmin_torch::prox_{op}",
                                   mutates_args=())(impl)


prox_soft_op = _threshold_op("soft")
prox_hard_op = _threshold_op("hard")


@torch.library.custom_op("proxmin_torch::prox_unity", mutates_args=())
def prox_unity_op(X: torch.Tensor, axis: int) -> torch.Tensor:
    """K4 unity as a registered op (2-D X, axis 0 or 1)."""
    if not _on_card(X, "prox_unity_pallas"):
        return prox_unity_reference(X, None, axis=axis)
    return _launch_unity(X, axis)


@prox_plus_op.register_fake
def _(X):
    return torch.empty_like(X)


@prox_soft_op.register_fake
def _(X, t, scaled, value, scale):
    return torch.empty_like(X)


@prox_hard_op.register_fake
def _(X, t, scaled, value, scale):
    return torch.empty_like(X)


@prox_unity_op.register_fake
def _(X, axis):
    return torch.empty_like(X)


def _thresholded_op(op, X, step, thresh, type):
    targs = threshold_args(step, thresh, type, X.device)
    return op(X, targs.tensor, targs.scaled, targs.value, targs.scale)


def prox_plus_pallas(X, step):
    """Non-negativity projection ``max(X, 0)`` (== ``operators.prox_plus``;
    NaN propagates), a CUDA kernel on CUDA tensors."""
    X = _as_2d(X, "prox_plus_pallas")
    if tracing(X):
        return prox_plus_op(X)
    if not _on_card(X, "prox_plus_pallas"):
        return prox_plus_reference(X, step)
    return _launch_elementwise(prox_plus_pallas, "plus", X)


def prox_soft_pallas(X, step, thresh=0, type="relative"):
    """Soft threshold ``sign(X) max(|X| - t, 0)`` with
    ``t = get_thresh(step, thresh, type)`` (== ``operators.prox_soft``), a
    CUDA kernel on CUDA tensors."""
    X = _as_2d(X, "prox_soft_pallas")
    if tracing(X):
        return _thresholded_op(prox_soft_op, X, step, thresh, type)
    if not _on_card(X, "prox_soft_pallas"):
        return prox_soft_reference(X, step, thresh=thresh, type=type)
    return _launch_elementwise(prox_soft_pallas, "soft", X,
                               threshold_args(step, thresh, type, X.device))


def prox_hard_pallas(X, step, thresh=0, type="relative"):
    """Hard threshold: ``X`` where ``|X| >= t``, else 0, with
    ``t = get_thresh(step, thresh, type)`` (== ``operators.prox_hard``), a
    CUDA kernel on CUDA tensors."""
    X = _as_2d(X, "prox_hard_pallas")
    if tracing(X):
        return _thresholded_op(prox_hard_op, X, step, thresh, type)
    if not _on_card(X, "prox_hard_pallas"):
        return prox_hard_reference(X, step, thresh=thresh, type=type)
    return _launch_elementwise(prox_hard_pallas, "hard", X,
                               threshold_args(step, thresh, type, X.device))


def prox_unity_pallas(X, step, axis=0):
    """Sum-to-one rescale ``X / sum(X, axis)`` along axis 0 (per column) or
    1 (per row) (== ``operators.prox_unity``), a CUDA kernel on CUDA
    tensors. A zero sum gives inf or NaN, as in JAX."""
    X = _as_2d(X, "prox_unity_pallas")
    if axis not in (0, 1):
        raise ValueError(f"prox_unity_pallas takes axis 0 or 1, got {axis}")
    if tracing(X):
        return prox_unity_op(X, axis)
    if not _on_card(X, "prox_unity_pallas"):
        return prox_unity_reference(X, step, axis=axis)
    return _launch_unity(X, axis)


def _launch_unity(X, axis):
    """Launch the unity kernel along ``axis`` on the CUDA tensor ``X`` and
    count it; an empty ``X`` launches nothing."""
    if X.numel() == 0:
        return X.clone()
    cdt = _compute_dtype(X)
    Xc = X if X.dtype == cdt and X.is_contiguous() else \
        X.to(cdt).contiguous()
    rows, cols = Xc.shape
    out = torch.empty_like(Xc)
    lib = _library("prox_elementwise")
    partials = (torch.empty((lib.prox_unity_partials(axis, rows, cols),),
                            dtype=cdt, device=Xc.device)
                if axis == 1 else None)
    rc = _call(lib.prox_unity, Xc.device, axis, int(cdt == torch.float64),
               Xc.data_ptr(), out.data_ptr(), rows, cols,
               None if partials is None else partials.data_ptr())
    if rc != 0:
        raise RuntimeError(f"prox_unity_pallas launch failed: CUDA error "
                           f"{rc}")
    prox_unity_pallas.launches += 1
    return out if out.dtype == X.dtype else out.to(X.dtype)


for _f in (prox_plus_pallas, prox_soft_pallas, prox_hard_pallas,
           prox_unity_pallas):
    _f.launches = 0
del _f
