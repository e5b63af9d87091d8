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
reaches the kernel as a device pointer: no call reads a value back to the
host.
"""

import ctypes

import numpy as np
import torch

from .. import operators
from ._build import _library, register

__all__ = [
    "prox_plus_pallas",
    "prox_soft_pallas",
    "prox_hard_pallas",
    "prox_unity_pallas",
    "prox_plus_reference",
    "prox_soft_reference",
    "prox_hard_reference",
    "prox_unity_reference",
]

_OP = {"plus": 0, "soft": 1, "hard": 2}


def _declare(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.prox_elementwise.argtypes = [i, i, p, p, ll, p, p]
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
    X = torch.as_tensor(X)
    if X.dim() != 2:
        raise ValueError(f"{name} takes a 2-D tensor, got shape "
                         f"{tuple(X.shape)}")
    return X


def _on_card(X, name):
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device."""
    if X.device.type == "cpu":
        return False
    if X.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got "
                         f"{X.device}")
    return True


def _threshold(t, dtype, device):
    """The threshold as a one-element tensor of ``dtype`` on ``device``. A
    tensor already there is cast on the card (no host sync); a host value
    fills a new one."""
    if isinstance(t, torch.Tensor):
        if t.numel() != 1:
            raise ValueError(f"the threshold must be a scalar, got shape "
                             f"{tuple(t.shape)}")
        if t.device.type != "cpu":
            return t.to(device=device, dtype=dtype).reshape(1)
    elif np.size(t) != 1:
        raise ValueError(f"the threshold must be a scalar, got shape "
                         f"{np.shape(t)}")
    return torch.full((1,), float(np.asarray(t).reshape(())), dtype=dtype,
                      device=device)


def _launch_elementwise(wrapper, op, X, thresh):
    """Launch the elementwise kernel ``op`` on the CUDA tensor ``X`` and
    count it on ``wrapper``; an empty ``X`` launches nothing."""
    if X.numel() == 0:
        return X.clone()
    cdt = _compute_dtype(X)
    Xc = X.to(cdt).contiguous()
    out = torch.empty(Xc.shape, dtype=cdt, device=Xc.device)
    t = None if thresh is None else _threshold(thresh, cdt, Xc.device)
    lib = _library("prox_elementwise")
    with torch.cuda.device(Xc.device):
        stream = torch.cuda.current_stream(Xc.device).cuda_stream
        rc = lib.prox_elementwise(_OP[op], int(cdt == torch.float64),
                                  Xc.data_ptr(), out.data_ptr(), Xc.numel(),
                                  None if t is None else t.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"prox_{op}_pallas launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out.to(X.dtype)


def prox_plus_reference(X, step):
    """Plain PyTorch version of :func:`prox_plus_pallas`."""
    cdt = _compute_dtype(X)
    return operators.prox_plus(X.to(cdt), step).to(X.dtype)


def prox_soft_reference(X, step, thresh=0, type="relative"):
    """Plain PyTorch version of :func:`prox_soft_pallas`."""
    cdt = _compute_dtype(X)
    return operators.prox_soft(X.to(cdt), step, thresh=thresh,
                               type=type).to(X.dtype)


def prox_hard_reference(X, step, thresh=0, type="relative"):
    """Plain PyTorch version of :func:`prox_hard_pallas`."""
    cdt = _compute_dtype(X)
    return operators.prox_hard(X.to(cdt), step, thresh=thresh,
                               type=type).to(X.dtype)


def prox_unity_reference(X, step, axis=0):
    """Plain PyTorch version of :func:`prox_unity_pallas`."""
    cdt = _compute_dtype(X)
    return operators.prox_unity(X.to(cdt), step, axis=axis).to(X.dtype)


def prox_plus_pallas(X, step):
    """Non-negativity projection ``max(X, 0)`` (== ``operators.prox_plus``;
    NaN propagates), a CUDA kernel on CUDA tensors."""
    X = _as_2d(X, "prox_plus_pallas")
    if not _on_card(X, "prox_plus_pallas"):
        return prox_plus_reference(X, step)
    return _launch_elementwise(prox_plus_pallas, "plus", X, None)


def prox_soft_pallas(X, step, thresh=0, type="relative"):
    """Soft threshold ``sign(X) max(|X| - t, 0)`` with
    ``t = get_thresh(step, thresh, type)`` (== ``operators.prox_soft``), a
    CUDA kernel on CUDA tensors."""
    X = _as_2d(X, "prox_soft_pallas")
    t = operators.get_thresh(step, thresh, type)
    if not _on_card(X, "prox_soft_pallas"):
        return prox_soft_reference(X, step, thresh=thresh, type=type)
    return _launch_elementwise(prox_soft_pallas, "soft", X, t)


def prox_hard_pallas(X, step, thresh=0, type="relative"):
    """Hard threshold: ``X`` where ``|X| >= t``, else 0, with
    ``t = get_thresh(step, thresh, type)`` (== ``operators.prox_hard``), a
    CUDA kernel on CUDA tensors."""
    X = _as_2d(X, "prox_hard_pallas")
    t = operators.get_thresh(step, thresh, type)
    if not _on_card(X, "prox_hard_pallas"):
        return prox_hard_reference(X, step, thresh=thresh, type=type)
    return _launch_elementwise(prox_hard_pallas, "hard", X, t)


def prox_unity_pallas(X, step, axis=0):
    """Sum-to-one rescale ``X / sum(X, axis)`` along axis 0 (per column) or
    1 (per row) (== ``operators.prox_unity``), a CUDA kernel on CUDA
    tensors. A zero sum gives inf or NaN, as in JAX."""
    X = _as_2d(X, "prox_unity_pallas")
    if axis not in (0, 1):
        raise ValueError(f"prox_unity_pallas takes axis 0 or 1, got {axis}")
    if not _on_card(X, "prox_unity_pallas"):
        return prox_unity_reference(X, step, axis=axis)
    if X.numel() == 0:
        return X.clone()
    cdt = _compute_dtype(X)
    Xc = X.to(cdt).contiguous()
    rows, cols = Xc.shape
    out = torch.empty(Xc.shape, dtype=cdt, device=Xc.device)
    lib = _library("prox_elementwise")
    partials = torch.empty((lib.prox_unity_partials(axis, rows, cols),),
                           dtype=cdt, device=Xc.device)
    with torch.cuda.device(Xc.device):
        stream = torch.cuda.current_stream(Xc.device).cuda_stream
        rc = lib.prox_unity(axis, int(cdt == torch.float64), Xc.data_ptr(),
                            out.data_ptr(), rows, cols,
                            partials.data_ptr() if axis == 1 else None,
                            stream)
    if rc != 0:
        raise RuntimeError(f"prox_unity_pallas launch failed: CUDA error "
                           f"{rc}")
    prox_unity_pallas.launches += 1
    return out.to(X.dtype)


for _f in (prox_plus_pallas, prox_soft_pallas, prox_hard_pallas,
           prox_unity_pallas):
    _f.launches = 0
del _f
