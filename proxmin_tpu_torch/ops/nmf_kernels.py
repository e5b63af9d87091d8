"""The fused NMF kernels K1, K2 and K3: their CUDA wrappers, C signatures
and plain versions.

:func:`fused_nmf_pgm_step` (K1) is the counterpart of
``proxmin_tpu.ops.nmf_kernels.fused_nmf_pgm_step``: one S-side PGM-NMF
iteration in one pass over the pixel columns (residual, both factor
gradients, the proxed S update, the next iteration's ``S' S'^T`` Gram and
the fixed-point statistics), kernel in ``csrc/nmf_pgm_step.cu``.

:func:`fused_nmf_adaprox_step` (K2) is the counterpart of
``proxmin_tpu.ops.nmf_kernels.fused_nmf_adaprox_step``: one S-side
proximal-Adam iteration in one pass (residual, both gradients, the moment
EMAs with bias correction, the closed-form separable prox, the next
iteration's row sums and the statistics), kernel in
``csrc/nmf_adaprox_step.cu``.

:func:`fused_nmf_grad` (K3) is the counterpart of
``proxmin_tpu.ops.fused_nmf_grad``: both factor gradients, the ``S S^T``
Gram and the loss in one pass, the residual never stored, kernel in
``csrc/nmf_grad.cu``. No solver calls it; a user passes it to ``pgm`` as
the gradient.

On CUDA tensors each wrapper launches its hand-written kernel; on CPU
tensors it runs its plain version (``*_reference``), the same math as
tensor ops. Each kernel is also a registered PyTorch op in the
``proxmin_torch`` namespace (``torch.ops.proxmin_torch.fused_nmf_pgm_step``,
``fused_nmf_adaprox_step``, ``fused_nmf_grad``), with a fake that gives its
outputs' shapes and dtypes: a program captured by ``torch.export`` records
the op, and a process that serves the program runs the same launch (or, on
CPU tensors, the plain version) once this module is imported. The eager
drivers call the wrappers, which skip the dispatcher; while a program is
captured the wrappers call the ops. Unlike the TPU kernels, they take
unpadded ``(C, K)``, ``(K, N)`` and ``(C, N)`` tensors: there is no
sublane/lane padding, no VMEM tile model and no ``dims`` argument. The
kernels are built at first use by :mod:`._build`.
"""

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import operators
from ._build import _library, build_kernel, build_kernels, register, tracing

__all__ = [
    "fused_nmf_pgm_step",
    "fused_nmf_pgm_step_reference",
    "fused_nmf_adaprox_step",
    "fused_nmf_adaprox_step_reference",
    "fused_nmf_grad",
    "fused_nmf_grad_reference",
    "fused_nmf_pgm_step_op",
    "fused_nmf_adaprox_step_op",
    "fused_nmf_grad_op",
    "build_kernel",
    "build_kernels",
    "DEFAULT_TILE_N",
]

#: Pixel columns per tile; the tiles fix the kernels' summation order. K2
#: writes one row of partial sums per tile; K1 and K3 split each tile into
#: parts of at most 1024 columns, a row each. Persistent blocks walk them.
DEFAULT_TILE_N = 4096

_F32_TINY = float(torch.finfo(torch.float32).tiny)
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)


def _declare_pgm_step(lib):
    lib.nmf_pgm_step_partials_width.argtypes = [_I, _I]
    lib.nmf_pgm_step_partials_width.restype = _I
    lib.nmf_pgm_step_partials_rows.argtypes = [_LL, _LL]
    lib.nmf_pgm_step_partials_rows.restype = _LL
    lib.nmf_pgm_step.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL,
                                 _LL, _P, _P, _P, _P, _P, _P]
    lib.nmf_pgm_step.restype = _I


def _declare_adaprox_step(lib):
    lib.nmf_adaprox_step_partials_width.argtypes = [_I, _I]
    lib.nmf_adaprox_step_partials_width.restype = _I
    lib.nmf_adaprox_step.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                                     _F, _F, _F, _F, _F, _F, _I, _I, _I, _I,
                                     _I, _LL, _LL, _P, _P, _P, _P, _P, _P, _P,
                                     _P]
    lib.nmf_adaprox_step.restype = _I
    lib.nmf_adaprox_step_dev.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                                         _F, _F, _F, _I, _I, _I, _I, _I,
                                         _LL, _LL, _P, _P, _P, _P, _P, _P,
                                         _P, _P]
    lib.nmf_adaprox_step_dev.restype = _I


def _declare_grad(lib):
    lib.nmf_grad_partials_width.argtypes = [_I, _I]
    lib.nmf_grad_partials_width.restype = _I
    lib.nmf_grad_partials_rows.argtypes = [_LL, _LL]
    lib.nmf_grad_partials_rows.restype = _LL
    lib.nmf_grad_f32.argtypes = [_P, _P, _P, _P, _I, _I, _LL, _LL,
                                 _P, _P, _P, _P, _P, _P]
    lib.nmf_grad_f32.restype = _I


register("nmf_pgm_step", _declare_pgm_step)
register("nmf_adaprox_step", _declare_adaprox_step)
register("nmf_grad", _declare_grad)


def _nonneg(X):
    return torch.maximum(X, X.new_zeros(()))


def _prox_flag(prox_S, kernel="fused_nmf_pgm_step"):
    """The kernel's builtin prox for ``prox_S``: 1 = non-negativity (None or
    ``prox_plus``), 0 = identity (``prox_id``). Anything else raises: the
    CUDA kernel cannot call a Python prox."""
    if prox_S is None or prox_S is operators.prox_plus:
        return 1
    if prox_S is operators.prox_id:
        return 0
    raise ValueError(
        f"the CUDA {kernel} applies prox_S in the kernel and "
        "supports only prox_plus (or None) and prox_id; got "
        f"{prox_S!r}. Use engine='torch' for other S constraints.")


def _flag_prox(prox_plus):
    """The prox of the kernel flag ``prox_plus`` (:func:`_prox_flag`'s
    inverse) for the plain versions."""
    return operators.prox_plus if prox_plus else operators.prox_id


def fused_nmf_pgm_step_reference(A, S, Y, sS, W=None, prox_S=None):
    """Plain PyTorch version of :func:`fused_nmf_pgm_step` (float32 tensor
    ops, any device). ``prox_S`` may be any prox callable here; None means
    non-negativity. A bfloat16 S is the bfloat16 store: the residual takes
    A rounded to bfloat16, S' comes back rounded to bfloat16, and the Gram
    and the statistics use the rounded S'."""
    f32 = torch.float32
    bf16 = S.dtype == torch.bfloat16
    A, S, Y = A.to(f32), S.to(f32), Y.to(f32)
    sS = torch.as_tensor(sS, dtype=f32, device=S.device)
    A_r = A.to(torch.bfloat16).to(f32) if bf16 else A
    R = A_r @ S - Y
    D = R if W is None else W.to(f32) * R
    gS = A.T @ D
    X = S - sS * gS
    if prox_S is None or prox_S is operators.prox_plus:
        S_new = _nonneg(X)
    else:
        S_new = prox_S(X, sS)
    S_out = S_new.to(torch.bfloat16) if bf16 else S_new
    S_new = S_out.to(f32)
    dS = S_new - S
    return (D @ S.T, S_out, S_new @ S_new.T, torch.sum(D * R) / 2,
            torch.sum(dS * dS), torch.sum(S_new * S_new))


def _check_operand(name, t, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, A is on {device}: all "
                         "operands of a fused step share one device")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def _pgm_step_cuda(A, S, Y, sS, W, prox_plus, tile_n):
    """K1's launch on CUDA tensors: checks, allocation, one launch, the
    count. Returns ``(gA, S_new, SSt, stats)`` with ``stats`` the (3,)
    float32 ``[loss, dS_sq, nS_sq]``."""
    device = A.device
    if device.type != "cuda":
        raise ValueError(f"fused_nmf_pgm_step runs on CPU or CUDA tensors, "
                         f"got {device}")
    C, K = A.shape
    N = S.shape[1]
    sdt = S.dtype
    if sdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"S must be float32 or bfloat16, got {sdt}")
    _check_operand("A", A, (C, K), device)
    _check_operand("S", S, (K, N), device, sdt)
    _check_operand("Y", Y, (C, N), device, sdt)
    if W is not None:
        _check_operand("W", W, (C, N), device, sdt)
    if N < 1 or int(tile_n) < 1:
        raise ValueError(f"need N >= 1 and tile_n >= 1, got N={N}, "
                         f"tile_n={tile_n}")
    lib = _library("nmf_pgm_step")
    width = lib.nmf_pgm_step_partials_width(C, K)
    if width < 0:
        raise ValueError(f"the CUDA fused_nmf_pgm_step is compiled for "
                         f"C <= 16 and K <= 8, got C={C}, K={K}")
    if isinstance(sS, torch.Tensor):
        step = sS.to(device=device, dtype=torch.float32).reshape(1)
    else:
        step = torch.full((1,), float(sS), dtype=torch.float32,
                          device=device)
    tile_n = int(tile_n)
    S_new = torch.empty_like(S)
    gA = torch.empty((C, K), dtype=torch.float32, device=device)
    SSt = torch.empty((K, K), dtype=torch.float32, device=device)
    stats = torch.empty((3,), dtype=torch.float32, device=device)
    partials = torch.empty((lib.nmf_pgm_step_partials_rows(N, tile_n), width),
                           dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.nmf_pgm_step(
            A.data_ptr(), S.data_ptr(), Y.data_ptr(),
            None if W is None else W.data_ptr(), step.data_ptr(),
            int(prox_plus), int(sdt == torch.bfloat16), C, K, N, tile_n,
            S_new.data_ptr(), gA.data_ptr(),
            SSt.data_ptr(), stats.data_ptr(), partials.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_nmf_pgm_step launch failed: CUDA error "
                           f"{rc}")
    fused_nmf_pgm_step.launches += 1
    return gA, S_new, SSt, stats


@torch.library.custom_op("proxmin_torch::fused_nmf_pgm_step",
                         mutates_args=())
def fused_nmf_pgm_step_op(
        A: torch.Tensor, S: torch.Tensor, Y: torch.Tensor, sS: torch.Tensor,
        W: Optional[torch.Tensor], prox_plus: int, tile_n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 as a registered op: :func:`fused_nmf_pgm_step` with ``prox_S`` as
    the kernel's flag (1 non-negativity, 0 identity) and the three
    statistics in one (3,) tensor ``[loss, dS_sq, nS_sq]``."""
    if A.device.type == "cpu":
        gA, S_new, SSt, loss, d_sq, n_sq = fused_nmf_pgm_step_reference(
            A, S, Y, sS, W=W, prox_S=_flag_prox(prox_plus))
        return gA, S_new, SSt, torch.stack([loss, d_sq, n_sq])
    return _pgm_step_cuda(A, S, Y, sS, W, prox_plus, tile_n)


@fused_nmf_pgm_step_op.register_fake
def _(A, S, Y, sS, W, prox_plus, tile_n):
    C, K = A.shape
    f32 = torch.float32
    return (A.new_empty((C, K), dtype=f32), torch.empty_like(S),
            A.new_empty((K, K), dtype=f32), A.new_empty((3,), dtype=f32))


def fused_nmf_pgm_step(A, S, Y, sS, W=None, prox_S=None,
                       tile_n=DEFAULT_TILE_N):
    """One fused PGM-NMF S-side step.

    Args:
        A: (C, K) float32. S: (K, N), Y, W: (C, N) (W optional), all
            float32 or all bfloat16 (the store; compute stays float32).
            All contiguous, on one device.
        sS: the S step size, a float or a one-element tensor (kept on the
            device, so no host sync).
        prox_S: None or ``prox_plus`` (non-negativity), or ``prox_id``.
        tile_n: pixel columns per tile; it fixes the summation order.

    Returns:
        ``(gA, S_new, SSt, loss, dS_sq, nS_sq)``: ``gA = D S^T`` with the old
        S, the proxed ``S_new`` in S's dtype, ``SSt = S_new S_new^T``, the
        loss at the old iterate and the fixed-point norms
        ``||S_new - S||^2``, ``||S_new||^2`` (0-d tensors), all float32 but
        ``S_new``; with the bfloat16 store the Gram and the norms are those
        of the rounded ``S_new``.

    CPU tensors go to :func:`fused_nmf_pgm_step_reference`. CUDA tensors
    launch the kernel (building it on first use) on the current stream
    without synchronizing, or raise; each launch adds one to
    ``fused_nmf_pgm_step.launches``. While a program is captured, the call
    is the registered op :func:`fused_nmf_pgm_step_op`.
    """
    if tracing(A, S):
        if not isinstance(sS, torch.Tensor):
            sS = torch.full((), float(sS), dtype=torch.float32,
                            device=A.device)
        gA, S_new, SSt, stats = fused_nmf_pgm_step_op(
            A, S, Y, sS, W, _prox_flag(prox_S), int(tile_n))
        return gA, S_new, SSt, stats[0], stats[1], stats[2]
    if A.device.type == "cpu":
        return fused_nmf_pgm_step_reference(A, S, Y, sS, W=W, prox_S=prox_S)
    gA, S_new, SSt, stats = _pgm_step_cuda(A, S, Y, sS, W,
                                           _prox_flag(prox_S), tile_n)
    return gA, S_new, SSt, stats[0], stats[1], stats[2]


fused_nmf_pgm_step.launches = 0


def _adaprox_scalars(scalars, b2, eps):
    """The kernel's scalars as float32 values, each computed the way the
    TPU kernel computes it: ``b1_t, bc1, bc2`` as given (host float32, or a
    CPU tensor of three float32 values),
    ``1 - b1_t`` in float32, ``1 - b2`` in double then rounded (the Python
    float ``b2`` enters the TPU kernel as a weakly typed constant)."""
    if isinstance(scalars, torch.Tensor):
        scalars = scalars.tolist()
    b1_t, bc1, bc2 = (np.float32(v) for v in scalars)
    return (b1_t, bc1, bc2, np.float32(1) - b1_t, np.float32(1.0 - b2),
            np.float32(b2), np.float32(eps))


def fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha_S, scalars,
                                     W=None, prox_S=None, b2=0.999,
                                     eps=1e-8):
    """Plain PyTorch version of :func:`fused_nmf_adaprox_step` (float32
    tensor ops, any device). ``prox_S`` may be any prox callable here; None
    means non-negativity. M and V keep their dtype (float32 or bfloat16).
    A bfloat16 S is the bfloat16 store, rounded where the TPU kernel rounds
    it: the residual takes A rounded to bfloat16, S' comes back rounded to
    bfloat16, and the row sums and the statistics use the rounded S'."""
    f32 = torch.float32
    bf16 = S.dtype == torch.bfloat16
    b1_t, bc1, bc2, omb1, omb2, b2_, eps_ = (
        float(v) for v in _adaprox_scalars(scalars, b2, eps))
    A, S, Y = A.to(f32), S.to(f32), Y.to(f32)
    alpha = alpha_S.to(f32).reshape(-1, 1)
    A_r = A.to(torch.bfloat16).to(f32) if bf16 else A
    R = A_r @ S - Y
    D = R if W is None else W.to(f32) * R
    gS = A.T @ D
    M1 = omb1 * gS + b1_t * M.to(f32)
    V1 = omb2 * (gS * gS) + b2_ * V.to(f32)
    Phi = M1 * bc1
    Psi = torch.sqrt(V1 * bc2) + eps_
    Psi_safe = torch.maximum(Psi, Psi.new_tensor(_F32_TINY))
    S1 = S - alpha * (Phi / Psi_safe)
    if prox_S is None or prox_S is operators.prox_plus:
        S1 = _nonneg(S1)
    else:
        S1 = prox_S(S1, alpha / Psi_safe)
    S_out = S1.to(torch.bfloat16) if bf16 else S1
    S1 = S_out.to(f32)
    dS = S1 - S
    return (D @ S.T, S_out, M1.to(M.dtype), V1.to(V.dtype),
            torch.sum(S1, dim=1, keepdim=True), torch.sum(D * R) / 2,
            torch.sum(dS * dS), torch.sum(S1 * S1))


def _adaprox_step_cuda(A, S, M, V, Y, alpha_S, scalars, W, prox_plus, b2,
                       eps, tile_n):
    """K2's launch on CUDA tensors: checks, allocation, one launch, the
    count. ``scalars`` by value (three host numbers) or as a (3,) float32
    tensor on the card (the device-scalar entry). Returns ``(gA, S_new,
    M_new, V_new, rowsum, stats)`` with ``stats`` the (3,) float32 ``[loss,
    dS_sq, nS_sq]``."""
    device = A.device
    if device.type != "cuda":
        raise ValueError(f"fused_nmf_adaprox_step runs on CPU or CUDA "
                         f"tensors, got {device}")
    C, K = A.shape
    N = S.shape[1]
    sdt, mdt = S.dtype, M.dtype
    if sdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"S must be float32 or bfloat16, got {sdt}")
    if mdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"moments must be float32 or bfloat16, got {mdt}")
    _check_operand("A", A, (C, K), device)
    _check_operand("S", S, (K, N), device, sdt)
    _check_operand("M", M, (K, N), device, mdt)
    _check_operand("V", V, (K, N), device, mdt)
    _check_operand("Y", Y, (C, N), device, sdt)
    if W is not None:
        _check_operand("W", W, (C, N), device, sdt)
    alpha = alpha_S.reshape(-1)
    _check_operand("alpha_S", alpha, (K,), device)
    on_card = isinstance(scalars, torch.Tensor)
    if on_card:
        _check_operand("scalars", scalars, (3,), device)
    if N < 1 or int(tile_n) < 1:
        raise ValueError(f"need N >= 1 and tile_n >= 1, got N={N}, "
                         f"tile_n={tile_n}")
    lib = _library("nmf_adaprox_step")
    width = lib.nmf_adaprox_step_partials_width(C, K)
    if width < 0:
        raise ValueError(f"the CUDA fused_nmf_adaprox_step is compiled for "
                         f"C <= 16 and K <= 8, got C={C}, K={K}")
    tile_n = int(tile_n)
    n_blocks = -(-N // tile_n)
    S_new = torch.empty_like(S)
    M_new = torch.empty_like(M)
    V_new = torch.empty_like(V)
    gA = torch.empty((C, K), dtype=torch.float32, device=device)
    rowsum = torch.empty((K, 1), dtype=torch.float32, device=device)
    stats = torch.empty((3,), dtype=torch.float32, device=device)
    partials = torch.empty((n_blocks, width), dtype=torch.float32,
                           device=device)
    # the kernel forms 1 - b1_t itself
    omb2, b2_, eps_ = (np.float32(1.0 - b2), np.float32(b2),
                       np.float32(eps))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        head = (A.data_ptr(), S.data_ptr(), M.data_ptr(), V.data_ptr(),
                Y.data_ptr(), None if W is None else W.data_ptr(),
                alpha.data_ptr())
        tail = (float(omb2), float(b2_), float(eps_), int(prox_plus),
                int(sdt == torch.bfloat16), int(mdt == torch.bfloat16), C,
                K, N, tile_n, S_new.data_ptr(), M_new.data_ptr(),
                V_new.data_ptr(), gA.data_ptr(), rowsum.data_ptr(),
                stats.data_ptr(), partials.data_ptr(), stream)
        if on_card:
            rc = lib.nmf_adaprox_step_dev(*head, scalars.data_ptr(), *tail)
        else:
            b1_t, bc1, bc2 = _adaprox_scalars(scalars, b2, eps)[:3]
            rc = lib.nmf_adaprox_step(*head, float(b1_t), float(bc1),
                                      float(bc2), *tail)
    if rc != 0:
        raise RuntimeError(f"fused_nmf_adaprox_step launch failed: CUDA "
                           f"error {rc}")
    fused_nmf_adaprox_step.launches += 1
    if on_card:
        fused_nmf_adaprox_step.device_scalar_launches += 1
    return gA, S_new, M_new, V_new, rowsum, stats


@torch.library.custom_op("proxmin_torch::fused_nmf_adaprox_step",
                         mutates_args=())
def fused_nmf_adaprox_step_op(
        A: torch.Tensor, S: torch.Tensor, M: torch.Tensor, V: torch.Tensor,
        Y: torch.Tensor, alpha_S: torch.Tensor, scalars: torch.Tensor,
        W: Optional[torch.Tensor], prox_plus: int, b2: float, eps: float,
        tile_n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    """K2 as a registered op: :func:`fused_nmf_adaprox_step` with the
    scalars ``(b1_t, bc1, bc2)`` as a (3,) float32 tensor on the operands'
    device (the kernel's device-scalar entry), ``prox_S`` as the kernel's
    flag and the three statistics in one (3,) tensor."""
    if A.device.type == "cpu":
        gA, S1, M1, V1, rowsum, loss, d_sq, n_sq = (
            fused_nmf_adaprox_step_reference(
                A, S, M, V, Y, alpha_S, scalars, W=W,
                prox_S=_flag_prox(prox_plus), b2=b2, eps=eps))
        return gA, S1, M1, V1, rowsum, torch.stack([loss, d_sq, n_sq])
    return _adaprox_step_cuda(A, S, M, V, Y, alpha_S, scalars, W, prox_plus,
                              b2, eps, tile_n)


@fused_nmf_adaprox_step_op.register_fake
def _(A, S, M, V, Y, alpha_S, scalars, W, prox_plus, b2, eps, tile_n):
    C, K = A.shape
    f32 = torch.float32
    return (A.new_empty((C, K), dtype=f32), torch.empty_like(S),
            torch.empty_like(M), torch.empty_like(V),
            A.new_empty((K, 1), dtype=f32), A.new_empty((3,), dtype=f32))


def fused_nmf_adaprox_step(A, S, M, V, Y, alpha_S, scalars, W=None,
                           prox_S=None, b2=0.999, eps=1e-8,
                           tile_n=DEFAULT_TILE_N):
    """One fused proximal-Adam (``scheme='adam'``) NMF S-side step.

    Args:
        A: (C, K) float32. S: (K, N), Y and W: (C, N) (W optional), all
            float32 or all bfloat16 (the store; compute stays float32).
            M, V: (K, N) moments, both float32 or both bfloat16. All
            contiguous, on one device.
        alpha_S: the per-row step, K float32 values ((K, 1) or (K,)), kept
            on the device.
        scalars: ``(b1_t, 1/(1 - b1_t^t), 1/(1 - b2^t))`` as host numbers
            (computed by the caller in float32 per iteration; they reach
            the kernel by value, so no host sync), or as a (3,) float32
            tensor on A's device (the kernel reads them there: an exported
            loop computes them on the card from its counter).
        prox_S: None or ``prox_plus`` (non-negativity), or ``prox_id``.
        b2, eps: the second-moment decay and the denominator floor.
        tile_n: pixel columns per tile; it fixes the summation order.

    Returns:
        ``(gA, S_new, M_new, V_new, rowsum, loss, dS_sq, nS_sq)``:
        ``gA = D S^T`` with the old S, the proxed ``S_new`` in S's dtype,
        the moments in their storage dtype, ``rowsum = S_new.sum(1)`` as
        (K, 1), the loss at the old iterate and the fixed-point norms
        ``||S_new - S||^2``, ``||S_new||^2`` (0-d tensors); with the
        bfloat16 store the row sums and the norms are those of the rounded
        ``S_new``.

    CPU tensors go to :func:`fused_nmf_adaprox_step_reference`. CUDA
    tensors launch the kernel (building it on first use) on the current
    stream without synchronizing, or raise; each launch adds one to
    ``fused_nmf_adaprox_step.launches``, and one through the device-scalar
    entry also to ``fused_nmf_adaprox_step.device_scalar_launches``. While
    a program is captured, the call is the registered op
    :func:`fused_nmf_adaprox_step_op` (the scalars must then be a tensor).
    """
    if tracing(A, S):
        gA, S1, M1, V1, rowsum, stats = fused_nmf_adaprox_step_op(
            A, S, M, V, Y, alpha_S, scalars, W,
            _prox_flag(prox_S, "fused_nmf_adaprox_step"), float(b2),
            float(eps), int(tile_n))
        return gA, S1, M1, V1, rowsum, stats[0], stats[1], stats[2]
    if A.device.type == "cpu":
        return fused_nmf_adaprox_step_reference(
            A, S, M, V, Y, alpha_S, scalars, W=W, prox_S=prox_S, b2=b2,
            eps=eps)
    gA, S1, M1, V1, rowsum, stats = _adaprox_step_cuda(
        A, S, M, V, Y, alpha_S, scalars, W,
        _prox_flag(prox_S, "fused_nmf_adaprox_step"), b2, eps, tile_n)
    return gA, S1, M1, V1, rowsum, stats[0], stats[1], stats[2]


fused_nmf_adaprox_step.launches = 0
fused_nmf_adaprox_step.device_scalar_launches = 0


def fused_nmf_grad_reference(A, S, Y, W=None):
    """Plain PyTorch version of :func:`fused_nmf_grad` (float32 tensor ops,
    any device)."""
    f32 = torch.float32
    A, S, Y = A.to(f32), S.to(f32), Y.to(f32)
    R = A @ S - Y
    D = R if W is None else W.to(f32) * R
    return D @ S.T, A.T @ D, S @ S.T, torch.sum(D * R) / 2


def fused_nmf_grad(A, S, Y, W=None, tile_n=DEFAULT_TILE_N):
    """One-pass fused NMF gradients.

    Args:
        A: (C, K), S: (K, N), Y and W: (C, N) tensors of any float dtype,
            cast to contiguous float32 as the TPU kernel casts them. W is
            None (unweighted) or a (C, N) tensor.
        tile_n: pixel columns per tile; it fixes the summation order.

    Returns:
        ``(grad_A, grad_S, SSt, loss)`` for the residual
        ``D = W (A S - Y)``: ``grad_A = D S^T``, ``grad_S = A^T D``, the
        Gram ``S S^T`` and ``loss = sum(D (A S - Y)) / 2`` (a 0-d tensor),
        all float32. D is never stored.

    CPU tensors go to :func:`fused_nmf_grad_reference`. CUDA tensors launch
    the CUDA kernel (``csrc/nmf_grad.cu``, built on first use; C <= 16,
    K <= 8) on the current stream without synchronizing, or raise; each
    launch adds one to ``fused_nmf_grad.launches``. While a program is
    captured, the call is the registered op :func:`fused_nmf_grad_op`.
    """
    A, S, Y = (torch.as_tensor(t) for t in (A, S, Y))
    W = None if W is None else torch.as_tensor(W)
    if A.dim() != 2 or S.dim() != 2 or Y.dim() != 2:
        raise ValueError("fused_nmf_grad takes 2-D A (C, K), S (K, N) and "
                         "Y (C, N)")
    C, K = A.shape
    N = S.shape[1]
    if (S.shape[0] != K or tuple(Y.shape) != (C, N)
            or (W is not None and tuple(W.shape) != (C, N))):
        raise ValueError(
            f"fused_nmf_grad shapes: A {tuple(A.shape)}, S {tuple(S.shape)}, "
            f"Y {tuple(Y.shape)}"
            + ("" if W is None else f", W {tuple(W.shape)}")
            + "; need A (C, K), S (K, N), Y and W (C, N)")
    if tracing(A, S):
        return fused_nmf_grad_op(A, S, Y, W, int(tile_n))
    if A.device.type == "cpu":
        return fused_nmf_grad_reference(A, S, Y, W=W)
    return _grad_cuda(A, S, Y, W, tile_n)


def _grad_cuda(A, S, Y, W, tile_n):
    """K3's launch on CUDA tensors of checked shapes: the casts, one
    launch, the count. Returns ``(gA, gS, SSt, loss)``."""
    device = A.device
    if device.type != "cuda":
        raise ValueError(f"fused_nmf_grad runs on CPU or CUDA tensors, got "
                         f"{device}")
    C, K = A.shape
    N = S.shape[1]
    if not (1 <= C <= 16 and 1 <= K <= 8):
        raise ValueError(f"the CUDA fused_nmf_grad is compiled for C <= 16 "
                         f"and K <= 8, got C={C}, K={K}")
    if N < 1 or int(tile_n) < 1:
        raise ValueError(f"need N >= 1 and tile_n >= 1, got N={N}, "
                         f"tile_n={tile_n}")
    f32 = torch.float32
    A, S, Y = (t.to(f32).contiguous() for t in (A, S, Y))
    _check_operand("S", S, (K, N), device)
    _check_operand("Y", Y, (C, N), device)
    if W is not None:
        W = W.to(f32).contiguous()
        _check_operand("W", W, (C, N), device)
    lib = _library("nmf_grad")
    width = lib.nmf_grad_partials_width(C, K)
    tile_n = int(tile_n)
    gA = torch.empty((C, K), dtype=f32, device=device)
    gS = torch.empty((K, N), dtype=f32, device=device)
    SSt = torch.empty((K, K), dtype=f32, device=device)
    loss = torch.empty((), dtype=f32, device=device)
    partials = torch.empty((lib.nmf_grad_partials_rows(N, tile_n), width),
                           dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.nmf_grad_f32(
            A.data_ptr(), S.data_ptr(), Y.data_ptr(),
            None if W is None else W.data_ptr(), C, K, N, tile_n,
            gA.data_ptr(), gS.data_ptr(), SSt.data_ptr(), loss.data_ptr(),
            partials.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_nmf_grad launch failed: CUDA error {rc}")
    fused_nmf_grad.launches += 1
    return gA, gS, SSt, loss


@torch.library.custom_op("proxmin_torch::fused_nmf_grad", mutates_args=())
def fused_nmf_grad_op(
        A: torch.Tensor, S: torch.Tensor, Y: torch.Tensor,
        W: Optional[torch.Tensor], tile_n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 as a registered op: :func:`fused_nmf_grad` on tensors of checked
    shapes."""
    if A.device.type == "cpu":
        return fused_nmf_grad_reference(A, S, Y, W=W)
    return _grad_cuda(A, S, Y, W, tile_n)


@fused_nmf_grad_op.register_fake
def _(A, S, Y, W, tile_n):
    C, K = A.shape
    f32 = torch.float32
    return (A.new_empty((C, K), dtype=f32), S.new_empty(S.shape, dtype=f32),
            A.new_empty((K, K), dtype=f32), A.new_empty((), dtype=f32))


fused_nmf_grad.launches = 0
