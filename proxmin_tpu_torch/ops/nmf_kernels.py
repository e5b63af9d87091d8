"""The fused NMF kernels K1, K2 and K3: their CUDA wrappers, C signatures
and plain versions.

:func:`fused_nmf_pgm_step` (K1) is the counterpart of
``proxmin_tpu.ops.nmf_kernels.fused_nmf_pgm_step``: one S-side PGM-NMF
iteration in one pass over the pixel columns (residual, both factor
gradients, the proxed S update, the next iteration's ``S' S'^T`` Gram and
the fixed-point statistics), kernels in ``csrc/nmf_pgm_step.cu`` (C <= 16,
K <= 8) and ``csrc/nmf_pgm_wide.cu`` (the wide body up to C = 256, K = 32,
the very-wide body for any C and K beyond).

:func:`fused_nmf_adaprox_step` (K2) is the counterpart of
``proxmin_tpu.ops.nmf_kernels.fused_nmf_adaprox_step``: one S-side
proximal-Adam iteration in one pass (residual, both gradients, the moment
EMAs with bias correction, the closed-form separable prox, the next
iteration's row sums and the statistics), kernels in
``csrc/nmf_adaprox_step.cu`` and ``csrc/nmf_adaprox_wide.cu`` (the same
three tiers).

:func:`fused_nmf_grad` (K3) is the counterpart of
``proxmin_tpu.ops.fused_nmf_grad``: both factor gradients, the ``S S^T``
Gram and the loss in one pass, the residual never stored, kernel in
``csrc/nmf_grad.cu``. No solver calls it; a user passes it to ``pgm`` as
the gradient.

``prox_S`` reaches K1 and K2 through :func:`describe_prox`: a library
operator that acts on a pixel column alone (and an
``AlternatingProjections`` of such) compiles to a chain of codes that the
kernel applies to the K values of each column (``csrc/prox_chain.cuh``);
any other prox takes the split path, a first pass that stores the
pre-prox iterate, the prox in PyTorch on the whole (K, N) array, and a
second pass for the Gram (K1) or the row sums (K2) of its output. Either
way the prox sees whole pixel columns and the whole pixel axis, as JAX's
``engine="xla"`` applies it.

On CUDA tensors each wrapper launches its hand-written kernels; on CPU
tensors it runs its plain version (``*_reference``), the same math as
tensor ops. Each kernel is also a registered PyTorch op in the
``proxmin_torch`` namespace (``torch.ops.proxmin_torch.fused_nmf_pgm_step``,
``fused_nmf_pgm_pass1``, ``fused_nmf_pgm_pass2``, ``fused_nmf_adaprox_step``,
``fused_nmf_adaprox_pass1``, ``fused_nmf_adaprox_pass2``,
``fused_nmf_grad``), with a fake that gives its outputs' shapes and dtypes:
a program captured by ``torch.export`` records the op (a compiled chain as
its codes), and a process that serves the program runs the same launch
(or, on CPU tensors, the plain version) once this module is imported. The
eager drivers call the wrappers, which skip the dispatcher; while a
program is captured the wrappers call the ops. Unlike the TPU kernels, they
take unpadded ``(C, K)``, ``(K, N)`` and ``(C, N)`` tensors: there is no
sublane/lane padding, no VMEM tile model and no ``dims`` argument. The
kernels are built at first use by :mod:`._build`.
"""

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from .. import operators
from ..solvers.common import separable_blocks
from ._build import _library, build_kernel, build_kernels, register, tracing

__all__ = [
    "fused_nmf_pgm_step",
    "fused_nmf_pgm_step_reference",
    "fused_nmf_adaprox_step",
    "fused_nmf_adaprox_step_reference",
    "fused_nmf_grad",
    "fused_nmf_grad_reference",
    "fused_nmf_pgm_step_op",
    "fused_nmf_pgm_pass1_op",
    "fused_nmf_pgm_pass2_op",
    "fused_nmf_adaprox_step_op",
    "fused_nmf_adaprox_pass1_op",
    "fused_nmf_adaprox_pass2_op",
    "fused_nmf_grad_op",
    "ProxDescriptor",
    "describe_prox",
    "build_kernel",
    "build_kernels",
    "DEFAULT_TILE_N",
    "WIDE_C",
    "WIDE_K",
    "tier",
]

#: Pixel columns per tile; the tiles fix the kernels' summation order. K2
#: writes one row of partial sums per tile; K1 and K3 split each tile into
#: parts of at most 1024 columns, a row each. Persistent blocks walk them.
DEFAULT_TILE_N = 4096

#: The tiers' bounds: the narrow instances take C <= 16, K <= 8, the wide
#: body up to C = WIDE_C channels and K = WIDE_K components, the very-wide
#: tier every larger C or K (the wide body's instances at C > WIDE_C up to
#: K = WIDE_K, ``csrc/kwide_pass.cuh``'s body for the passes with a
#: residual beyond, up to K = KWIDE_K, then K1's and K3's on
#: ``csrc/panel_pass.cuh``'s up to K = PANEL_K, and the rest on
#: ``csrc/vwide_pass.cuh``'s; the split path's second passes past K = WIDE_K
#: on ``csrc/post_pass.cuh``'s, at any K). ``csrc/tiers.cuh`` holds WIDE_K,
#: KWIDE_K and PANEL_K for the kernels.
_NARROW_C, _NARROW_K = 16, 8
WIDE_C, WIDE_K = 256, 32
KWIDE_K = 256
PANEL_K = 512

_F32_TINY = float(torch.finfo(torch.float32).tiny)
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)


def _declare_pgm_step(lib):
    lib.nmf_pgm_step_partials_width.argtypes = [_I, _I]
    lib.nmf_pgm_step_partials_width.restype = _I
    lib.nmf_pgm_step_partials_rows.argtypes = [_LL, _LL]
    lib.nmf_pgm_step_partials_rows.restype = _LL
    lib.nmf_pgm_step.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I,
                                 _I, _LL, _LL, _P, _P, _P, _P, _P, _P]
    lib.nmf_pgm_step.restype = _I


def _declare_pgm_wide(lib):
    lib.nmf_pgm_wide_scratch_floats.argtypes = [_I, _I, _I, _LL, _LL]
    lib.nmf_pgm_wide_scratch_floats.restype = _LL
    lib.nmf_pgm_wide.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                                 _I, _I, _I, _LL, _LL, _P, _P, _P, _P, _P,
                                 _P, _P]
    lib.nmf_pgm_wide.restype = _I


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


def _declare_adaprox_wide(lib):
    lib.nmf_adaprox_wide_partials_width.argtypes = [_I, _I, _I]
    lib.nmf_adaprox_wide_partials_width.restype = _I
    lib.nmf_adaprox_wide_partials_rows.argtypes = [_LL, _LL]
    lib.nmf_adaprox_wide_partials_rows.restype = _LL
    lib.nmf_adaprox_wide.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _F, _P, _I,
        _I, _P, _P, _I, _I, _I, _I, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P]
    lib.nmf_adaprox_wide.restype = _I


def _declare_grad(lib):
    lib.nmf_grad_scratch_floats.argtypes = [_I, _I, _LL, _LL]
    lib.nmf_grad_scratch_floats.restype = _LL
    lib.nmf_grad_f32.argtypes = [_P, _P, _P, _P, _I, _I, _LL, _LL,
                                 _P, _P, _P, _P, _P, _P]
    lib.nmf_grad_f32.restype = _I


register("nmf_pgm_step", _declare_pgm_step)
register("nmf_pgm_wide", _declare_pgm_wide)
register("nmf_adaprox_step", _declare_adaprox_step)
register("nmf_adaprox_wide", _declare_adaprox_wide)
# the very-wide tier's instances of the same source, in two libraries of
# their own (the residual modes past K = 32 up to KWIDE_K, and the rest) so
# that the three parts compile side by side
register("nmf_adaprox_kwide", _declare_adaprox_wide,
         source="nmf_adaprox_wide", defines=("K_WIDE",))
register("nmf_adaprox_vwide", _declare_adaprox_wide,
         source="nmf_adaprox_wide", defines=("VERY_WIDE",))
register("nmf_grad", _declare_grad)


# --------------------------------------------------------------------------
# prox_S as the kernels apply it

# The compiled chain's codes (csrc/prox_chain.cuh); a code with _RELATIVE
# multiplies its threshold by the step.
(_ID, _ZERO, _PLUS, _MIN, _MAX, _HARD, _SOFT, _UNITY) = range(8)
_RELATIVE = 16
#: Codes in one compiled chain at most; a longer one takes the split path.
MAX_CHAIN = 8
_THRESHOLD_OPS = {
    operators.prox_min: (_MIN,),
    operators.prox_max: (_MAX,),
    operators.prox_hard: (_HARD,),
    operators.prox_hard_plus: (_HARD, _PLUS),
    operators.prox_soft: (_SOFT,),
    operators.prox_soft_plus: (_SOFT, _PLUS),
}
_FIXED_OPS = {
    operators.prox_id: (),
    operators.prox_zero: (_ZERO,),
    operators.prox_plus: (_PLUS,),
}
_UNITY_OPS = {
    operators.prox_unity: (_UNITY,),
    operators.prox_unity_plus: (_PLUS, _UNITY),
}
# a code back to the library operator whose arithmetic it is (a
# registered op's chain on CPU tensors, where only the codes are known)
_CODE_OPS = {_ZERO: operators.prox_zero, _PLUS: operators.prox_plus,
             _MIN: operators.prox_min, _MAX: operators.prox_max,
             _HARD: operators.prox_hard, _SOFT: operators.prox_soft}


def _chain_of(prox):
    """The codes and thresholds ``[(code, thresh), ...]`` of ``prox`` in the
    order it applies them, or None when no chain computes it: one level of
    ``functools.partial`` is unwrapped; a threshold must be a Python number
    (a NumPy or tensor threshold promotes as the operator's own dtype rule
    says, which float32 codes would not); unity only along axis 0 (the K
    values of a pixel column)."""
    if isinstance(prox, operators.AlternatingProjections):
        if type(prox.repeat) is not int:
            return None
        chain = []
        for member in prox.operators[::-1]:
            sub = _chain_of(member)
            if sub is None:
                return None
            chain += sub
        return chain * max(prox.repeat, 0)
    kw = {}
    if isinstance(prox, functools.partial):
        if prox.args:
            return None
        kw = dict(prox.keywords)
        prox = prox.func
    try:
        if prox in _FIXED_OPS:
            return None if kw else [(c, 0.0) for c in _FIXED_OPS[prox]]
        if prox in _UNITY_OPS:
            if set(kw) - {"axis"} or kw.get("axis", 0) != 0:
                return None
            return [(c, 0.0) for c in _UNITY_OPS[prox]]
        if prox in _THRESHOLD_OPS:
            thresh = kw.pop("thresh", 0)
            kind = kw.pop("type", "relative")
            if (kw or type(thresh) not in (bool, int, float)
                    or kind not in ("relative", "absolute")):
                return None
            rel = _RELATIVE if kind == "relative" else 0
            return [(_PLUS, 0.0) if c == _PLUS else (c | rel, float(thresh))
                    for c in _THRESHOLD_OPS[prox]]
    except TypeError:  # an unhashable callable
        return None
    return None


class ProxDescriptor:
    """``prox_S`` as the fused kernels apply it: a compiled chain of codes
    (``ops``, ``thresh``, ``repeat``; csrc/prox_chain.cuh), or the split
    path (``ops`` None), where a first pass stores the pre-prox iterate, the
    prox runs in PyTorch on the whole (K, N) array and a second pass sums
    the Gram (K1) or the row sums (K2) of its output. Calling it applies
    the prox itself (the plain versions' route), or, for a registered op's
    codes, the library operators the codes stand for."""

    __slots__ = ("prox", "ops", "thresh", "repeat", "_c")

    def __init__(self, prox, chain=None, repeat=1):
        self.prox = prox
        if chain is None or len(chain) > MAX_CHAIN:
            self.ops = self.thresh = None
        else:
            self.ops = tuple(int(c) for c, _ in chain)
            self.thresh = tuple(float(t) for _, t in chain)
        self.repeat = int(repeat)
        self._c = None

    @classmethod
    def from_codes(cls, ops, thresh, repeat):
        """The descriptor of a registered op's arguments."""
        return cls(None, list(zip(ops, thresh)), repeat)

    @property
    def split(self):
        return self.ops is None

    @property
    def builtin(self):
        """True for the identity and non-negativity, the chains the narrow
        kernels run inline."""
        return self.repeat >= 1 and self.ops in ((), (_PLUS,))

    def c_args(self):
        """``(n_ops, repeat, ops, thresh)`` for the kernels' C entries."""
        if self._c is None:
            n = len(self.ops)
            self._c = (n, self.repeat, (ctypes.c_int * max(n, 1))(*self.ops),
                       (ctypes.c_float * max(n, 1))(*self.thresh))
        return self._c

    def op_args(self):
        """``(ops, thresh, repeat)`` as a registered op takes them."""
        return list(self.ops), list(self.thresh), self.repeat

    def __call__(self, X, step):
        if self.prox is not None:
            return self.prox(X, step)
        for _ in range(self.repeat):
            for op, t in zip(self.ops, self.thresh):
                code = op & (_RELATIVE - 1)
                if code == _UNITY:
                    X = operators.prox_unity(X, step, axis=0)
                elif code in (_MIN, _MAX, _HARD, _SOFT):
                    X = _CODE_OPS[code](
                        X, step, thresh=t,
                        type="relative" if op & _RELATIVE else "absolute")
                elif code != _ID:
                    X = _CODE_OPS[code](X, step)
        return X


def describe_prox(prox_S, kernel="pgm", separable="auto"):
    """``prox_S`` as a :class:`ProxDescriptor` (a descriptor passes
    through). None is non-negativity, the kernels' default. Library
    operators that act on a pixel column alone (prox_id, prox_zero,
    prox_plus, prox_min, prox_max, prox_hard, prox_hard_plus, prox_soft and
    prox_soft_plus with a scalar threshold, prox_unity and prox_unity_plus
    along axis 0, an ``AlternatingProjections`` of these) compile to a
    chain; everything else takes the split path. For K2 (``kernel=
    "adaprox"``) a chain is used only where ``separable_when`` holds for
    ``prox_S`` or ``separable`` is True, as in the JAX package; the split
    path applies the same prox with the same per-element step."""
    if isinstance(prox_S, ProxDescriptor):
        return prox_S
    if prox_S is None:
        return ProxDescriptor(operators.prox_plus, [(_PLUS, 0.0)])
    if kernel == "adaprox" and separable is not True:
        if not separable_blocks((prox_S,), (True,), separable or False)[0]:
            return ProxDescriptor(prox_S)
    if isinstance(prox_S, operators.AlternatingProjections):
        if type(prox_S.repeat) is not int:
            return ProxDescriptor(prox_S)
        once = operators.AlternatingProjections(prox_S.operators)
        chain = _chain_of(once)
        return ProxDescriptor(prox_S, chain, max(prox_S.repeat, 0))
    return ProxDescriptor(prox_S, _chain_of(prox_S))


def tier(C, K):
    """The instances that serve a (C, K) problem on the card: ``"narrow"``
    (C <= 16, K <= 8), ``"wide"`` (C <= 256, K <= 32) or ``"very wide"``
    (any larger C or K). K1 and K2 take the narrow tier only for the chains
    their narrow bodies run (K1 any, K2 the identity and non-negativity);
    their split passes run on the wide or very-wide body."""
    if C <= _NARROW_C and K <= _NARROW_K:
        return "narrow"
    return "wide" if C <= WIDE_C and K <= WIDE_K else "very wide"


def _store_of(S):
    return torch.bfloat16 if S.dtype == torch.bfloat16 else torch.float32


# --------------------------------------------------------------------------
# K1

def _pgm_pass1_reference(A, S, Y, sS, W=None):
    """K1's first pass as tensor ops: ``(X, gA, loss)`` with the pre-prox
    ``X = S - sS A^T D``, ``gA = D S^T`` and ``loss = D.R / 2``; a bfloat16
    S is the bfloat16 store (the residual takes A rounded to bfloat16)."""
    f32 = torch.float32
    bf16 = S.dtype == torch.bfloat16
    A, S, Y = A.to(f32), S.to(f32), Y.to(f32)
    sS = torch.as_tensor(sS, dtype=f32, device=S.device)
    A_r = A.to(torch.bfloat16).to(f32) if bf16 else A
    R = A_r @ S - Y
    D = R if W is None else W.to(f32) * R
    return S - sS * (A.T @ D), D @ S.T, torch.sum(D * R) / 2


def _pgm_pass2_reference(S, P, store):
    """K1's second pass as tensor ops: ``(S', Gram, dS_sq, nS_sq)`` of the
    prox's output P stored in ``store``, the Gram and the norms of the
    stored S' against the old S."""
    f32 = torch.float32
    S_out = P.to(store)
    S_new = S_out.to(f32)
    dS = S_new - S.to(f32)
    return (S_out, S_new @ S_new.T, torch.sum(dS * dS),
            torch.sum(S_new * S_new))


def fused_nmf_pgm_step_reference(A, S, Y, sS, W=None, prox_S=None):
    """Plain PyTorch version of :func:`fused_nmf_pgm_step` (float32 tensor
    ops, any device): the two passes of the split path around
    ``prox_S`` (a callable, None for non-negativity, or a
    :class:`ProxDescriptor`, whose chain runs as its library operators), the
    prox on the whole (K, N) array. A bfloat16 S is the bfloat16 store: the
    residual takes A rounded to bfloat16, S' comes back rounded to bfloat16,
    and the Gram and the statistics use the rounded S'."""
    X, gA, loss = _pgm_pass1_reference(A, S, Y, sS, W=W)
    step = torch.as_tensor(sS, dtype=torch.float32, device=X.device)
    S_out, SSt, d_sq, n_sq = _pgm_pass2_reference(
        S, describe_prox(prox_S)(X, step), _store_of(S))
    return gA, S_out, SSt, loss, d_sq, n_sq


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


def _pgm_checks(A, S, Y, W, tile_n):
    """K1's operand checks on CUDA tensors; returns ``(C, K, N, narrow)``."""
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
    return C, K, N, tier(C, K) == "narrow"


def _device_step(sS, device):
    if isinstance(sS, torch.Tensor):
        return sS.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), float(sS), dtype=torch.float32, device=device)


def _launched(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _scratch(floats, what, device):
    """The kernel's scratch buffer of ``floats`` float32 values, allocated
    by ``torch.empty`` (the kernels allocate nothing)."""
    if floats < 0:
        raise ValueError(f"{what}: no scratch layout for these shapes")
    return torch.empty((floats,), dtype=torch.float32, device=device)


def _pgm_wide_cuda(mode, A, S, Y, W, step, P, plan, tile_n, S_new, pre,
                   gA, gram, stats):
    """One launch of K1's wide body (mode 0 the chain, 1 split pass 1, 2
    split pass 2) into the given outputs; counts it. The scratch holds the
    rows of partial sums and, where ``csrc/panel_pass.cuh`` runs the pass
    (KWIDE_K < K <= PANEL_K), the residual D of C x N float32 values too:
    224 MB at (224, 498, 250 000), 1.7 GB at (425, 498, 1e6)."""
    C, K = A.shape
    K_, N = S.shape
    lib = _library("nmf_pgm_wide")
    partials = _scratch(
        lib.nmf_pgm_wide_scratch_floats(mode, C, K, N, tile_n),
        "fused_nmf_pgm_step", S.device)
    n_ops, repeat, ops, thresh = (plan.c_args() if mode == 0
                                  else (0, 0, None, None))
    ptr = [None if t is None else t.data_ptr()
           for t in (A, S, Y, W, step, P, S_new, pre, gA, gram)]
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        rc = lib.nmf_pgm_wide(
            mode, *ptr[:6], n_ops, repeat, ops, thresh,
            int(S.dtype == torch.bfloat16), C, K, N, tile_n, *ptr[6:],
            stats, partials.data_ptr(), stream)
    route = _PGM_ROUTES[mode] if mode else _wide_route(C, K)
    _launched(rc, f"fused_nmf_pgm_step ({route})")
    fused_nmf_pgm_step.route_launches[route] += 1
    if mode != 2:  # the launch that starts a step, in a program too
        fused_nmf_pgm_step.launches += 1


_PGM_ROUTES = ("wide", "split pass 1", "split pass 2")


def _wide_route(C, K):
    """The route a compiled-chain step on the wide or very-wide body counts
    in (K2 takes the wide body at narrow shapes for the chains its narrow
    body does not run)."""
    return "very wide" if tier(C, K) == "very wide" else "wide"


def _pgm_step_cuda(A, S, Y, sS, W, plan, tile_n):
    """K1 on CUDA tensors for a compiled chain: checks, allocation, the
    narrow, wide or very-wide instance, the count. Returns ``(gA, S_new, SSt,
    stats)`` with ``stats`` the (3,) float32 ``[loss, dS_sq, nS_sq]``."""
    C, K, N, narrow = _pgm_checks(A, S, Y, W, tile_n)
    device = A.device
    step = _device_step(sS, device)
    tile_n = int(tile_n)
    f32 = torch.float32
    S_new = torch.empty_like(S)
    gA = torch.empty((C, K), dtype=f32, device=device)
    SSt = torch.empty((K, K), dtype=f32, device=device)
    stats = torch.empty((3,), dtype=f32, device=device)
    if not narrow:
        _pgm_wide_cuda(0, A, S, Y, W, step, None, plan, tile_n, S_new, None,
                       gA, SSt, stats.data_ptr())
        return gA, S_new, SSt, stats
    lib = _library("nmf_pgm_step")
    width = lib.nmf_pgm_step_partials_width(C, K)
    partials = torch.empty((lib.nmf_pgm_step_partials_rows(N, tile_n), width),
                           dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.nmf_pgm_step(
            A.data_ptr(), S.data_ptr(), Y.data_ptr(),
            None if W is None else W.data_ptr(), step.data_ptr(),
            *plan.c_args(), int(S.dtype == torch.bfloat16), C, K, N, tile_n,
            S_new.data_ptr(), gA.data_ptr(),
            SSt.data_ptr(), stats.data_ptr(), partials.data_ptr(), stream)
    _launched(rc, "fused_nmf_pgm_step")
    fused_nmf_pgm_step.launches += 1
    fused_nmf_pgm_step.route_launches["narrow"] += 1
    return gA, S_new, SSt, stats


def _pgm_pass1_cuda(A, S, Y, sS, W, tile_n):
    """Split pass 1 on CUDA tensors: ``(X, gA, stats)``, X the pre-prox
    (K, N) float32 and stats a (3,) buffer with the loss in place."""
    C, K, N, _ = _pgm_checks(A, S, Y, W, tile_n)
    device, f32 = A.device, torch.float32
    X = torch.empty((K, N), dtype=f32, device=device)
    gA = torch.empty((C, K), dtype=f32, device=device)
    stats = torch.empty((3,), dtype=f32, device=device)
    _pgm_wide_cuda(1, A, S, Y, W, _device_step(sS, device), None, None,
                   int(tile_n), None, X, gA, None, stats.data_ptr())
    return X, gA, stats


def _pgm_pass2_cuda(S, P, tile_n, stats=None, copy=False):
    """Split pass 2 on CUDA tensors: ``(S_new, SSt, stats)`` from the
    prox's output P; S_new is P itself with the float32 store unless
    ``copy``; the norms go to ``stats[1:]`` (a new (3,) buffer if None)."""
    K, N = S.shape
    device, f32 = S.device, torch.float32
    _check_operand("P", P, (K, N), device)
    SSt = torch.empty((K, K), dtype=f32, device=device)
    if stats is None:
        stats = torch.empty((3,), dtype=f32, device=device)
    bf16 = S.dtype == torch.bfloat16
    S_new = torch.empty_like(S) if (bf16 or copy) else P
    A_dummy = torch.empty((1, K), dtype=f32, device=device)
    _pgm_wide_cuda(2, A_dummy, S, None, None, None, P, None, int(tile_n),
                   S_new if (bf16 or copy) else None, None, None, SSt,
                   stats.data_ptr() + 4)
    return S_new, SSt, stats


def _pgm_split_cuda(A, S, Y, sS, W, plan, tile_n):
    """K1's split path on CUDA tensors: pass 1, ``prox_S`` in PyTorch on
    the whole pre-prox iterate, pass 2. Returns ``(gA, S_new, SSt,
    stats)``."""
    X, gA, stats = _pgm_pass1_cuda(A, S, Y, sS, W, tile_n)
    step = (sS.to(device=A.device, dtype=torch.float32).reshape(())
            if isinstance(sS, torch.Tensor)
            else torch.full((), float(sS), dtype=torch.float32,
                            device=A.device))
    P = plan(X, step).to(torch.float32).contiguous()
    S_new, SSt, stats = _pgm_pass2_cuda(S, P, tile_n, stats)
    return gA, S_new, SSt, stats


@torch.library.custom_op("proxmin_torch::fused_nmf_pgm_step",
                         mutates_args=())
def fused_nmf_pgm_step_op(
        A: torch.Tensor, S: torch.Tensor, Y: torch.Tensor, sS: torch.Tensor,
        W: Optional[torch.Tensor], prox_ops: list[int],
        prox_thresh: list[float], prox_repeat: int, tile_n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 as a registered op: :func:`fused_nmf_pgm_step` with ``prox_S`` as
    its compiled chain (codes, thresholds, repeat) and the three
    statistics in one (3,) tensor ``[loss, dS_sq, nS_sq]``."""
    plan = ProxDescriptor.from_codes(prox_ops, prox_thresh, prox_repeat)
    if A.device.type == "cpu":
        gA, S_new, SSt, loss, d_sq, n_sq = fused_nmf_pgm_step_reference(
            A, S, Y, sS, W=W, prox_S=plan)
        return gA, S_new, SSt, torch.stack([loss, d_sq, n_sq])
    return _pgm_step_cuda(A, S, Y, sS, W, plan, tile_n)


@fused_nmf_pgm_step_op.register_fake
def _(A, S, Y, sS, W, prox_ops, prox_thresh, prox_repeat, tile_n):
    C, K = A.shape
    f32 = torch.float32
    return (A.new_empty((C, K), dtype=f32), torch.empty_like(S),
            A.new_empty((K, K), dtype=f32), A.new_empty((3,), dtype=f32))


@torch.library.custom_op("proxmin_torch::fused_nmf_pgm_pass1",
                         mutates_args=())
def fused_nmf_pgm_pass1_op(
        A: torch.Tensor, S: torch.Tensor, Y: torch.Tensor, sS: torch.Tensor,
        W: Optional[torch.Tensor], tile_n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's split pass 1 as a registered op: ``(X, gA, loss)`` with the
    pre-prox X (K, N) float32 and the loss 0-d."""
    if A.device.type == "cpu":
        return _pgm_pass1_reference(A, S, Y, sS, W=W)
    X, gA, stats = _pgm_pass1_cuda(A, S, Y, sS, W, tile_n)
    return X, gA, stats[0].clone()


@fused_nmf_pgm_pass1_op.register_fake
def _(A, S, Y, sS, W, tile_n):
    C, K = A.shape
    f32 = torch.float32
    return (S.new_empty(S.shape, dtype=f32), A.new_empty((C, K), dtype=f32),
            A.new_empty((), dtype=f32))


@torch.library.custom_op("proxmin_torch::fused_nmf_pgm_pass2",
                         mutates_args=())
def fused_nmf_pgm_pass2_op(
        S: torch.Tensor, P: torch.Tensor, tile_n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's split pass 2 as a registered op: ``(S_new, SSt, norms)`` from
    the prox's output P, norms the (2,) ``[dS_sq, nS_sq]``."""
    if S.device.type == "cpu":
        S_out, SSt, d_sq, n_sq = _pgm_pass2_reference(S, P, _store_of(S))
        # an op's output may not alias its input
        S_out = S_out.clone() if S_out is P else S_out
        return S_out, SSt, torch.stack([d_sq, n_sq])
    S_new, SSt, stats = _pgm_pass2_cuda(S, P.to(torch.float32).contiguous(),
                                        tile_n, copy=True)
    return S_new, SSt, stats[1:].clone()


@fused_nmf_pgm_pass2_op.register_fake
def _(S, P, tile_n):
    K = S.shape[0]
    f32 = torch.float32
    return (torch.empty_like(S), S.new_empty((K, K), dtype=f32),
            S.new_empty((2,), dtype=f32))


def fused_nmf_pgm_step(A, S, Y, sS, W=None, prox_S=None,
                       tile_n=DEFAULT_TILE_N):
    """One fused PGM-NMF S-side step.

    Args:
        A: (C, K) float32. S: (K, N), Y, W: (C, N) (W optional), all
            float32 or all bfloat16 (the store; compute stays float32).
            All contiguous, on one device.
        sS: the S step size, a float or a one-element tensor (kept on the
            device, so no host sync).
        prox_S: any prox callable, None for non-negativity, or a
            :class:`ProxDescriptor`. A library operator that acts on a
            pixel column alone runs compiled in the kernel; anything else
            takes the split path (two kernel passes around the prox in
            PyTorch on the whole (K, N) iterate).
        tile_n: pixel columns per tile; it fixes the summation order.

    Returns:
        ``(gA, S_new, SSt, loss, dS_sq, nS_sq)``: ``gA = D S^T`` with the old
        S, the proxed ``S_new`` in S's dtype, ``SSt = S_new S_new^T``, the
        loss at the old iterate and the fixed-point norms
        ``||S_new - S||^2``, ``||S_new||^2`` (0-d tensors), all float32 but
        ``S_new``; with the bfloat16 store the Gram and the norms are those
        of the rounded ``S_new``.

    CPU tensors go to :func:`fused_nmf_pgm_step_reference`. CUDA tensors
    launch the kernels (building them on first use) on the current stream
    without synchronizing, for any C >= 1 and K >= 1 (:func:`tier`); each
    step adds one to ``fused_nmf_pgm_step.launches`` (counted at the launch
    that starts it: the narrow, wide or very-wide step, or split pass 1, in
    a program as well) and each launch one to its route in
    ``fused_nmf_pgm_step.route_launches`` (``narrow``, ``wide``,
    ``very wide``, ``split pass 1``, ``split pass 2``; the split passes
    run on the wide body up to C = 256, K = 32, on the very-wide one
    beyond). While a program is captured, the
    call is the registered op :func:`fused_nmf_pgm_step_op`, or on the
    split path the two pass ops around the traced prox.
    """
    plan = describe_prox(prox_S)
    if tracing(A, S):
        if not isinstance(sS, torch.Tensor):
            sS = torch.full((), float(sS), dtype=torch.float32,
                            device=A.device)
        if plan.split:
            X, gA, loss = fused_nmf_pgm_pass1_op(A, S, Y, sS, W, int(tile_n))
            P = plan(X, sS.to(torch.float32).reshape(())).to(torch.float32)
            S_new, SSt, norms = fused_nmf_pgm_pass2_op(S, P, int(tile_n))
            return gA, S_new, SSt, loss, norms[0], norms[1]
        gA, S_new, SSt, stats = fused_nmf_pgm_step_op(
            A, S, Y, sS, W, *plan.op_args(), int(tile_n))
        return gA, S_new, SSt, stats[0], stats[1], stats[2]
    if A.device.type == "cpu":
        return fused_nmf_pgm_step_reference(A, S, Y, sS, W=W, prox_S=plan)
    route = _pgm_split_cuda if plan.split else _pgm_step_cuda
    gA, S_new, SSt, stats = route(A, S, Y, sS, W, plan, tile_n)
    return gA, S_new, SSt, stats[0], stats[1], stats[2]


fused_nmf_pgm_step.launches = 0
fused_nmf_pgm_step.route_launches = dict.fromkeys(
    ("narrow", "wide", "very wide") + _PGM_ROUTES[1:], 0)


# --------------------------------------------------------------------------
# K2

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


def _adaprox_pass1_reference(A, S, M, V, Y, alpha_S, scalars, W=None,
                             b2=0.999, eps=1e-8):
    """K2's first pass as tensor ops: ``(S1, step, M', V', gA, loss)``
    with the pre-prox ``S1 = S - alpha Phi / Psi_safe`` and the step
    ``alpha / Psi_safe`` (both float32), the moments in their dtype."""
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
    return (S - alpha * (Phi / Psi_safe), alpha / Psi_safe, M1.to(M.dtype),
            V1.to(V.dtype), D @ S.T, torch.sum(D * R) / 2)


def _adaprox_pass2_reference(S, P, store):
    """K2's second pass as tensor ops: ``(S', rowsum, dS_sq, nS_sq)`` of
    the prox's output P stored in ``store``."""
    f32 = torch.float32
    S_out = P.to(store)
    S1 = S_out.to(f32)
    dS = S1 - S.to(f32)
    return (S_out, torch.sum(S1, dim=1, keepdim=True), torch.sum(dS * dS),
            torch.sum(S1 * S1))


def fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha_S, scalars,
                                     W=None, prox_S=None, b2=0.999,
                                     eps=1e-8):
    """Plain PyTorch version of :func:`fused_nmf_adaprox_step` (float32
    tensor ops, any device): the two passes of the split path around
    ``prox_S`` (a callable, None for non-negativity, or a
    :class:`ProxDescriptor`) with the per-element step ``alpha / Psi_safe``.
    M and V keep their dtype (float32 or bfloat16). A bfloat16 S is the
    bfloat16 store, rounded where the TPU kernel rounds it: the residual
    takes A rounded to bfloat16, S' comes back rounded to bfloat16, and the
    row sums and the statistics use the rounded S'."""
    S1, step, M1, V1, gA, loss = _adaprox_pass1_reference(
        A, S, M, V, Y, alpha_S, scalars, W=W, b2=b2, eps=eps)
    plan = describe_prox(prox_S, "adaprox", True)
    S_out, rowsum, d_sq, n_sq = _adaprox_pass2_reference(
        S, plan(S1, step), _store_of(S))
    return gA, S_out, M1, V1, rowsum, loss, d_sq, n_sq


def _adaprox_checks(A, S, M, V, Y, alpha_S, scalars, W, tile_n):
    """K2's operand checks on CUDA tensors; returns ``(C, K, N, alpha,
    narrow)``."""
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
    if isinstance(scalars, torch.Tensor):
        _check_operand("scalars", scalars, (3,), device)
    if N < 1 or int(tile_n) < 1:
        raise ValueError(f"need N >= 1 and tile_n >= 1, got N={N}, "
                         f"tile_n={tile_n}")
    return C, K, N, alpha, tier(C, K) == "narrow"


_ADAPROX_ROUTES = ("wide", "split pass 1", "split pass 2")


def _adaprox_library(mode, C, K):
    """The library of ``csrc/nmf_adaprox_wide.cu`` that holds K2's instance
    for ``mode`` (0 the chain, 1 split pass 1, 2 split pass 2) at (C, K)."""
    if mode != 2 and WIDE_K < K <= KWIDE_K:
        return "nmf_adaprox_kwide"
    return ("nmf_adaprox_vwide" if tier(C, K) == "very wide"
            else "nmf_adaprox_wide")


def _adaprox_wide_cuda(mode, A, S, M, V, Y, W, alpha, scalars, b2, eps, P,
                       plan, tile_n, S_new, M_new, V_new, pre, pre_step, gA,
                       rowsum, stats, count=True):
    """One launch of K2's wide or very-wide body (mode 0 the chain, 1 split
    pass 1, 2 split pass 2) into the given outputs; counts it in K2's
    counters unless ``count`` is False (K5 counts its own)."""
    C, K = A.shape
    N = S.shape[1]
    lib = _library(_adaprox_library(mode, C, K))
    partials = torch.empty(
        (lib.nmf_adaprox_wide_partials_rows(N, tile_n),
         lib.nmf_adaprox_wide_partials_width(mode, C, K)),
        dtype=torch.float32, device=S.device)
    n_ops, repeat, ops, thresh = (plan.c_args() if mode == 0
                                  else (0, 0, None, None))
    on_card = isinstance(scalars, torch.Tensor)
    if mode == 2:
        sc = (0.0,) * 6
    else:
        b1_t, bc1, bc2 = ((0.0,) * 3 if on_card else
                          _adaprox_scalars(scalars, b2, eps)[:3])
        sc = (float(b1_t), float(bc1), float(bc2), float(np.float32(1.0 - b2)),
              float(np.float32(b2)), float(np.float32(eps)))
    ptr = [None if t is None else t.data_ptr()
           for t in (A, S, M, V, Y, W, alpha,
                     scalars if on_card else None)]
    outs = [None if t is None else t.data_ptr()
            for t in (S_new, M_new, V_new, pre, pre_step, gA, rowsum)]
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        rc = lib.nmf_adaprox_wide(
            mode, *ptr, *sc, None if P is None else P.data_ptr(), n_ops,
            repeat, ops, thresh, int(S.dtype == torch.bfloat16),
            int(M is not None and M.dtype == torch.bfloat16), C, K, N,
            tile_n, *outs, stats, partials.data_ptr(), stream)
    route = _ADAPROX_ROUTES[mode] if mode else _wide_route(C, K)
    _launched(rc, f"fused_nmf_adaprox_step ({route})")
    if not count:
        return
    fused_nmf_adaprox_step.route_launches[route] += 1
    if mode != 2:  # the launch that starts a step, in a program too
        fused_nmf_adaprox_step.launches += 1
        if on_card:
            fused_nmf_adaprox_step.device_scalar_launches += 1


def _adaprox_step_cuda(A, S, M, V, Y, alpha_S, scalars, W, plan, b2,
                       eps, tile_n, out=None, count=True):
    """K2 on CUDA tensors for a compiled chain: checks, allocation, the
    narrow instance (the identity and non-negativity, C <= 16, K <= 8) or
    the wide or very-wide one, the count. ``scalars`` by value (three
    host numbers) or as a (3,) float32 tensor on the card (the
    device-scalar entry). ``out``: ``(S_new, M_new, V_new)`` to write
    into (K5's packed blocks), new tensors if None; ``count`` False leaves
    K2's counters alone. Returns ``(gA, S_new, M_new, V_new, rowsum,
    stats)`` with ``stats`` the (3,) float32 ``[loss, dS_sq, nS_sq]``."""
    C, K, N, alpha, narrow = _adaprox_checks(A, S, M, V, Y, alpha_S,
                                             scalars, W, tile_n)
    device = A.device
    tile_n = int(tile_n)
    f32 = torch.float32
    S_new, M_new, V_new = out or (torch.empty_like(S), torch.empty_like(M),
                                  torch.empty_like(V))
    gA = torch.empty((C, K), dtype=f32, device=device)
    rowsum = torch.empty((K, 1), dtype=f32, device=device)
    stats = torch.empty((3,), dtype=f32, device=device)
    on_card = isinstance(scalars, torch.Tensor)
    if not (narrow and plan.builtin):
        # the narrow instances apply max(., 0) or the identity inline; any
        # other chain runs on the wide body, which holds all K values of x
        # and of the step a column
        _adaprox_wide_cuda(0, A, S, M, V, Y, W, alpha, scalars, b2, eps,
                           None, plan, tile_n, S_new, M_new, V_new, None,
                           None, gA, rowsum, stats.data_ptr(), count)
        return gA, S_new, M_new, V_new, rowsum, stats
    lib = _library("nmf_adaprox_step")
    width = lib.nmf_adaprox_step_partials_width(C, K)
    n_blocks = -(-N // tile_n)
    partials = torch.empty((n_blocks, width), dtype=f32, device=device)
    # the kernel forms 1 - b1_t itself
    omb2, b2_, eps_ = (np.float32(1.0 - b2), np.float32(b2),
                       np.float32(eps))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        head = (A.data_ptr(), S.data_ptr(), M.data_ptr(), V.data_ptr(),
                Y.data_ptr(), None if W is None else W.data_ptr(),
                alpha.data_ptr())
        tail = (float(omb2), float(b2_), float(eps_), int(plan.ops == (_PLUS,)),
                int(S.dtype == torch.bfloat16),
                int(M.dtype == torch.bfloat16), C, K, N, tile_n,
                S_new.data_ptr(), M_new.data_ptr(), V_new.data_ptr(),
                gA.data_ptr(), rowsum.data_ptr(), stats.data_ptr(),
                partials.data_ptr(), stream)
        if on_card:
            rc = lib.nmf_adaprox_step_dev(*head, scalars.data_ptr(), *tail)
        else:
            b1_t, bc1, bc2 = _adaprox_scalars(scalars, b2, eps)[:3]
            rc = lib.nmf_adaprox_step(*head, float(b1_t), float(bc1),
                                      float(bc2), *tail)
    _launched(rc, "fused_nmf_adaprox_step")
    if count:
        fused_nmf_adaprox_step.launches += 1
        fused_nmf_adaprox_step.route_launches["narrow"] += 1
        if on_card:
            fused_nmf_adaprox_step.device_scalar_launches += 1
    return gA, S_new, M_new, V_new, rowsum, stats


def _adaprox_pass1_cuda(A, S, M, V, Y, alpha_S, scalars, W, b2, eps,
                        tile_n):
    """Split pass 1 on CUDA tensors: ``(X, step, M_new, V_new, gA,
    stats)``, X and step (K, N) float32, stats a (3,) buffer with the loss
    in place."""
    C, K, N, alpha, _ = _adaprox_checks(A, S, M, V, Y, alpha_S, scalars, W,
                                        tile_n)
    device, f32 = A.device, torch.float32
    X = torch.empty((K, N), dtype=f32, device=device)
    step = torch.empty_like(X)
    M_new = torch.empty_like(M)
    V_new = torch.empty_like(V)
    gA = torch.empty((C, K), dtype=f32, device=device)
    stats = torch.empty((3,), dtype=f32, device=device)
    _adaprox_wide_cuda(1, A, S, M, V, Y, W, alpha, scalars, b2, eps, None,
                       None, int(tile_n), None, M_new, V_new, X, step, gA,
                       None, stats.data_ptr())
    return X, step, M_new, V_new, gA, stats


def _adaprox_pass2_cuda(S, P, tile_n, stats=None, copy=False):
    """Split pass 2 on CUDA tensors: ``(S_new, rowsum, stats)`` from the
    prox's output P; S_new is P itself with the float32 store unless
    ``copy``; the norms go to ``stats[1:]``."""
    K, N = S.shape
    device, f32 = S.device, torch.float32
    _check_operand("P", P, (K, N), device)
    rowsum = torch.empty((K, 1), dtype=f32, device=device)
    if stats is None:
        stats = torch.empty((3,), dtype=f32, device=device)
    bf16 = S.dtype == torch.bfloat16
    S_new = torch.empty_like(S) if (bf16 or copy) else P
    A_dummy = torch.empty((1, K), dtype=f32, device=device)
    _adaprox_wide_cuda(2, A_dummy, S, None, None, None, None, None, None,
                       0.999, 1e-8, P, None, int(tile_n),
                       S_new if (bf16 or copy) else None, None, None, None,
                       None, None, rowsum, stats.data_ptr() + 4)
    return S_new, rowsum, stats


def _adaprox_split_cuda(A, S, M, V, Y, alpha_S, scalars, W, plan, b2, eps,
                        tile_n):
    """K2's split path on CUDA tensors: pass 1, ``prox_S(X, alpha /
    Psi_safe)`` in PyTorch on the whole arrays, pass 2."""
    X, step, M_new, V_new, gA, stats = _adaprox_pass1_cuda(
        A, S, M, V, Y, alpha_S, scalars, W, b2, eps, tile_n)
    P = plan(X, step).to(torch.float32).contiguous()
    S_new, rowsum, stats = _adaprox_pass2_cuda(S, P, tile_n, stats)
    return gA, S_new, M_new, V_new, rowsum, stats


@torch.library.custom_op("proxmin_torch::fused_nmf_adaprox_step",
                         mutates_args=())
def fused_nmf_adaprox_step_op(
        A: torch.Tensor, S: torch.Tensor, M: torch.Tensor, V: torch.Tensor,
        Y: torch.Tensor, alpha_S: torch.Tensor, scalars: torch.Tensor,
        W: Optional[torch.Tensor], prox_ops: list[int],
        prox_thresh: list[float], prox_repeat: int, b2: float, eps: float,
        tile_n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    """K2 as a registered op: :func:`fused_nmf_adaprox_step` with the
    scalars ``(b1_t, bc1, bc2)`` as a (3,) float32 tensor on the operands'
    device (the kernel's device-scalar entry), ``prox_S`` as its compiled
    chain and the three statistics in one (3,) tensor."""
    plan = ProxDescriptor.from_codes(prox_ops, prox_thresh, prox_repeat)
    if A.device.type == "cpu":
        gA, S1, M1, V1, rowsum, loss, d_sq, n_sq = (
            fused_nmf_adaprox_step_reference(
                A, S, M, V, Y, alpha_S, scalars, W=W, prox_S=plan, b2=b2,
                eps=eps))
        return gA, S1, M1, V1, rowsum, torch.stack([loss, d_sq, n_sq])
    return _adaprox_step_cuda(A, S, M, V, Y, alpha_S, scalars, W, plan, b2,
                              eps, tile_n)


@fused_nmf_adaprox_step_op.register_fake
def _(A, S, M, V, Y, alpha_S, scalars, W, prox_ops, prox_thresh,
      prox_repeat, b2, eps, tile_n):
    C, K = A.shape
    f32 = torch.float32
    return (A.new_empty((C, K), dtype=f32), torch.empty_like(S),
            torch.empty_like(M), torch.empty_like(V),
            A.new_empty((K, 1), dtype=f32), A.new_empty((3,), dtype=f32))


@torch.library.custom_op("proxmin_torch::fused_nmf_adaprox_pass1",
                         mutates_args=())
def fused_nmf_adaprox_pass1_op(
        A: torch.Tensor, S: torch.Tensor, M: torch.Tensor, V: torch.Tensor,
        Y: torch.Tensor, alpha_S: torch.Tensor, scalars: torch.Tensor,
        W: Optional[torch.Tensor], b2: float, eps: float, tile_n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    """K2's split pass 1 as a registered op: ``(X, step, M_new, V_new, gA,
    loss)`` with the pre-prox X and the step ``alpha / Psi_safe`` (K, N)
    float32."""
    if A.device.type == "cpu":
        return _adaprox_pass1_reference(A, S, M, V, Y, alpha_S, scalars,
                                        W=W, b2=b2, eps=eps)
    X, step, M1, V1, gA, stats = _adaprox_pass1_cuda(
        A, S, M, V, Y, alpha_S, scalars, W, b2, eps, tile_n)
    return X, step, M1, V1, gA, stats[0].clone()


@fused_nmf_adaprox_pass1_op.register_fake
def _(A, S, M, V, Y, alpha_S, scalars, W, b2, eps, tile_n):
    C, K = A.shape
    f32 = torch.float32
    return (S.new_empty(S.shape, dtype=f32), S.new_empty(S.shape, dtype=f32),
            torch.empty_like(M), torch.empty_like(V),
            A.new_empty((C, K), dtype=f32), A.new_empty((), dtype=f32))


@torch.library.custom_op("proxmin_torch::fused_nmf_adaprox_pass2",
                         mutates_args=())
def fused_nmf_adaprox_pass2_op(
        S: torch.Tensor, P: torch.Tensor, tile_n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's split pass 2 as a registered op: ``(S_new, rowsum, norms)``
    from the prox's output P, norms the (2,) ``[dS_sq, nS_sq]``."""
    if S.device.type == "cpu":
        S_out, rowsum, d_sq, n_sq = _adaprox_pass2_reference(S, P,
                                                             _store_of(S))
        # an op's output may not alias its input
        S_out = S_out.clone() if S_out is P else S_out
        return S_out, rowsum, torch.stack([d_sq, n_sq])
    S_new, rowsum, stats = _adaprox_pass2_cuda(
        S, P.to(torch.float32).contiguous(), tile_n, copy=True)
    return S_new, rowsum, stats[1:].clone()


@fused_nmf_adaprox_pass2_op.register_fake
def _(S, P, tile_n):
    K = S.shape[0]
    f32 = torch.float32
    return (torch.empty_like(S), S.new_empty((K, 1), dtype=f32),
            S.new_empty((2,), dtype=f32))


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
        prox_S: a separable prox callable applied with the per-element
            step ``alpha / Psi_safe``, None for non-negativity, or a
            :class:`ProxDescriptor`. A library operator whose
            ``separable_when`` holds runs compiled in the kernel;
            anything else takes the split path (two kernel passes around
            the prox in PyTorch on the whole (K, N) arrays).
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
    tensors launch the kernels (building them on first use) on the current
    stream without synchronizing, for any C >= 1 and K >= 1 (:func:`tier`);
    each step adds one to ``fused_nmf_adaprox_step.launches`` (counted at
    the launch that starts it, as for K1), each launch one to its route in
    ``fused_nmf_adaprox_step.route_launches`` (as K1's), and a step through the
    device-scalar entry one to
    ``fused_nmf_adaprox_step.device_scalar_launches``. While a program is
    captured, the call is the registered op
    :func:`fused_nmf_adaprox_step_op`, or the two pass ops around the
    traced prox (the scalars must then be a tensor).
    """
    plan = describe_prox(prox_S, "adaprox")
    if tracing(A, S):
        if plan.split:
            X, step, M1, V1, gA, loss = fused_nmf_adaprox_pass1_op(
                A, S, M, V, Y, alpha_S, scalars, W, float(b2), float(eps),
                int(tile_n))
            P = plan(X, step).to(torch.float32)
            S1, rowsum, norms = fused_nmf_adaprox_pass2_op(S, P, int(tile_n))
            return gA, S1, M1, V1, rowsum, loss, norms[0], norms[1]
        gA, S1, M1, V1, rowsum, stats = fused_nmf_adaprox_step_op(
            A, S, M, V, Y, alpha_S, scalars, W, *plan.op_args(), float(b2),
            float(eps), int(tile_n))
        return gA, S1, M1, V1, rowsum, stats[0], stats[1], stats[2]
    if A.device.type == "cpu":
        return fused_nmf_adaprox_step_reference(
            A, S, M, V, Y, alpha_S, scalars, W=W, prox_S=plan, b2=b2,
            eps=eps)
    route = _adaprox_split_cuda if plan.split else _adaprox_step_cuda
    gA, S1, M1, V1, rowsum, stats = route(
        A, S, M, V, Y, alpha_S, scalars, W, plan, b2, eps, tile_n)
    return gA, S1, M1, V1, rowsum, stats[0], stats[1], stats[2]


fused_nmf_adaprox_step.launches = 0
fused_nmf_adaprox_step.device_scalar_launches = 0
fused_nmf_adaprox_step.route_launches = dict.fromkeys(
    ("narrow", "wide", "very wide") + _ADAPROX_ROUTES[1:], 0)


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
    the CUDA kernel (``csrc/nmf_grad.cu``, built on first use; any C >= 1,
    K >= 1: the narrow instances up to C = 16, K = 8, the wide body up to
    C = 256, K = 32, the very-wide body beyond, :func:`tier`) on the
    current stream without synchronizing; each launch adds one to
    ``fused_nmf_grad.launches`` and one to its route in
    ``fused_nmf_grad.route_launches``. While a program is captured, the
    call is the registered op :func:`fused_nmf_grad_op`.
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
    launch, the count. Returns ``(gA, gS, SSt, loss)``. The scratch holds,
    where ``csrc/panel_pass.cuh`` runs the pass (KWIDE_K < K <= PANEL_K),
    the residual D of C x N float32 values: 224 MB at (224, 498,
    250 000)."""
    device = A.device
    if device.type != "cuda":
        raise ValueError(f"fused_nmf_grad runs on CPU or CUDA tensors, got "
                         f"{device}")
    C, K = A.shape
    N = S.shape[1]
    route = tier(C, K)
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
    tile_n = int(tile_n)
    gA = torch.empty((C, K), dtype=f32, device=device)
    gS = torch.empty((K, N), dtype=f32, device=device)
    SSt = torch.empty((K, K), dtype=f32, device=device)
    loss = torch.empty((), dtype=f32, device=device)
    partials = _scratch(lib.nmf_grad_scratch_floats(C, K, N, tile_n),
                        "fused_nmf_grad", device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.nmf_grad_f32(
            A.data_ptr(), S.data_ptr(), Y.data_ptr(),
            None if W is None else W.data_ptr(), C, K, N, tile_n,
            gA.data_ptr(), gS.data_ptr(), SSt.data_ptr(), loss.data_ptr(),
            partials.data_ptr(), stream)
    _launched(rc, "fused_nmf_grad")
    fused_nmf_grad.launches += 1
    fused_nmf_grad.route_launches[route] += 1
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
fused_nmf_grad.route_launches = {"narrow": 0, "wide": 0, "very wide": 0}
