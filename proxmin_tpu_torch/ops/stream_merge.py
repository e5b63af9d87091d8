"""K5: the packed-state AdaProx step of the stream-merge experiment.

Counterpart of ``benchmarks/stream_merge.py`` (``packed_step`` and
``build_loops``): K2's unweighted S-side proximal-Adam iteration with the
prox ``max(., 0)``, on a layout that merges the pixel-axis arrays:

* ``smv``: one (3K, N) float32 array ``[S; M; V]`` in and one out;
* ``mv``: S (K, N) float32 plus one (2K, N) bfloat16 array ``[M; V]``.

The experiment asks whether fewer, merged streams change K2's achieved
bandwidth at the same bytes. For C, K <= 8 the CUDA kernel is K2's narrow
body (``csrc/nmf_adaprox_step.cu``) with the layout as a template
parameter, so a packed step equals K2's bit for bit on the same inputs and
a timing compares the layouts alone. Beyond, as the TPU kernel takes any
(Cp, Kp), it runs K2's own step (the narrow body up to C = 16, K = 8, the
wide or very-wide body beyond, ``ops.nmf_kernels.tier``; the prox
``max(., 0)``) on the packed arrays' row blocks, each a contiguous (K, N)
array, and writes into the packed outputs' blocks: again K2's bits.
Unlike the TPU kernel it takes unpadded blocks: the row offsets are K and
2K.

On CUDA tensors :func:`packed_step` launches the kernel (building it on
first use) or raises; on CPU tensors it runs :func:`packed_step_reference`.
"""

import ctypes

import numpy as np
import torch

from ._build import _library, register
from .nmf_kernels import (DEFAULT_TILE_N, _adaprox_scalars,
                          _adaprox_step_cuda, _check_operand, describe_prox,
                          fused_nmf_adaprox_step,
                          fused_nmf_adaprox_step_reference, tier)

__all__ = ["packed_step", "packed_step_reference", "build_loops"]

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)


def _declare_packed_step(lib):
    lib.nmf_packed_step.argtypes = [_P, _P, _P, _P, _P, _F, _F, _F, _F, _F,
                                    _F, _I, _I, _LL, _LL, _P, _P, _P, _P, _P,
                                    _P, _P]
    lib.nmf_packed_step.restype = _I


register("nmf_adaprox_step", _declare_packed_step)


def _unpack(SMV_or_S, MV, K):
    """S, M and V as views of the packed arrays."""
    if MV is None:
        return SMV_or_S[:K], SMV_or_S[K:2 * K], SMV_or_S[2 * K:]
    return SMV_or_S, MV[:K], MV[K:]


def packed_step_reference(A, SMV_or_S, Y, alpha, scalars, MV=None, b2=0.999,
                          eps=1e-8):
    """Plain PyTorch version of :func:`packed_step`: K2's plain version on
    views of the packed arrays, its results packed again."""
    S, M, V = _unpack(SMV_or_S, MV, A.shape[1])
    gA, S1, M1, V1, rowsum, loss, dS_sq, nS_sq = (
        fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha, scalars,
                                         b2=b2, eps=eps))
    stats = torch.stack([loss, dS_sq, nS_sq])
    if MV is None:
        return gA, torch.cat([S1, M1, V1]), rowsum, stats
    return gA, S1, torch.cat([M1, V1]), rowsum, stats


def packed_step(A, SMV_or_S, Y, alpha, scalars, MV=None, b2=0.999, eps=1e-8,
                tile_n=DEFAULT_TILE_N):
    """One packed-state AdaProx S-side step (K5).

    Args:
        A: (C, K) float32, any C >= 1 and K >= 1. Y: (C, N) float32.
        SMV_or_S: with ``MV=None`` the ``smv`` layout, (3K, N) float32 rows
            ``[S; M; V]``; else S (K, N) float32 and ``MV`` (2K, N)
            bfloat16 rows ``[M; V]``. All contiguous, on one device.
        alpha: the per-row step, K float32 values ((K, 1) or (K,)).
        scalars: ``(b1_t, 1/(1 - b1_t^t), 1/(1 - b2^t))`` as host numbers
            (they reach the kernel by value).
        b2, eps, tile_n: as :func:`fused_nmf_adaprox_step`.

    Returns:
        ``smv``: ``(gA, SMV_new, rowsum, stats)``; ``mv``: ``(gA, S_new,
        MV_new, rowsum, stats)``, with ``gA = R S^T`` (R = A S - Y, the old
        S), ``rowsum = S_new.sum(1)`` as (K, 1) and ``stats = [sum(R^2) / 2,
        ||S_new - S||^2, ||S_new||^2]``.

    Each step on the card adds one to ``packed_step.launches`` and one to
    its route in ``packed_step.route_launches``: ``packed`` (C, K <= 8, the
    packed kernel), else K2's instance that ran, ``narrow``, ``wide`` or
    ``very wide`` (:func:`tier`).
    """
    device = A.device
    if device.type == "cpu":
        return packed_step_reference(A, SMV_or_S, Y, alpha, scalars, MV=MV,
                                     b2=b2, eps=eps)
    if device.type != "cuda":
        raise ValueError(f"packed_step runs on CPU or CUDA tensors, got "
                         f"{device}")
    C, K = A.shape
    N = SMV_or_S.shape[1]
    f32 = torch.float32
    _check_operand("A", A, (C, K), device)
    _check_operand("Y", Y, (C, N), device)
    if MV is None:
        _check_operand("SMV", SMV_or_S, (3 * K, N), device)
    else:
        _check_operand("S", SMV_or_S, (K, N), device)
        _check_operand("MV", MV, (2 * K, N), device, torch.bfloat16)
    alpha = alpha.reshape(-1)
    _check_operand("alpha", alpha, (K,), device)
    if N < 1 or int(tile_n) < 1:
        raise ValueError(f"need N >= 1 and tile_n >= 1, got N={N}, "
                         f"tile_n={tile_n}")
    tile_n = int(tile_n)
    if not (C <= 8 and K <= 8):
        return _packed_wide(A, SMV_or_S, Y, alpha, scalars, MV, b2, eps,
                            tile_n)
    lib = _library("nmf_adaprox_step")
    width = lib.nmf_adaprox_step_partials_width(C, K)
    n_blocks = -(-N // tile_n)
    SMV_new = torch.empty_like(SMV_or_S)
    MV_new = None if MV is None else torch.empty_like(MV)
    gA = torch.empty((C, K), dtype=f32, device=device)
    rowsum = torch.empty((K, 1), dtype=f32, device=device)
    stats = torch.empty((3,), dtype=f32, device=device)
    partials = torch.empty((n_blocks, width), dtype=f32, device=device)
    b1_t, bc1, bc2, _, omb2, b2_, eps_ = _adaprox_scalars(scalars, b2, eps)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.nmf_packed_step(
            A.data_ptr(), SMV_or_S.data_ptr(),
            None if MV is None else MV.data_ptr(), Y.data_ptr(),
            alpha.data_ptr(), float(b1_t), float(bc1), float(bc2),
            float(omb2), float(b2_), float(eps_), C, K, N, tile_n,
            SMV_new.data_ptr(), None if MV is None else MV_new.data_ptr(),
            gA.data_ptr(), rowsum.data_ptr(), stats.data_ptr(),
            partials.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"packed_step launch failed: CUDA error {rc}")
    packed_step.launches += 1
    packed_step.route_launches["packed"] += 1
    if MV is None:
        return gA, SMV_new, rowsum, stats
    return gA, SMV_new, MV_new, rowsum, stats


_PLUS = describe_prox(None)


def _packed_wide(A, SMV_or_S, Y, alpha, scalars, MV, b2, eps, tile_n):
    """K5 beyond C, K <= 8 on CUDA tensors of checked shapes: K2's own step
    (one launch of the instance its shape takes) on the row blocks of the
    packed arrays, writing the packed outputs' blocks."""
    C, K = A.shape
    SMV_new = torch.empty_like(SMV_or_S)
    MV_new = None if MV is None else torch.empty_like(MV)
    S, M, V = _unpack(SMV_or_S, MV, K)
    gA, _, _, _, rowsum, stats = _adaprox_step_cuda(
        A, S, M, V, Y, alpha, scalars, None, _PLUS, b2, eps, tile_n,
        out=_unpack(SMV_new, MV_new, K), count=False)
    packed_step.launches += 1
    packed_step.route_launches[tier(C, K)] += 1
    if MV is None:
        return gA, SMV_new, rowsum, stats
    return gA, SMV_new, MV_new, rowsum, stats


packed_step.launches = 0
packed_step.route_launches = dict.fromkeys(
    ("packed", "narrow", "wide", "very wide"), 0)


def build_loops(tile_n=DEFAULT_TILE_N):
    """The stream-merge experiment's S-side loops, ``(base, packed_smv,
    packed_mv)``: ``n`` iterations of K2 or K5 (unweighted, prox
    ``max(., 0)``, the fixed scalars ``(0.9, 1.2, 1.3)``), each returning
    the final state.

    * ``base(A, S, M, V, Y, alpha, n)`` -> ``(S, M, V)``: ``base_f32`` with
      float32 moments, ``base_bf16m`` with bfloat16 ones (K2);
    * ``packed_smv(A, SMV, Y, alpha, n)`` -> ``SMV`` (``packed_f32_smv``);
    * ``packed_mv(A, S, MV, Y, alpha, n)`` -> ``(S, MV)``
      (``packed_bf16m_mv``).
    """
    scalars = tuple(np.float32(v) for v in (0.9, 1.2, 1.3))

    def base(A, S, M, V, Y, alpha, n):
        for _ in range(n):
            _, S, M, V, *_ = fused_nmf_adaprox_step(A, S, M, V, Y, alpha,
                                                    scalars, tile_n=tile_n)
        return S, M, V

    def packed_smv(A, SMV, Y, alpha, n):
        for _ in range(n):
            SMV = packed_step(A, SMV, Y, alpha, scalars, tile_n=tile_n)[1]
        return SMV

    def packed_mv(A, S, MV, Y, alpha, n):
        for _ in range(n):
            _, S, MV, *_ = packed_step(A, S, Y, alpha, scalars, MV=MV,
                                       tile_n=tile_n)
        return S, MV

    return base, packed_smv, packed_mv
