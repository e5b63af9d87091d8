"""K1, the fused PGM-NMF step: its CUDA kernel, build, binding and plain
version.

:func:`fused_nmf_pgm_step` is the counterpart of
``proxmin_tpu.ops.nmf_kernels.fused_nmf_pgm_step``: one S-side PGM-NMF
iteration in one pass over the pixel columns (residual, both factor
gradients, the proxed S update, the next iteration's ``S' S'^T`` Gram and
the fixed-point statistics). On CUDA tensors it launches the hand-written
kernel in ``csrc/nmf_pgm_step.cu``; on CPU tensors it runs
:func:`fused_nmf_pgm_step_reference`, the same math as tensor ops.

Unlike the TPU kernel, it takes unpadded ``(C, K)``, ``(K, N)`` and
``(C, N)`` tensors: there is no sublane/lane padding, no VMEM tile model
and no ``dims`` argument.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, under ``build/kernels/`` of the
checkout (named by a hash of the source and flags), and loaded with
``ctypes``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .. import operators

__all__ = [
    "fused_nmf_pgm_step",
    "fused_nmf_pgm_step_reference",
    "build_kernel",
    "DEFAULT_TILE_N",
]

#: Pixel columns per CUDA block (256 threads, 16 columns each).
DEFAULT_TILE_N = 4096

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "nmf_pgm_step.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc():
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).is_file():
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, $PATH and "
            "/usr/local/cuda/bin): the K1 CUDA kernel cannot be built")
    return found


def _library_path():
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"nmf_pgm_step-{digest[:16]}.so"


def build_kernel():
    """Compile ``csrc/nmf_pgm_step.cu`` unless the library for this exact
    source is already built. Returns ``(path, seconds, compiler_log)``;
    ``seconds`` is 0.0 and the log is the stored one when nothing was
    compiled. Raises ``RuntimeError`` when ``nvcc`` fails."""
    lib = _library_path()
    log_path = lib.with_suffix(".log")
    if lib.is_file():
        return lib, 0.0, log_path.read_text() if log_path.is_file() else ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, seconds, log


@functools.cache
def _library():
    """The loaded kernel library with its C signatures declared (built on
    first use)."""
    lib = ctypes.CDLL(str(build_kernel()[0]))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nmf_pgm_step_partials_width.argtypes = [i, i]
    lib.nmf_pgm_step_partials_width.restype = i
    lib.nmf_pgm_step_f32.argtypes = [p, p, p, p, p, i, i, i, ll, ll,
                                     p, p, p, p, p, p]
    lib.nmf_pgm_step_f32.restype = i
    return lib


def _nonneg(X):
    return torch.maximum(X, X.new_zeros(()))


def _prox_flag(prox_S):
    """The kernel's builtin prox for ``prox_S``: 1 = non-negativity (None or
    ``prox_plus``), 0 = identity (``prox_id``). Anything else raises: the
    CUDA kernel cannot call a Python prox."""
    if prox_S is None or prox_S is operators.prox_plus:
        return 1
    if prox_S is operators.prox_id:
        return 0
    raise ValueError(
        "the CUDA fused_nmf_pgm_step applies prox_S in the kernel and "
        "supports only prox_plus (or None) and prox_id; got "
        f"{prox_S!r}. Use engine='torch' for other S constraints.")


def fused_nmf_pgm_step_reference(A, S, Y, sS, W=None, prox_S=None):
    """Plain PyTorch version of :func:`fused_nmf_pgm_step` (float32 tensor
    ops, any device). ``prox_S`` may be any prox callable here; None means
    non-negativity."""
    f32 = torch.float32
    A, S, Y = A.to(f32), S.to(f32), Y.to(f32)
    sS = torch.as_tensor(sS, dtype=f32, device=S.device)
    R = A @ S - Y
    D = R if W is None else W.to(f32) * R
    gS = A.T @ D
    X = S - sS * gS
    if prox_S is None or prox_S is operators.prox_plus:
        S_new = _nonneg(X)
    else:
        S_new = prox_S(X, sS)
    dS = S_new - S
    return (D @ S.T, S_new, S_new @ S_new.T, torch.sum(D * R) / 2,
            torch.sum(dS * dS), torch.sum(S_new * S_new))


def _check_operand(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, A is on {device}: all "
                         "operands of fused_nmf_pgm_step share one device")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def fused_nmf_pgm_step(A, S, Y, sS, W=None, prox_S=None,
                       tile_n=DEFAULT_TILE_N):
    """One fused PGM-NMF S-side step.

    Args:
        A: (C, K) float32. S: (K, N) float32. Y, W: (C, N) float32 (W
            optional). All contiguous, on one device.
        sS: the S step size, a float or a one-element tensor (kept on the
            device, so no host sync).
        prox_S: None or ``prox_plus`` (non-negativity), or ``prox_id``.
        tile_n: pixel columns per CUDA block; it fixes the summation order.

    Returns:
        ``(gA, S_new, SSt, loss, dS_sq, nS_sq)``: ``gA = D S^T`` with the old
        S, the proxed ``S_new``, ``SSt = S_new S_new^T``, the loss at the old
        iterate and the fixed-point norms ``||S_new - S||^2``,
        ``||S_new||^2`` (0-d tensors).

    CPU tensors go to :func:`fused_nmf_pgm_step_reference`. CUDA tensors
    launch the kernel (building it on first use) on the current stream
    without synchronizing, or raise; each launch adds one to
    ``fused_nmf_pgm_step.launches``.
    """
    device = A.device
    if device.type == "cpu":
        return fused_nmf_pgm_step_reference(A, S, Y, sS, W=W, prox_S=prox_S)
    if device.type != "cuda":
        raise ValueError(f"fused_nmf_pgm_step runs on CPU or CUDA tensors, "
                         f"got {device}")
    prox_plus = _prox_flag(prox_S)
    C, K = A.shape
    N = S.shape[1]
    _check_operand("A", A, (C, K), device)
    _check_operand("S", S, (K, N), device)
    _check_operand("Y", Y, (C, N), device)
    if W is not None:
        _check_operand("W", W, (C, N), device)
    if N < 1 or int(tile_n) < 1:
        raise ValueError(f"need N >= 1 and tile_n >= 1, got N={N}, "
                         f"tile_n={tile_n}")
    lib = _library()
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
    n_blocks = -(-N // tile_n)
    S_new = torch.empty_like(S)
    gA = torch.empty((C, K), dtype=torch.float32, device=device)
    SSt = torch.empty((K, K), dtype=torch.float32, device=device)
    stats = torch.empty((3,), dtype=torch.float32, device=device)
    partials = torch.empty((n_blocks, width), dtype=torch.float32,
                           device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.nmf_pgm_step_f32(
            A.data_ptr(), S.data_ptr(), Y.data_ptr(),
            None if W is None else W.data_ptr(), step.data_ptr(),
            prox_plus, C, K, N, tile_n, S_new.data_ptr(), gA.data_ptr(),
            SSt.data_ptr(), stats.data_ptr(), partials.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_nmf_pgm_step launch failed: CUDA error "
                           f"{rc}")
    fused_nmf_pgm_step.launches += 1
    return gA, S_new, SSt, stats[0], stats[1], stats[2]


fused_nmf_pgm_step.launches = 0
