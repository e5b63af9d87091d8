"""Build and load the port's CUDA kernels.

Each kernel source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library of its own with a plain C interface, at first use,
under ``build/kernels/`` of the checkout (named by the source and a hash of
its text, of every header in ``csrc/`` and of the flags), and loaded with
``ctypes``. A kernel module registers its source with :func:`register`,
together with a function that declares the library's C signatures (several
modules may declare entry points of one source; a source may be built into
two libraries with different preprocessor definitions, each with part of
its instances, so that the halves compile side by side); nothing is
compiled or loaded at import.
"""

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["register", "build_kernel", "build_kernels", "tracing"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: Kernel name -> its source; each builds into a library of its own.
_SOURCES = {}
#: Kernel name -> the ``declare(lib)`` functions that set its C signatures.
_DECLARE = {}
#: Kernel name -> the preprocessor definitions its source is compiled with.
_DEFINES = {}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def register(name, declare, source=None, defines=()):
    """Register ``csrc/<source or name>.cu``, compiled with ``-D`` of each
    of ``defines``, as the kernel library ``name``; ``declare(lib)`` sets C
    signatures of it once it is loaded."""
    _SOURCES[name] = CSRC / f"{source or name}.cu"
    _DEFINES[name] = tuple(defines)
    _DECLARE.setdefault(name, []).append(declare)


def _flags(name):
    return (*_NVCC_FLAGS, *(f"-D{d}" for d in _DEFINES.get(name, ())))


def _nvcc():
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).is_file():
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, $PATH and "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built")
    return found


def _library_path(name):
    """The library of ``name`` for the source, the headers and the flags as
    they are now. Every ``csrc/*.cuh`` is hashed, included or not, so an
    edited header never leaves a stale library in use."""
    h = hashlib.sha256(_SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return _BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_kernel(name="nmf_pgm_step"):
    """Compile ``csrc/<name>.cu`` unless the library for this exact source
    is already built. Returns ``(path, seconds, compiler_log)``;
    ``seconds`` is 0.0 and the log is the stored one when nothing was
    compiled. Raises ``RuntimeError`` when ``nvcc`` fails."""
    lib = _library_path(name)
    log_path = lib.with_suffix(".log")
    if lib.is_file():
        return lib, 0.0, log_path.read_text() if log_path.is_file() else ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(_SOURCES[name])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n"
                           f"{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, seconds, log


def build_kernels(names=None):
    """Build several kernel sources at once (by default every registered
    one), one ``nvcc`` each, all started together. Returns
    ``{name: (path, seconds, compiler_log)}`` and raises the first build's
    error."""
    names = tuple(_SOURCES) if names is None else tuple(names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(build_kernel, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


@functools.cache
def _library(name):
    """The loaded library of kernel ``name`` with its C signatures
    declared (built on first use)."""
    lib = ctypes.CDLL(str(build_kernel(name)[0]))
    for declare in _DECLARE[name]:
        declare(lib)
    return lib



def tracing(*tensors):
    """True while a program is being captured (``torch.export`` or
    ``torch.compile``) or any of ``tensors`` is a fake tensor: a wrapper then
    calls its registered op, which the capture records, instead of
    launching through ``ctypes`` on a pointer that does not exist."""
    import torch

    return torch.compiler.is_compiling() or any(
        isinstance(t, torch._subclasses.FakeTensor) for t in tensors)
