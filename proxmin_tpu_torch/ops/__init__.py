"""Hand-written GPU kernels of the port, each beside its plain PyTorch
version. Kernels are built and loaded at first launch, never at import."""

from .nmf_kernels import (  # noqa: F401
    DEFAULT_TILE_N,
    build_kernel,
    build_kernels,
    fused_nmf_adaprox_step,
    fused_nmf_adaprox_step_reference,
    fused_nmf_pgm_step,
    fused_nmf_pgm_step_reference,
)

__all__ = [
    "fused_nmf_pgm_step",
    "fused_nmf_pgm_step_reference",
    "fused_nmf_adaprox_step",
    "fused_nmf_adaprox_step_reference",
    "build_kernel",
    "build_kernels",
    "DEFAULT_TILE_N",
]
