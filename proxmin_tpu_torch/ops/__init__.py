"""Hand-written GPU kernels of the port, each beside its plain PyTorch
version. Kernels are built and loaded at first launch, never at import.

The public entry point mirrors ``proxmin_tpu.ops``: :func:`fused_nmf_grad`
(K3) and the prox kernels :func:`prox_plus_pallas`,
:func:`prox_soft_pallas`, :func:`prox_hard_pallas` and
:func:`prox_unity_pallas` (K4), opt-in gradients and proxes for the
solvers. The fused NMF steps K1 and K2 drive ``nmf(engine="cuda")``; K5
(:mod:`.stream_merge`, the packed-state variant of K2) drives the
stream-merge experiment's loops."""

from ._build import build_kernel, build_kernels  # noqa: F401
from .nmf_kernels import (  # noqa: F401
    DEFAULT_TILE_N,
    fused_nmf_adaprox_step,
    fused_nmf_adaprox_step_reference,
    fused_nmf_grad,
    fused_nmf_grad_reference,
    fused_nmf_pgm_step,
    fused_nmf_pgm_step_reference,
)
from .stream_merge import (  # noqa: F401
    build_loops,
    packed_step,
    packed_step_reference,
)
from .prox_kernels import (  # noqa: F401
    prox_hard_pallas,
    prox_hard_reference,
    prox_plus_pallas,
    prox_plus_reference,
    prox_soft_pallas,
    prox_soft_reference,
    prox_unity_pallas,
    prox_unity_reference,
)

__all__ = [
    "fused_nmf_grad",
    "prox_plus_pallas",
    "prox_soft_pallas",
    "prox_hard_pallas",
    "prox_unity_pallas",
    "fused_nmf_grad_reference",
    "prox_plus_reference",
    "prox_soft_reference",
    "prox_hard_reference",
    "prox_unity_reference",
    "fused_nmf_pgm_step",
    "fused_nmf_pgm_step_reference",
    "fused_nmf_adaprox_step",
    "fused_nmf_adaprox_step_reference",
    "packed_step",
    "packed_step_reference",
    "build_loops",
    "build_kernel",
    "build_kernels",
    "DEFAULT_TILE_N",
]
