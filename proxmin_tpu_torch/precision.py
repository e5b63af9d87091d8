"""Float32 matmul policy for the port.

The JAX package's solvers trace under ``precision='highest'``
(``proxmin_tpu/precision.py``) because a one-pass reduced-precision
``A @ S`` puts a noise floor on the NMF residual that stalls the
fixed-point test; its "dot-default" kernel variant never converged
(``proxmin_tpu/ops/nmf_kernels.py:40-52``). TF32 is Hopper's one-pass
reduced format, so the port keeps every float32 product in full float32.
"""

import torch

__all__ = ["apply_f32_policy"]


def apply_f32_policy():
    """Disable TF32 for matmuls and cuDNN and ask for full-precision float32
    matmuls. Called once when :mod:`proxmin_tpu_torch` is imported."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
