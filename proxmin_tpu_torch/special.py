"""Special functions of the prox library.

Counterpart of :mod:`proxmin_tpu.special`. The max-entropy prox needs the
Lambert W function only as ``W(exp(t))`` for real ``t``; solving
``w + log(w) = t`` directly never forms ``exp(t)``, so it cannot overflow.
A fixed number of Newton steps keeps it a chain of elementwise tensor ops
with no data-dependent loop, so it runs on the card without host syncs.
"""

import torch

__all__ = ["lambertw_exp", "lambertw"]

_NEWTON_ITERS = 24


def _float_dtype(t):
    """The dtype the functions compute in: ``t``'s float dtype promoted to
    at least float32 (float32 for integer input)."""
    if t.is_floating_point():
        return torch.promote_types(t.dtype, torch.float32)
    return torch.float32


def _const(t, v):
    """The number ``v`` as a 0-d tensor beside ``t``, filled on the device:
    ``t.new_tensor(v)`` would copy it from host memory, which makes the host
    wait for the stream."""
    return torch.full((), v, dtype=t.dtype, device=t.device)


def lambertw_exp(t):
    """Principal-branch Lambert W of ``exp(t)`` for real ``t``: the
    ``w > 0`` with ``w + log(w) = t``.

    Starts from ``log1p(exp(t))`` (``t - log(t)`` past 30) and takes 24
    Newton steps on ``f(w) = w + log(w) - t``, which converge from there
    for every ``t``."""
    t = torch.as_tensor(t)
    t = t.to(_float_dtype(t))
    tiny = _const(t, torch.finfo(t.dtype).tiny)
    thirty, one = _const(t, 30.0), _const(t, 1.0)
    softplus = torch.where(t > 30.0, t,
                           torch.log1p(torch.exp(torch.minimum(t, thirty))))
    w = torch.where(t > 30.0, t - torch.log(torch.maximum(t, one)), softplus)
    w = torch.maximum(w, tiny)
    for _ in range(_NEWTON_ITERS):
        # w_next = w (1 + t - log w) / (1 + w)
        w = w * (1.0 + t - torch.log(w)) / (1.0 + w)
        w = torch.maximum(w, tiny)
    return w


def lambertw(z):
    """Principal-branch Lambert W for real ``z >= 0``: the ``w`` with
    ``w exp(w) = z`` (``scipy.special.lambertw(z).real`` there)."""
    z = torch.as_tensor(z)
    z = z.to(_float_dtype(z))
    safe = torch.maximum(z, _const(z, torch.finfo(z.dtype).tiny))
    w = lambertw_exp(torch.log(safe))
    return torch.where(z == 0, torch.zeros_like(w), w)
