"""Numerics core of the port: norms, the fixed-point test, the FISTA
momentum recursion and the stepper protocol.

Counterparts of the same names in :mod:`proxmin_tpu.utils`. Everything
here works on tensors and returns tensors, so a solve on the card keeps
its scalars on the card.

Stepper protocol (shared with the JAX package)::

    init_state(X, G)            -> state (may be ())
    __call__(state, X, it, G)   -> (steps_tuple, new_state)
"""

import inspect

import torch

__all__ = [
    "l2sq",
    "fixed_point_norms",
    "fixed_point_verdict",
    "fixed_point_converged",
    "nesterov_next",
    "ConstantStepper",
    "FunctionStepper",
    "make_stepper",
]


def _as_tuple(X):
    if type(X) in (list, tuple):
        return tuple(X)
    return (X,)


def l2sq(x):
    """Sum of the squared matrix elements."""
    return torch.sum(torch.square(x))


def fixed_point_norms(x, x_prev):
    """The two reductions of the fixed-point test,
    ``(||x - x_prev||^2, ||x||^2)``."""
    return l2sq(x - x_prev), l2sq(x)


def fixed_point_verdict(d_sq, n_sq, e_rel):
    """``(converged, finite)`` from precomputed fixed-point norms.

    Non-finite norms are never "converged" (``inf <= inf`` would pass on a
    diverging iterate); ``finite`` doubles as the divergence detector."""
    ok = d_sq <= (e_rel ** 2) * n_sq
    finite = torch.logical_and(torch.isfinite(d_sq), torch.isfinite(n_sq))
    return torch.logical_and(ok, finite), finite


def fixed_point_converged(x, x_prev, e_rel):
    """Per-block fixed-point test ``||x - x_prev||^2 <= e_rel^2 ||x||^2``,
    False on non-finite norms."""
    d_sq, n_sq = fixed_point_norms(x, x_prev)
    return fixed_point_verdict(d_sq, n_sq, e_rel)[0]


def nesterov_next(t):
    """One step of the FISTA momentum recursion:
    ``t' = (1 + sqrt(4 t^2 + 1)) / 2``, ``omega = (t - 1) / t'``.
    Returns ``(omega, t')``; ``t`` is a tensor scalar."""
    t_next = 0.5 * (1.0 + torch.sqrt(4.0 * t * t + 1.0))
    omega = (t - 1.0) / t_next
    return omega, t_next


class ConstantStepper:
    """Fixed step size(s), broadcast over blocks."""

    def __init__(self, value, n_blocks):
        value = _as_tuple(value)
        if len(value) == 1:
            value = value * n_blocks
        if len(value) != n_blocks:
            raise ValueError(
                f"got {len(value)} step sizes for {n_blocks} blocks")
        self.value = tuple(value)

    def init_state(self, X, G):
        return ()

    def __call__(self, state, X, it, G):
        return self.value, state


class FunctionStepper:
    """Adapts a user step callable ``step(*X, it=..., [grads=...])``; the
    ``grads`` keyword is passed when the signature names it or takes
    ``**kwargs``."""

    def __init__(self, fn, n_blocks):
        self.fn = fn
        self.n_blocks = n_blocks
        try:
            params = inspect.signature(fn).parameters.values()
            self.wants_grads = any(
                p.name == "grads" or p.kind == inspect.Parameter.VAR_KEYWORD
                for p in params
            )
        except (TypeError, ValueError):
            self.wants_grads = False

    def init_state(self, X, G):
        return ()

    def __call__(self, state, X, it, G):
        if self.wants_grads:
            S = self.fn(*X, it=it, grads=G)
        else:
            S = self.fn(*X, it=it)
        S = _as_tuple(S)
        if len(S) == 1:
            S = S * self.n_blocks
        return tuple(S), state


def make_stepper(step, n_blocks):
    """Coerce a float / tuple / callable / stepper object into the stepper
    protocol (any callable with ``init_state`` passes through)."""
    if hasattr(step, "init_state") and callable(step):
        return step
    if callable(step):
        return FunctionStepper(step, n_blocks)
    return ConstantStepper(step, n_blocks)
