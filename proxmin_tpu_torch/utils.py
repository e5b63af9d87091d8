"""Numerics core of the port: norms, the fixed-point test, the FISTA
momentum recursion, the stepper protocol and the strided step refresh.

Counterparts of the same names in :mod:`proxmin_tpu.utils`. Everything
here works on tensors and returns tensors, so a solve on the card keeps
its scalars on the card.

Stepper protocol (shared with the JAX package)::

    init_state(X, G)            -> state (may be ())
    __call__(state, X, it, G)   -> (steps_tuple, new_state)
"""

import inspect

import numpy as np
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
    "grow_stride",
    "StridedStepper",
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


def grow_stride(stride, old_steps, new_steps, budget, max_stride,
                first=False):
    """The refresh interval after a strided refresh, as a Python int.

    Counterpart of :func:`proxmin_tpu.utils.grow_stride` (the reference
    ``ApproximateCache`` growth rule plus a shrink-back branch). The drift
    is the largest relative change over the step leaves,
    ``max|new - old| / max(max|old|, tiny)`` in float32:

    * ``0 < drift < budget``: grow by ``max(1, floor(budget / drift *
      stride))``, capped at ``max_stride``;
    * ``drift > budget``: halve (floor 1);
    * otherwise, or when ``first`` (the first refresh, whose all-zero
      ``old_steps`` give a meaningless drift): keep ``stride``.

    ``old_steps`` / ``new_steps`` are matching tuples of tensors (or
    numbers). The drift is read from the device once, here; the rest is
    float32 and int arithmetic on the host, as the JAX rule computes it.
    """
    stride = int(stride)
    if first:
        return stride
    f32 = torch.float32
    tiny = torch.finfo(f32).tiny
    drifts = []
    for o, n in zip(_as_tuple(old_steps), _as_tuple(new_steps)):
        o = torch.as_tensor(o).to(f32)
        n = torch.as_tensor(n).to(device=o.device, dtype=f32)
        drifts.append(torch.max(torch.abs(n - o))
                      / torch.clamp_min(torch.max(torch.abs(o)), tiny))
    drift = np.float32(torch.stack(drifts).max().item())
    budget = np.float32(budget)
    if 0 < drift < budget:
        bump = np.floor(budget / max(drift, np.float32(tiny))
                        * np.float32(stride))
        return int(min(max_stride, stride + max(1, min(bump, max_stride))))
    if drift > budget:
        return max(1, stride // 2)
    return stride


class StridedStepper:
    """Recompute a step function only every ``stride`` iterations, with the
    cached steps shrunk by ``safety`` (< 1) against the Lipschitz constant
    growing between refreshes; ``adapt=True`` grows or shrinks the
    interval with :func:`grow_stride` (budget ``(1 - safety) / 2``, capped
    at ``max_stride``).

    Counterpart of :class:`proxmin_tpu.utils.StridedStepper`, with its
    state layout ``(inner, cached, [stride], next_refresh)`` so that JAX
    states convert (``interop.state_from_numpy``). The JAX ``lax.cond`` on
    the next-refresh clock is a Python ``if`` here: the clock and the
    stride are host integers, and a refresh reads the device once (the
    drift, with ``adapt``). ``cached`` is empty until the first refresh
    (the JAX package fills it with zeros of the steps' shapes, which only
    a call of the inner stepper would tell).

    The pgm driver's segmented mode (refresh outside the inner loop) is
    the same host loop here, so the segmented-mode hooks
    (``segmentable``, ``segment_refresh``, ``state_stride``,
    ``state_steps``, ``segment_end``) serve the tests and callers that
    drive segments themselves.
    """

    def __init__(self, step, n_blocks, stride=10, safety=0.9, adapt=False,
                 max_stride=100):
        self.inner = make_stepper(step, n_blocks)
        self.n_blocks = n_blocks
        self.stride = int(stride)
        self.safety = float(safety)
        self.adapt = bool(adapt)
        self.max_stride = int(max_stride)

    def init_state(self, X, G):
        inner0 = self.inner.init_state(X, G)
        if self.adapt:
            return (inner0, (), self.stride, 0)
        return (inner0, (), 0)

    def _refresh(self, state, X, it, G):
        if self.adapt:
            inner_state, cached_old, stride, _ = state
        else:
            inner_state, cached_old = state[0], state[1]
        steps, new_inner = self.inner(inner_state, X, it, G)
        steps = tuple(torch.as_tensor(s) * self.safety for s in steps)
        if not self.adapt:
            return (new_inner, steps, it + self.stride)
        if not cached_old:
            cached_old = tuple(torch.zeros_like(s) for s in steps)
        stride_new = grow_stride(stride, cached_old, steps,
                                 (1.0 - self.safety) / 2, self.max_stride,
                                 first=(it == 0))
        return (new_inner, steps, stride_new, it + stride_new)

    def __call__(self, state, X, it, G):
        if it >= state[-1]:
            state = self._refresh(state, X, it, G)
        return state[1], state

    @property
    def segmentable(self):
        """Whether the refresh may run before the iteration's gradient
        exists (the inner stepper does not take ``grads``)."""
        if isinstance(self.inner, ConstantStepper):
            return True
        if isinstance(self.inner, FunctionStepper):
            return not self.inner.wants_grads
        return False

    def segment_refresh(self, state, X, it):
        """Refresh the cached steps at a segment boundary; returns
        ``(steps, state)``."""
        state = self._refresh(state, X, it, None)
        return state[1], state

    def state_stride(self, state):
        """The refresh interval in the state (adaptive steppers only)."""
        if not self.adapt:
            raise ValueError("only an adaptive StridedStepper carries its "
                             "stride")
        return state[2]

    def state_steps(self, state):
        """The cached steps in the state."""
        return state[1]

    def segment_end(self, state, it):
        """The global iteration of the next refresh: ``it + stride`` after
        a refresh at ``it``, or wherever a resumed schedule says (``it``
        itself when a solve stopped exactly on a refresh boundary)."""
        return state[-1]
