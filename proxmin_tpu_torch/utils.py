"""Numerics core of the port: norms, the fixed-point test, the FISTA
momentum recursion, the stepper protocol (constant, callable,
Barzilai-Borwein and strided steps), the batched Lanczos bound, the ADMM
family's shared update and convergence test, and the host-side helpers
(callbacks, the profiler context, the warning summary, the approximate
cache).

Counterparts of the same names in :mod:`proxmin_tpu.utils`. The numerics
work on tensors and return tensors, so a solve on the card keeps its
scalars on the card.

Stepper protocol (shared with the JAX package)::

    init_state(X, G)            -> state (may be ())
    __call__(state, X, it, G)   -> (steps_tuple, new_state)
"""

import inspect
import logging
import math
import os
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

__all__ = [
    "l2sq",
    "l2",
    "tridiag_gershgorin_max",
    "batched_lanczos_max",
    "initZU",
    "get_step_g",
    "get_step_f",
    "do_the_mm",
    "update_variables",
    "get_variable_errors",
    "check_constraint_convergence",
    "fixed_point_norms",
    "fixed_point_verdict",
    "fixed_point_converged",
    "nesterov_next",
    "NesterovAccelerator",
    "ConstantStepper",
    "FunctionStepper",
    "BarzilaiBorweinStepper",
    "make_stepper",
    "grow_stride",
    "StridedStepper",
    "profile_trace",
    "summarize_convergence_warnings",
    "Traceback",
    "NullCallback",
    "ApproximateCache",
    "hasNotNone",
    "check_convergence",
]


def _as_tuple(X):
    if type(X) in (list, tuple):
        return tuple(X)
    return (X,)


def replicated_like(t, like):
    """``t``, a tensor the driver made itself, as a replicated ``DTensor``
    on ``like``'s mesh when ``like`` is one (every rank makes the same
    values), else ``t`` as it is."""
    if isinstance(like, DTensor) and not isinstance(t, DTensor):
        return DTensor.from_local(t, like.device_mesh,
                                  [Replicate()] * like.device_mesh.ndim,
                                  run_check=False)
    return t


def l2sq(x):
    """Sum of the squared matrix elements."""
    return torch.sum(torch.square(x))


def l2(x):
    """Square root of the sum of the squared matrix elements."""
    return torch.sqrt(torch.sum(torch.square(x)))


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


def _lanczos_tridiag(Hv, v0, k):
    """Batched Lanczos: the (B, k) diagonals and off-diagonals of the
    tridiagonal reductions of B implicit PSD operators. ``Hv: (B, K) ->
    (B, K)`` applies every batch member's operator to its row. For
    operators of rank r, ``k = r + 1`` steps give the exact nonzero
    spectrum. A breakdown (``beta = 0``) pads with zero rows, which only
    append zero eigenvalues; it is a ``torch.where``, never a host read."""
    B, _ = v0.shape
    dtype, device = v0.dtype, v0.device
    tiny = torch.finfo(dtype).tiny
    k = int(k)
    v_prev, v = torch.zeros_like(v0), v0
    beta = torch.zeros((B,), dtype=dtype, device=device)
    alphas = torch.zeros((B, k), dtype=dtype, device=device)
    betas = torch.zeros((B, k), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    for i in range(k):
        w = Hv(v) - beta[:, None] * v_prev
        alpha = torch.sum(v * w, dim=1)
        w = w - alpha[:, None] * v
        beta = torch.sqrt(torch.sum(w * w, dim=1))
        v_prev, v = v, torch.where(
            beta[:, None] > tiny,
            w / torch.clamp_min(beta[:, None], tiny), zero)
        alphas[:, i] = alpha
        betas[:, i] = beta
    return alphas, betas


def _gershgorin(alphas, betas):
    """Per-batch Gershgorin ``(lower, upper)`` bounds on the spectrum of
    symmetric tridiagonals."""
    B, k = alphas.shape
    absb = torch.abs(betas[:, : k - 1])
    pad = torch.zeros((B, 1), dtype=alphas.dtype, device=alphas.device)
    offl = torch.cat([pad, absb], dim=1)
    offr = torch.cat([absb, pad], dim=1)
    return (torch.amin(alphas - offl - offr, dim=1),
            torch.amax(alphas + offl + offr, dim=1))


def _tridiag_max_eig(alphas, betas, bisect_iters=50):
    """Largest eigenvalue of each symmetric tridiagonal (batched) by
    Sturm-sequence bisection: guaranteed convergence, no dependence on the
    spectral gap. ``bisect_iters`` x k Sturm steps of tensor ops on
    (B,)-vectors (about ``bisect_iters * (7 k + 4)`` launches), all on the
    device with no host read; for huge B use the candidate refinement of
    :func:`batched_lanczos_max`."""
    B, k = alphas.shape
    dtype = alphas.dtype
    tiny = torch.finfo(dtype).tiny
    b2 = torch.square(betas[:, : k - 1])
    lo, hi = _gershgorin(alphas, betas)
    neg_tiny = torch.full((), -tiny, dtype=dtype, device=alphas.device)

    def count_below(x):
        cnt = torch.zeros((B,), dtype=torch.int32, device=alphas.device)
        q = None
        for i in range(k):
            q_new = alphas[:, i] - x
            if i > 0:
                q_new = q_new - b2[:, i - 1] / q
            q = torch.where(torch.abs(q_new) < tiny, neg_tiny, q_new)
            cnt = cnt + (q < 0)
        return cnt

    for _ in range(int(bisect_iters)):
        mid = 0.5 * (lo + hi)
        all_below = count_below(mid) == k
        lo = torch.where(all_below, lo, mid)
        hi = torch.where(all_below, mid, hi)
    return torch.clamp_min(0.5 * (lo + hi), 0.0)


def tridiag_gershgorin_max(alphas, betas):
    """Per-batch Gershgorin upper bound on ``lambda_max`` of symmetric
    tridiagonals (one pass over the diagonal data)."""
    return _gershgorin(alphas, betas)[1]


def batched_lanczos_max(Hv, v0, num_iters, n_candidates=256):
    """``max_b lambda_max`` over B implicit PSD operators by batched
    Lanczos and a refinement of the top candidates.

    One Gershgorin pass bounds each member from above, ``torch.topk``
    picks the ``n_candidates`` highest bounds, bisection runs exactly on
    just those, and the result is ``max(exact candidate max, highest
    non-candidate bound)``: the true maximum whenever every
    non-candidate's bound falls below the exact candidate maximum, and a
    safe overestimate otherwise (Lipschitz steps only get smaller). Zero
    operators contribute exactly 0."""
    alphas, betas = _lanczos_tridiag(Hv, v0, num_iters)
    B = alphas.shape[0]
    m = min(int(n_candidates), B)
    if m == B:
        return torch.max(_tridiag_max_eig(alphas, betas))
    top_ub, idx = torch.topk(tridiag_gershgorin_max(alphas, betas), m)
    exact = _tridiag_max_eig(alphas[idx], betas[idx])
    # every non-candidate is bounded by the smallest candidate bound
    return torch.maximum(torch.max(exact), top_ub[-1])


def nesterov_next(t):
    """One step of the FISTA momentum recursion:
    ``t' = (1 + sqrt(4 t^2 + 1)) / 2``, ``omega = (t - 1) / t'``.
    Returns ``(omega, t')``; ``t`` is a tensor scalar."""
    t_next = 0.5 * (1.0 + torch.sqrt(4.0 * t * t + 1.0))
    omega = (t - 1.0) / t_next
    return omega, t_next


class NesterovAccelerator:
    """Stateful host-side accelerator with the reference's semantics: each
    read of ``omega`` advances the momentum clock ``t`` (a Python float).
    The drivers use :func:`nesterov_next` on a tensor instead."""

    def __init__(self, accelerated=False):
        self.t = 1.0
        self.accelerated = accelerated

    @property
    def omega(self):
        if self.accelerated:
            t_next = 0.5 * (1.0 + math.sqrt(4.0 * self.t * self.t + 1.0))
            om, self.t = (self.t - 1.0) / t_next, t_next
            return om
        return 0.0


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


def _safe_div(num, den, fallback):
    """``num / den`` with ``fallback`` where ``den == 0``: a 0/0 Rayleigh
    quotient on an exactly stalled iterate must give the stabilized step,
    not NaN."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       fallback)


class BarzilaiBorweinStepper:
    """Barzilai-Borwein spectral steps (BB1/BB2) with the stabilization of
    Burdakov et al. (2019, Algorithm 2.1). Counterpart of
    :class:`proxmin_tpu.utils.BarzilaiBorweinStepper`: the state ``(X_prev,
    G_prev, Delta)``, tensors all, is carried through the solver loop.

    ``it`` is the host's global iteration clock (it continues across a
    resume), so the first-iteration branch (``it == 0``: the step ``r
    max|X| / max|G|``) and the stabilization window (``it <= 3``: Delta
    tracks the shortest step taken) are host branches that give what the
    JAX stepper's ``where`` selects. A stepper that needs the gradient is
    not segmentable (:attr:`StridedStepper.segmentable`).

    It also runs alone with the reference's calling convention,
    ``stepper.step(*X, it=..., grads=...)``, keeping its state on the
    instance.
    """

    def __init__(self, type=1, init_r=0.1):
        if type not in (1, 2):
            raise ValueError(f"type must be 1 (BB1) or 2 (BB2), got {type!r}")
        self.type = type
        self.r = init_r
        self._host_state = None

    def init_state(self, X, G):
        n = len(X)
        dtype = X[0].dtype
        for x in X[1:]:
            dtype = torch.promote_types(dtype, x.dtype)
        # sharded blocks: their per-block scalars are replicated
        delta = replicated_like(torch.full((n,), float("inf"), dtype=dtype,
                                           device=X[0].device), X[0])
        return (tuple(torch.zeros_like(x) for x in X),
                tuple(torch.zeros_like(x) for x in X), delta)

    def __call__(self, state, X, it, G):
        x_prev, g_prev, delta = state
        n = len(X)
        if it == 0:
            steps = tuple(
                _safe_div(self.r * torch.max(torch.abs(X[j])),
                          torch.max(torch.abs(G[j])), 0.0) for j in range(n))
            return steps, (tuple(X), tuple(G), delta)

        S = tuple(X[j] - x_prev[j] for j in range(n))
        Y = tuple(G[j] - g_prev[j] for j in range(n))
        # inf marks an undefined quotient: the min with Astab below then
        # selects the stabilized step
        if self.type == 1:
            A = tuple(_safe_div(torch.sum(S[j] ** 2), torch.sum(S[j] * Y[j]),
                                float("inf")) for j in range(n))
        else:
            A = tuple(_safe_div(torch.sum(S[j] * Y[j]), torch.sum(Y[j] ** 2),
                                float("inf")) for j in range(n))
        if it <= 3:
            # Delta tracks the shortest step over the first iterations
            step_len = torch.stack([torch.sqrt(torch.sum(S[j] ** 2))
                                    for j in range(n)])
            delta = torch.minimum(delta, step_len.to(delta.dtype))
        # zero gradient: stationary, and a zero step keeps the iterate
        # fixed (inf would give inf * 0 = NaN in the solver's update)
        steps = tuple(
            torch.minimum(torch.abs(A[j]), _safe_div(
                delta[j], torch.sqrt(torch.sum(G[j] ** 2)), 0.0))
            for j in range(n))
        return steps, (tuple(X), tuple(G), delta)

    def step(self, *X, it=None, grads=None):
        """The reference's host interface: NumPy steps for the blocks ``X``
        (tensors, or NumPy arrays, which stay on the CPU) and their
        gradients; ``it == 0`` starts a new history."""
        X = tuple(torch.as_tensor(x) for x in X)
        grads = tuple(torch.as_tensor(g) for g in _as_tuple(grads))
        if it == 0 or self._host_state is None:
            self._host_state = self.init_state(X, grads)
        steps, self._host_state = self(self._host_state, X, it, grads)
        return tuple(s.detach().cpu().numpy() for s in steps)


def make_stepper(step, n_blocks):
    """Coerce a float / tuple / callable / stepper object into the stepper
    protocol (any callable with ``init_state``, such as
    :class:`BarzilaiBorweinStepper`, passes through)."""
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

    With ``stride`` a 0-d integer tensor (and ``first`` a bool tensor, or a
    Python bool) the rule runs on the device instead, with the same float32
    arithmetic, and returns a 0-d tensor of ``stride``'s dtype: the form an
    exported loop carries, which reads nothing back.
    """
    if isinstance(stride, torch.Tensor):
        return _grow_stride_tensor(stride, old_steps, new_steps, budget,
                                   max_stride, first)
    stride = int(stride)
    if first:
        return stride
    tiny = torch.finfo(torch.float32).tiny
    drift = np.float32(_step_drift(old_steps, new_steps).item())
    budget = np.float32(budget)
    if 0 < drift < budget:
        bump = np.floor(budget / max(drift, np.float32(tiny))
                        * np.float32(stride))
        return int(min(max_stride, stride + max(1, min(bump, max_stride))))
    if drift > budget:
        return max(1, stride // 2)
    return stride


def _step_drift(old_steps, new_steps):
    """``max |new - old| / max(max |old|, tiny)`` over the step leaves, a
    0-d float32 tensor."""
    f32 = torch.float32
    tiny = torch.finfo(f32).tiny
    drifts = []
    for o, n in zip(_as_tuple(old_steps), _as_tuple(new_steps)):
        o = torch.as_tensor(o).to(f32)
        n = torch.as_tensor(n).to(device=o.device, dtype=f32)
        drifts.append(torch.max(torch.abs(n - o))
                      / torch.clamp_min(torch.max(torch.abs(o)), tiny))
    return torch.stack(drifts).max()


def _grow_stride_tensor(stride, old_steps, new_steps, budget, max_stride,
                        first):
    """:func:`grow_stride` on the device: the host rule's float32 drift,
    bump and comparisons as tensor ops on a 0-d integer ``stride``."""
    f32 = torch.float32
    drift = _step_drift(old_steps, new_steps)
    # a tensor, not a Python number: ``number / tensor`` would multiply by
    # a reciprocal, where the host rule divides
    b = torch.full((), float(np.float32(budget)), dtype=f32,
                   device=drift.device)
    bump = torch.floor(b / torch.clamp_min(drift, torch.finfo(f32).tiny)
                       * stride.to(f32))
    bump = torch.clamp(bump, 1, max_stride).to(stride.dtype)
    grow = torch.logical_and(drift > 0, drift < b)
    new = torch.where(
        grow, torch.clamp_max(stride + bump, max_stride),
        torch.where(drift > b, torch.clamp_min(stride // 2, 1), stride))
    return torch.where(torch.as_tensor(first, device=stride.device), stride,
                       new)


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
    drift, with ``adapt``). Until the first refresh ``cached`` holds one
    Python zero per block (the JAX package: zeros of the steps' shapes), so
    a fresh state and a carried one have one structure, which the drivers'
    resume check compares.

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
        cached = (0.0,) * self.n_blocks
        if self.adapt:
            return (inner0, cached, self.stride, 0)
        return (inner0, cached, 0)

    def _refresh(self, state, X, it, G):
        if self.adapt:
            inner_state, cached_old, stride, _ = state
        else:
            inner_state, cached_old = state[0], state[1]
        steps, new_inner = self.inner(inner_state, X, it, G)
        steps = tuple(torch.as_tensor(s) * self.safety for s in steps)
        if not self.adapt:
            return (new_inner, steps, it + self.stride)
        # the placeholders of a state that never refreshed, on the device
        cached_old = tuple(o if isinstance(o, torch.Tensor)
                           else torch.zeros_like(s)
                           for o, s in zip(cached_old, steps))
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


# ---------------------------------------------------------------------------
# host-side helpers: the profiler context, the warning summary, callbacks

class profile_trace:
    """Context manager that profiles everything run inside the block with
    ``torch.profiler`` (the host, and the card when there is one) and
    writes a Chrome trace, ``proxmin_trace_<time>.json``, into ``log_dir``
    on exit (load it in ``chrome://tracing`` or Perfetto). The profiler is
    at ``.profiler`` for ``key_averages()``, the file at ``.path``.

    Counterpart of :class:`proxmin_tpu.utils.profile_trace` with its
    signature; ``create_perfetto_link`` has no counterpart in
    ``torch.profiler`` and is accepted and ignored.

    >>> with utils.profile_trace("prof"):
    ...     pgm(x0, grad, step, ...)
    """

    def __init__(self, log_dir, create_perfetto_link=False):
        self.log_dir = log_dir
        self.create_perfetto_link = create_perfetto_link
        self.profiler = None
        self.path = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=activities)
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profiler.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir, f"proxmin_trace_{time.time_ns()}.json")
        self.profiler.export_chrome_trace(self.path)
        return False


class summarize_convergence_warnings:
    """Collapse the per-solve ``Solution did not converge`` warnings of the
    ``"proxmin"`` logger into one summary line on exit.

    Timing harnesses run fixed-iteration solves through the drivers, which
    warn once per solve that did not converge. Inside this context those
    warnings are counted instead of emitted; other records pass through.

    >>> with utils.summarize_convergence_warnings():
    ...     for _ in range(25):
    ...         nmf(Y, A, S, e_rel=0, max_iter=100)
    """

    _MSG = "Solution did not converge"

    def __init__(self, logger_name="proxmin"):
        self._logger = logging.getLogger(logger_name)
        self.count = 0

    def filter(self, record):  # the logging.Filter protocol
        if record.getMessage().startswith(self._MSG):
            self.count += 1
            return False
        return True

    def __enter__(self):
        self.count = 0
        self._logger.addFilter(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeFilter(self)
        if self.count:
            self._logger.warning(
                "Suppressed %dx %r (fixed-iteration timing runs)",
                self.count, self._MSG)
        return False


class Traceback:
    """Callback that records a copy of the iterates at every call, as
    tuples of host NumPy arrays (so ``.trace`` compares with the JAX
    package's directly). The drivers hand a callback tensors; on the card
    every call therefore copies every block to the host, which waits for
    the stream: one blocking copy per block and iteration."""

    def __init__(self):
        self._trace = []

    def __call__(self, *X, it=None):
        self._trace.append(tuple(self._host_copy(x) for x in X))

    @staticmethod
    def _host_copy(x):
        if not isinstance(x, torch.Tensor):
            return np.array(x, copy=True)
        if x.device.type == "cpu":
            return x.detach().numpy().copy()
        return x.detach().cpu().numpy()  # the transfer is the copy

    @property
    def trace(self):
        return self._trace

    def clear(self):
        self._trace = []


class NullCallback:
    def __call__(self, *X, it=None):
        pass


class ApproximateCache:
    """Cache an expensive, slowly varying scalar evaluation, recomputing it
    at a growing stride: after a recomputation whose relative change from
    the stored value lies in ``(0, slack / 2)``, the stride grows by
    ``max(1, int(budget / change * stride))``, capped at ``max_stride``.
    ``len(cache)`` is the current stride. The values may be floats or 0-d
    tensors; comparing a tensor's change reads it from the device."""

    def __init__(self, func, slack=0.1, max_stride=100):
        if not 0 <= slack < 1:
            raise ValueError(f"slack must lie in [0, 1), got {slack}")
        self.func = func
        self.slack = slack
        self.max_stride = max_stride
        self.it = 0
        self.stride = 1
        self.last = -1
        self.stored = None

    def __len__(self):
        return self.stride

    def __call__(self, *args, **kwargs):
        if self.slack == 0:
            self.it += 1
            return self.func(*args, **kwargs)
        if self.it >= self.last + self.stride:
            self.last = self.it
            val = self.func(*args, **kwargs)
            if self.it > 1 and self.slack > 0:
                rel_error = float(abs(self.stored - val) / self.stored)
                budget = self.slack / 2
                if 0 < rel_error < budget:
                    self.stride += max(1, int(budget / rel_error
                                              * self.stride))
                    self.stride = min(self.max_stride, self.stride)
            self.stored = val
        else:
            self.it += 1
        return self.stored


def hasNotNone(l):
    """The reference's helper: the distance from the first element of ``l``
    that contains an entry other than None to the end of the list, or 0 if
    none does."""
    for i, ll in enumerate(l):
        if ll is not None and hasattr(ll, "__iter__"):
            for lll in ll:
                if lll is not None:
                    return len(l) - i
    return 0


def check_convergence(newX, oldX, e_rel):
    """Langville (2014) sec. 5 NMF convergence test: ``<new, old> >= (1 -
    e_rel^2) <old, old>``. Returns the verdict (a 0-d bool tensor) and the
    two inner products."""
    new_old = torch.sum(newX * oldX)
    old2 = torch.sum(oldX ** 2)
    return new_old >= (1 - e_rel ** 2) * old2, (new_old, old2)


# ---------------------------------------------------------------------------
# ADMM-family shared numerics

def initZU(X, L):
    """Initial auxiliary ``Z = L X`` and dual ``U = 0`` (one operator or a
    list of them)."""
    if isinstance(L, (list, tuple)):
        Z = tuple(Li.matvec(X) for Li in L)
        U = tuple(torch.zeros_like(Zi) for Zi in Z)
        return Z, U
    Z = L.matvec(X)
    return Z, torch.zeros_like(Z)


def get_step_g(step_f, norm_L2, N=1, M=1):
    """Step size for prox_g compatible with ``step_f`` (Parikh 2013
    sec. 4.4.2, with the reference's N M safety factor for several blocks
    and constraints)."""
    return step_f * norm_L2 * N * M


def get_step_f(step_f, lR2, lS2):
    """The reference's (dead) residual-balancing helper, kept for API
    parity only: its sign suits a penalty parameter, not a prox step. Use
    ``admm(..., adapt_step=True)`` for working residual balancing."""
    mu, tau = 10.0, 2.0
    lR2, lS2 = torch.as_tensor(lR2), torch.as_tensor(lS2)
    step_f = torch.as_tensor(step_f)
    return torch.where(lR2 > mu * lS2, step_f * tau,
                       torch.where(lS2 > mu * lR2, step_f / tau, step_f))


def do_the_mm(X, step_f, Z, U, prox_g, step_g, L):
    """One constraint's Z/U update; returns ``(Z', U', LX, R, S)``.

    ``Z' = prox_g(L X + U, step_g)``; primal residual ``R = L X - Z'``;
    dual residual ``S = -L^T (Z' - Z) / step_g``; ``U' = U + R``."""
    LX = L.matvec(X)
    Z_new = prox_g(LX + U, step_g)
    R = LX - Z_new
    S = -L.rmatvec(Z_new - Z) / step_g
    U_new = U + R
    return Z_new, U_new, LX, R, S


def update_variables(X, Z, U, prox_f, step_f, prox_g, step_g, L):
    """The shared ADMM/SDMM/bSDMM primal-dual inner update (linearized);
    returns ``(X', Z', U', LX, R, S)``.

    One constraint: ``prox_g`` is a callable (or None) and ``L`` an
    operator. Several: ``prox_g``/``step_g``/``L``/``Z``/``U`` are
    sequences of length M, and the X update sums the M linearization
    terms."""
    if not isinstance(prox_g, (list, tuple)):
        if prox_g is not None:
            dX = step_f / step_g * L.rmatvec(L.matvec(X) - Z + U)
            X_new = prox_f(X - dX, step_f)
            Z_new, U_new, LX, R, S = do_the_mm(
                X_new, step_f, Z, U, prox_g, step_g, L)
        else:
            # no constraint: the plain fixed-point step of prox_f
            X_new = prox_f(X, step_f)
            S = X_new - X
            LX = X_new
            Z_new = X_new
            U_new = U
            R = torch.zeros_like(X_new)
        return X_new, Z_new, U_new, LX, R, S

    M = len(prox_g)
    dX = None
    for i in range(M):
        term = step_f / step_g[i] * L[i].rmatvec(L[i].matvec(X) - Z[i] + U[i])
        dX = term if dX is None else dX + term
    X_new = prox_f(X - dX, step_f)
    out = [do_the_mm(X_new, step_f, Z[i], U[i], prox_g[i], step_g[i], L[i])
           for i in range(M)]
    Z_new, U_new, LX, R, S = (tuple(o[i] for o in out) for i in range(5))
    return X_new, Z_new, U_new, LX, R, S


def get_variable_errors(X, L, LX, Z, U, step_g, e_rel, e_abs=0):
    """Primal and dual error thresholds of one multiplier-method step, as
    0-d tensors on the iterate's device (``spectral_norm_sq`` is a Python
    number for the identity and a tensor otherwise)."""
    n = X.numel()
    p = Z.numel()
    norm_sq = L.spectral_norm_sq
    # with no constraint LX and Z are one tensor: one reduction serves both
    lZ = l2(Z)
    lLX = lZ if LX is Z else l2(LX)
    e_pri = math.sqrt(p) * e_abs / norm_sq + e_rel * torch.maximum(lLX, lZ)
    LtU = L.rmatvec(U)
    if step_g is not None:
        LtU = LtU / step_g
    e_dual = math.sqrt(n) * e_abs / norm_sq + e_rel * l2(LtU)
    return e_pri, e_dual


def check_constraint_convergence(X, L, LX, Z, U, R, S, step_f, step_g, e_rel,
                                 e_abs):
    """Boyd (2011) sec. 3.3.1 convergence test over all constraints
    (recursive over constraint lists, like the reference). Returns
    ``(converged, errors)``: a 0-d bool tensor, and ``(e_pri, e_dual, ||R||,
    ||S||)`` per constraint."""
    if isinstance(L, (list, tuple)):
        convergence, errors = None, []
        for i in range(len(L)):
            c, e = check_constraint_convergence(
                X, L[i], LX[i], Z[i], U[i], R[i], S[i], step_f, step_g[i],
                e_rel, e_abs)
            convergence = c if convergence is None else torch.logical_and(
                convergence, c)
            errors.append(e)
        return convergence, tuple(errors)

    e_pri, e_dual = get_variable_errors(X, L, LX, Z, U, step_g, e_rel, e_abs)
    lR = l2(R)
    lS = l2(S)
    convergence = torch.logical_and(lR <= e_pri, lS <= e_dual)
    return convergence, (e_pri, e_dual, lR, lS)
