"""Numerics core of the port: norms, the fixed-point test, the FISTA
momentum recursion, the stepper protocol, the strided step refresh, the
batched Lanczos bound and the ADMM family's shared update and convergence
test.

Counterparts of the same names in :mod:`proxmin_tpu.utils`. Everything
here works on tensors and returns tensors, so a solve on the card keeps
its scalars on the card.

Stepper protocol (shared with the JAX package)::

    init_state(X, G)            -> state (may be ())
    __call__(state, X, it, G)   -> (steps_tuple, new_state)
"""

import inspect
import math

import numpy as np
import torch

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
