"""Proximal Gradient Method (ISTA / FISTA) as a host loop over tensor ops.

Counterpart of :func:`proxmin_tpu.solvers.pgm.pgm`, including its
segmented mode for strided steppers and its callback mode (one loop here).
The JAX driver runs the whole solve in one ``lax.while_loop`` with the stop
test on the device. Here the loop runs on the host: every iteration's math
stays on the iterates' device, and the stop flags (converged per block,
diverged) are read back once per iteration, in one device-to-host copy.
The body is the JAX body term for term, so the stopping iteration is the
JAX driver's.

Backtracking's inner loop depends on the data, so each of its tests is a
host read: the first test rides in the iteration's one read (with the stop
flags of the trial point, which stand when no halving follows), every
halving adds one read, and with several blocks the first halving of an
iteration adds one more, for the block to halve. ``callback=`` and
``trace=`` add no read. Under ``torch.func.vmap``
(``functional.make_pgm_solver``) the halvings run as rounds over all the
lanes, one read per round (:func:`_halvings_lanes`).
"""

import functools
import logging

import torch

from .. import utils
from ..utils import (fixed_point_norms, fixed_point_verdict, make_stepper,
                     nesterov_next)
from .common import (SolverResult, any_lane, check_stepper_state,
                     grad_from_f, host_values, local_of,
                     normalize_per_block, normalize_prox, select_lanes,
                     status_from, tupleize, writeback)

logger = logging.getLogger("proxmin")

__all__ = ["pgm"]

# cap on the backtracking halvings of one iteration (2^-60 underflows any
# reasonable step)
_MAX_BACKTRACK = 60


def _init_state(x0, n, accelerated, resume):
    """The loop carry as a dict, fresh or from a previous ``.state``."""
    dtype = functools.reduce(torch.promote_types, [x.dtype for x in x0],
                             torch.float32)
    device = x0[0].device

    def t_(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    if resume is None:
        return dict(
            x=x0, x_prev=tuple(x.clone() for x in x0) if accelerated else (),
            t=t_(1.0), T=torch.ones((n,), dtype=dtype, device=device),
            f_prev=t_(float("inf")), stepper_state=None, it0=0,
            converged=torch.zeros((n,), dtype=torch.bool, device=device),
            diverged=torch.zeros((), dtype=torch.bool, device=device),
        )
    xp = tuple(resume.get("x_prev", ()))
    if accelerated != bool(len(xp)):
        raise ValueError(
            "state= was produced under accelerated="
            f"{bool(len(xp))} but this solve has accelerated="
            f"{accelerated}; resume with the same setting"
        )
    conv = resume.get("converged")
    return dict(
        x=x0,
        x_prev=tuple(torch.as_tensor(x, device=device).clone() for x in xp),
        t=t_(resume["t"]), T=t_(resume["T"]).reshape((n,)),
        f_prev=t_(resume["f_prev"]),
        stepper_state=resume.get("stepper_state"),
        it0=int(resume.get("it", 0)),
        converged=(torch.zeros((n,), dtype=torch.bool, device=device)
                   if conv is None else torch.as_tensor(
                       conv, device=device).to(torch.bool).reshape((n,))),
        diverged=torch.as_tensor(resume.get("diverged", False),
                                 device=device).to(torch.bool),
    )


def _scalar(v, like):
    """``f``'s value as a tensor (a Python number is filled on ``like``'s
    device, never copied there)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def _halvings_traced(T, x_new, f_now, jmax, prox_step, Q, f, like):
    """Backtracking's halvings as a ``while_loop`` that ``torch.export``
    captures: while the trial point fails the test (at most
    ``_MAX_BACKTRACK`` times), halve block ``jmax``'s factor and redo its
    prox step, as the host loop of :func:`_step` does. Returns ``(T, x_new,
    f_now)``."""
    from torch._higher_order_ops.while_loop import while_loop

    n = len(x_new)
    idx = torch.arange(n, device=T.device)

    def cond(k, T, f_now, *x):
        return torch.logical_and(k < _MAX_BACKTRACK, f_now > Q(x, T))

    def body(k, T, f_now, *x):
        T = torch.where(idx == jmax, T / 2, T)
        if n == 1:
            x = (prox_step(0, T[0]),)
        else:
            x = tuple(torch.where(jmax == j, prox_step(j, T[j]), x[j])
                      for j in range(n))
        return (k + 1, T, _scalar(f(*x), like), *x)

    k0 = torch.zeros((), dtype=torch.int32, device=T.device)
    _, T, f_now, *x_new = while_loop(cond, body, (k0, T, f_now, *x_new))
    return T, tuple(x_new), f_now


def _halvings_lanes(T, x_new, f_now, jmax, prox_step, Q, f, like, live):
    """Backtracking's halvings under ``torch.func.vmap``: each round reads
    every lane's test at once (one blocking read), and the lanes that fail
    it, among the ``live`` ones, halve block ``jmax``'s factor (their own
    block) and redo its prox step; a lane that passes keeps its ``T``, trial
    point and ``f``, as ``lax.while_loop`` keeps them under ``jax.vmap``.
    A lane still failing after round ``k`` has halved ``k`` times, so the
    cap is the host's round count. Returns ``(T, x_new, f_now)``."""
    n = len(x_new)
    idx = torch.arange(n, device=T.device)
    for _ in range(_MAX_BACKTRACK):
        fail = torch.logical_and(live, f_now > Q(x_new, T))
        if not any_lane(fail):
            break
        T_h = torch.where(idx == jmax, T / 2, T)
        if n == 1:
            x_h = (prox_step(0, T_h[0]),)
        else:
            x_h = tuple(torch.where(jmax == j, prox_step(j, T_h[j]), x_new[j])
                        for j in range(n))
        f_h = _scalar(f(*x_h), like)
        T = torch.where(fail, T_h, T)
        x_new = select_lanes(fail, x_h, x_new)
        f_now = torch.where(fail, f_h, f_now)
    return T, x_new, f_now


def _step(st, it, grad, stepper, prox, e_rel, accelerated, restart,
          backtracking, f, trace, traced=False, lanes=None):
    """One PGM iteration on the carry (the JAX body, term for term): the
    loop body that the driver and ``functional.make_pgm_solver`` share.
    The new stop flags stand in ``st["converged"]`` and
    ``st["diverged"]``. Without backtracking it reads nothing and returns
    None; with it, the first test rides one read with the trial point's
    flags, and the host values ``[*converged, diverged]`` come back when
    they were read. ``traced`` (an exported program, ``it`` a tensor):
    the halvings run as :func:`_halvings_traced` and nothing is read.
    ``lanes`` (under ``torch.func.vmap``, the lanes still running): the
    halvings run as :func:`_halvings_lanes`, one read per round, and no
    flags come back."""
    n = len(prox)
    x_old = st["x"]
    if accelerated:
        omega, t_next = nesterov_next(st["t"])
        x_ex = tuple(x_old[j] + omega * (x_old[j] - st["x_prev"][j])
                     for j in range(n))
    else:
        t_next = st["t"]
        x_ex = x_old
    G = utils._as_tuple(grad(*x_ex))
    S, st["stepper_state"] = stepper(st["stepper_state"], x_ex,
                                     it + st["it0"], G)
    T = st["T"]

    def prox_step(j, Tj):
        step_j = Tj * S[j]
        return prox[j](x_ex[j] - step_j * G[j], step_j)

    def verdicts(x):
        # one pair of reductions per block serves the convergence test,
        # the divergence detector and the trace residual
        norms = [fixed_point_norms(x[j], x_old[j]) for j in range(n)]
        vs = [fixed_point_verdict(d, nx, e_rel[j])
              for j, (d, nx) in enumerate(norms)]
        conv = torch.stack([c for c, _ in vs])
        finite = torch.stack([fin for _, fin in vs]).all()
        diverged = torch.logical_or(st["diverged"],
                                    torch.logical_not(finite))
        return norms, conv, diverged

    x_new = tuple(prox_step(j, T[j]) for j in range(n))
    if backtracking:
        # Beck & Teboulle eq. 3.2 (g dropped from F and Q: it cancels)
        if traced:
            st["f_prev"] = torch.where(it + st["it0"] == 0,
                                       _scalar(f(*x_old), st["t"]),
                                       st["f_prev"])
        elif it + st["it0"] == 0:
            st["f_prev"] = _scalar(f(*x_old), st["t"])
        f_prev = st["f_prev"]
        f_now = _scalar(f(*x_new), st["t"])

        def Q(x, T_bt):
            acc = None
            for j in range(n):
                d = x[j] - x_old[j]
                term = (torch.sum(d * G[j])
                        + torch.sum(0.5 / (T_bt[j] * S[j]) * d ** 2))
                acc = term if acc is None else acc + term
            return f_prev + acc

    jmax, k, host = None, 0, None
    if backtracking and (traced or lanes is not None):
        # every lane's own block to halve, without a read
        jmax = 0 if n == 1 else torch.argmax(torch.stack([
            torch.max(torch.abs(S[j] * G[j])) / torch.max(torch.abs(x_old[j]))
            for j in range(n)]))
        if traced:
            T, x_new, f_now = _halvings_traced(T, x_new, f_now, jmax,
                                               prox_step, Q, f, st["t"])
        else:
            T, x_new, f_now = _halvings_lanes(T, x_new, f_now, jmax,
                                              prox_step, Q, f, st["t"], lanes)
        backtracking = False  # the loop below only takes the verdicts
    while True:
        norms, conv, diverged = verdicts(x_new)
        if not (backtracking and k < _MAX_BACKTRACK):
            break
        # the blocking read, one per trial point: its stop flags and its
        # test; the flags stand if no halving follows
        flags = host_values(torch.cat([conv, diverged.reshape(1),
                           (f_now > Q(x_new, T)).reshape(1)]))
        if not flags[n + 1]:
            host = flags[:n + 1]
            break
        if jmax is None:
            # the steepest relative update direction; it depends on the
            # iteration's G, S and x_old only, so one read serves every
            # halving of the iteration
            jmax = 0 if n == 1 else int(torch.argmax(torch.stack([
                torch.max(torch.abs(S[j] * G[j]))
                / torch.max(torch.abs(x_old[j])) for j in range(n)])))
        T = T.clone()
        T[jmax] = T[jmax] / 2
        x_new = tuple(prox_step(j, T[j]) if j == jmax else x_new[j]
                      for j in range(n))
        f_now = _scalar(f(*x_new), st["t"])
        k += 1
    if backtracking or jmax is not None:
        st["T"], st["f_prev"] = T, f_now

    if accelerated and restart:
        # O'Donoghue & Candes adaptive restart: reset the momentum clock
        # when the extrapolation overshoots
        osc = sum(torch.sum((x_ex[j] - x_new[j]) * (x_new[j] - x_old[j]))
                  for j in range(n))
        t_next = torch.where(osc > 0, torch.ones_like(t_next), t_next)
    if trace:
        # per-block relative fixed-point residual, kept on the device
        st["history"].append(torch.stack([
            torch.sqrt(d / torch.clamp_min(nx, 1e-30)) for d, nx in norms
        ]).to(st["t"].dtype))
    st["x_prev"] = x_old if accelerated else ()
    st["x"] = x_new
    st["t"] = t_next
    st["S"] = S
    st["converged"], st["diverged"] = conv, diverged
    return host


def _iterate(st, it, grad, stepper, prox, e_rel, accelerated, restart,
             backtracking, f, trace):
    """:func:`_step` and the iteration's one blocking read: the stop flags
    as host values, ``(converged per block, diverged)``."""
    host = _step(st, it, grad, stepper, prox, e_rel, accelerated, restart,
                 backtracking, f, trace)
    if host is None:
        host = host_values(torch.cat([st["converged"],
                          st["diverged"].reshape(1)]))
    return host[:-1], host[-1]


def pgm(
    X,
    grad,
    step,
    prox=None,
    accelerated=False,
    restart=False,
    backtracking=False,
    f=None,
    e_rel=1e-6,
    max_iter=1000,
    callback=None,
    trace=False,
    state=None,
    device=None,
):
    """Proximal Gradient Method (ISTA; FISTA when ``accelerated=True``).

    Args:
        X: initial iterate, a tensor/array or a list of them (blocks).
            NumPy inputs go to ``device`` and are updated in place; tensors
            stay on their device.
        grad: ``grad(*X) -> dX`` (a tuple for several blocks). ``None``
            differentiates ``f`` by ``torch.autograd``
            (:func:`~proxmin_tpu_torch.solvers.common.grad_from_f`).
        step: step size(s), a callable ``step(*X, it=..., [grads=...])``
            or a stepper object such as
            :class:`~proxmin_tpu_torch.utils.BarzilaiBorweinStepper`.
        prox: proximal operator(s) ``prox(X, step)``; None is the identity.
        accelerated: Nesterov/FISTA momentum.
        restart: with ``accelerated``, gradient-based adaptive restart.
        backtracking: Beck-Teboulle backtracking line search (needs ``f``):
            while ``f(x') > Q``, the block with the steepest relative update
            ``max|S_j G_j| / max|x_j|`` halves its scale ``T_j`` and is
            proxed again, at most 60 times per iteration. The scales and the
            last value of ``f`` are part of ``.state``.
        f: the smooth function ``f(*X) -> scalar tensor``, for
            ``backtracking`` and for ``grad=None``.
        e_rel: relative fixed-point tolerance (scalar or per block).
        max_iter: iteration cap (a resumed solve runs up to this many more).
        callback: ``callback(*X, it=it)`` before every iteration, with the
            blocks as tensors (not to be modified) and ``it`` counted from
            this call's start; ``StopIteration`` ends the solve cleanly.
        trace: record each iteration's relative fixed-point residual per
            block on the device, returned as ``.history`` of shape
            ``(iterations, n_blocks)``.
        state: a previous solve's ``.state`` to continue from, together
            with its ``.x``: the momentum clock and previous iterate, the
            backtracking scales and the stepper's state continue, a stopped
            solve stays stopped. It goes through a file with
            :mod:`proxmin_tpu_torch.checkpoint`.
        device: where NumPy inputs go (default: the CUDA device; without
            one, pass ``device="cpu"``).

    Returns:
        ``SolverResult`` unpacking as ``(converged, G, S)``, with ``.x``,
        ``.iterations``, ``.converged``, ``.history``, ``.status`` and
        ``.state``. ``G`` is the gradient at the returned solution.
    """
    x0, originals, was_single = tupleize(X, device)
    n = len(x0)
    prox = normalize_prox(prox, n)
    e_rel = normalize_per_block(e_rel, n)
    if grad is None:
        assert f is not None, "grad=None requires f"
        grad = grad_from_f(f, n)
    assert backtracking is False or f is not None
    # a strided stepper refreshes inside _step, on the host's next-refresh
    # clock: in a host loop that is the JAX driver's segmented mode too
    # (refresh at a segment boundary, frozen steps in between), and a
    # resume that lands mid-segment or on a boundary follows the carried
    # clock
    stepper = make_stepper(step, n)

    st = _init_state(x0, n, accelerated, state)
    fresh = stepper.init_state(x0, None)
    if st["stepper_state"] is None:
        st["stepper_state"] = fresh
    else:
        check_stepper_state(st["stepper_state"], fresh)
    st["S"] = tuple(torch.zeros((), dtype=st["t"].dtype,
                                device=st["t"].device) for _ in range(n))
    st["history"] = []
    if state is None:
        conv_h, div_h = [False] * n, False
    else:
        # a stopped solve stays stopped: one read of the carried flags
        *conv_h, div_h = host_values(torch.cat(
            [st["converged"], st["diverged"].reshape(1)]))
    it = 0
    while it < max_iter and not (all(conv_h) or div_h):
        if callback is not None:
            try:
                callback(*st["x"], it=it)
            except StopIteration:
                break
        conv_h, div_h = _iterate(st, it, grad, stepper, prox, e_rel,
                                 accelerated, restart, backtracking, f,
                                 trace)
        it += 1

    G_fin = utils._as_tuple(grad(*st["x"]))
    iterations = it
    logger.info("Completed %d iterations", iterations)
    converged = tuple(conv_h)
    status = status_from(all(converged), div_h, logger)

    writeback(originals, st["x"])
    x_out = st["x"][0] if was_single else st["x"]
    G = G_fin[0] if was_single else G_fin
    S = st["S"][0] if was_single else st["S"]
    history = None
    if trace:
        # one copy at the end
        history = local_of(torch.stack(st["history"]) if st["history"] else
                           torch.zeros((0, n), dtype=st["t"].dtype)
                           ).cpu().numpy()
    resume_state = {
        "x_prev": st["x_prev"], "t": st["t"], "T": st["T"],
        "f_prev": st["f_prev"], "stepper_state": st["stepper_state"],
        "it": iterations + st["it0"],
        "converged": st["converged"], "diverged": st["diverged"],
    }
    return SolverResult(
        (converged, G, S),
        x=x_out, iterations=iterations, converged=converged, G=G, S=S,
        history=history, status=status, state=resume_state,
    )
