"""Linearized ADMM and SDMM as host loops over tensor ops.

Counterparts of :func:`proxmin_tpu.solvers.admm.admm` and ``sdmm``:
two-prox splitting with a linear operator inside g, extended to M
simultaneous constraints, with Boyd (2011) sec. 3.3.1 primal/dual residual
stopping and the reference's slack-halving restart when the iterate and the
primal residual stall.

The JAX solver decides restart, convergence and divergence on the device
inside one ``lax.while_loop``. Here the loop runs on the host: every
iteration's math stays on the iterate's device, and the three flags
(converged, diverged, restart) are stacked into one tensor and read once
per iteration, the only blocking read. The host then branches: Z and U are
re-initialized only on a restart, where the JAX body selects between whole
arrays every iteration; the iterates come out the same. The loop's scalars
(the slack, the clocks) are host numbers; the residual-balancing multiplier
of ``adapt_step`` depends on the residual norms and stays on the device.

Because a restart resets the iteration counter, a total-work counter bounds
a solve at ``8 * max_iter`` body evaluations.
"""

import logging
from typing import Any, NamedTuple

import torch

from .. import utils
from ..linop import IdentityOperator, as_linear_operator
from .common import (BoolResult, SolverResult, as_tensor, host_values,
                     local_of, map_leaves, run_lanes, select_lanes,
                     status_from, tupleize, writeback)

logger = logging.getLogger("proxmin")

__all__ = ["admm", "sdmm"]

_RESTART_BUDGET = 8  # total body evaluations allowed: budget * max_iter

# residual-balancing multiplier bounds (adapt_step): wide enough to correct
# any plausible step mis-scaling, tight enough that a stuck imbalance cannot
# compound into float overflow or underflow
_ADAPT_SCALE_MIN = 2.0 ** -20
_ADAPT_SCALE_MAX = 2.0 ** 20


def _as_step_fn(step):
    """ADMM-family step convention: ``step_f(X, it=it) -> float``; numbers
    are wrapped."""
    if callable(step):
        return step
    return lambda X, it=None: step


class ADMMState(NamedTuple):
    """The state a solve ends in. ``it``, ``total_it``, ``slack``,
    ``converged``, ``diverged`` and the two carried clocks are host values;
    the rest are tensors on the iterate's device."""
    x: Any
    z: Any               # tuple of M (or a single) auxiliary variables
    u: Any               # duals, same structure as z
    it: int              # restart-relative iteration clock
    total_it: int        # body evaluations, restarts included
    slack: float
    converged: bool
    errors: Any          # (M, 4): e_pri, e_dual, |R|, |S| per constraint
    r_prev: Any          # same structure as z
    history: Any         # (cap, M, 4) residual trace indexed by
                         # total_it - total_it0; None when trace is off
    step_scale: Any      # residual-balancing multiplier on step_f (a 0-d
                         # tensor with adapt_step, else 1.0)
    total_it0: int       # carried total_it at a resume (0 fresh)
    it0: int             # carried it at a resume (0 fresh): the stop bound
                         # is it0 + max_iter, the value the uninterrupted
                         # solve runs under
    diverged: bool       # non-finite residual errors were produced


def _stack_errors(errors, multi):
    """``(e_pri, e_dual, |R|, |S|)`` per constraint -> an (M, 4) tensor."""
    if not multi:
        errors = (errors,)
    return torch.stack([v for e in errors for v in e]).reshape(len(errors), 4)


def _resume_state(state):
    """The fields of a final :class:`ADMMState` that continue across a
    resume, as a plain dict (the JAX package's keys)."""
    return {
        "z": state.z, "u": state.u, "slack": state.slack,
        "step_scale": state.step_scale, "r_prev": state.r_prev,
        "it": state.it, "total_it": state.total_it,
        # a stopped solve stays stopped on resume
        "converged": state.converged, "diverged": state.diverged,
    }


def _make_iteration(prox_f, step_f, proxs_g, steps_g, Ls, e_rel, e_abs,
                    admm_convention, adapt_step):
    """The loop body that the host loop (:func:`_sdmm_core`) and the lanes
    controller (:func:`_sdmm_lanes`) share: ``iteration(x, z, u, r_prev,
    it, slack, step_scale) -> (x', z', u', r, errors, converged,
    nonfinite, stall, step_scale')``. ``it`` is the restart-relative clock
    before the iteration, and with ``slack`` a host number in the host loop
    or a 0-d tensor per lane under ``vmap``; ``errors`` is the (M, 4) row
    block, the flags are 0-d tensors, and ``stall`` (the restart test) is
    None where it cannot hold."""
    M = len(proxs_g)
    has_g = M > 0
    step_fn = _as_step_fn(step_f)
    ident = IdentityOperator()

    def iteration(x, z, u, r_prev, it, slack, step_scale):
        step_f_ = slack * step_fn(x, it=it)
        if adapt_step:
            step_f_ = step_f_ * step_scale

        if M == 1:
            sg = steps_g[0]
            step_g_ = (utils.get_step_g(step_f_, Ls[0].spectral_norm_sq)
                       if sg is None else sg)
            x_new, z, u, lx, r, s = utils.update_variables(
                x, z, u, prox_f, step_f_, proxs_g[0], step_g_, Ls[0])
            conv_sg = sg if admm_convention else step_g_
            conv_t, errors = utils.check_constraint_convergence(
                x_new, Ls[0], lx, z, u, r, s, step_f_, conv_sg, e_rel, e_abs)
        elif has_g:
            steps_g_ = [
                utils.get_step_g(step_f_, Ls[i].spectral_norm_sq, M=M)
                if steps_g[i] is None else steps_g[i] for i in range(M)]
            x_new, z, u, lx, r, s = utils.update_variables(
                x, z, u, prox_f, step_f_, list(proxs_g), steps_g_, list(Ls))
            conv_t, errors = utils.check_constraint_convergence(
                x_new, list(Ls), lx, z, u, r, s, step_f_, steps_g_, e_rel,
                e_abs)
        else:
            x_new, z, u, lx, r, s = utils.update_variables(
                x, z, u, prox_f, step_f_, None, None, ident)
            conv_t, errors = utils.check_constraint_convergence(
                x_new, ident, lx, z, u, r, s, step_f_, None, e_rel, e_abs)

        errors_arr = _stack_errors(errors, M > 1)
        # the error norms are reductions of every live quantity, so their
        # finiteness detects a diverged iterate for free
        nonfinite = torch.logical_not(torch.isfinite(errors_arr).all())

        if adapt_step and has_g:
            # compare the aggregate primal and dual residual norms, adjust
            # the multiplier for the next iteration and rescale the scaled
            # duals by the effective ratio
            lR = torch.sqrt(torch.sum(errors_arr[:, 2] ** 2))
            lS = torch.sqrt(torch.sum(errors_arr[:, 3] ** 2))
            mu, tau = 10.0, 2.0
            one = torch.ones_like(step_scale)
            ratio = torch.where(lR > mu * lS, one / tau,
                                torch.where(lS > mu * lR, one * tau, one))
            scale_new = torch.clamp(step_scale * ratio, _ADAPT_SCALE_MIN,
                                    _ADAPT_SCALE_MAX)
            ratio_eff = scale_new / step_scale
            u = map_leaves(lambda ui: ui * ratio_eff, u)
            step_scale = scale_new

        # stall detector: X and every primal residual bitwise unchanged
        # since the last iteration, not converged, past the first two
        # iterations -> halve the slack, reset the iteration counter,
        # re-initialize Z and U from the new x
        stall = None
        past_two = it >= 1
        if has_g and past_two is not False:
            same = (x_new == x).all()
            for ri, rpi in (((r, r_prev),) if M == 1 else zip(r, r_prev)):
                same = torch.logical_and(same, (ri == rpi).all())
            stall = torch.logical_and(same, torch.logical_not(conv_t))
            if past_two is not True:
                stall = torch.logical_and(stall, past_two)
        return (x_new, z, u, r, errors_arr, conv_t, nonfinite, stall,
                step_scale)

    return iteration


def _init_zu(proxs_g, Ls):
    """``init_zu(x) -> (Z, U)`` for the constraint structure."""
    M = len(proxs_g)
    L_struct = list(Ls) if M != 1 else (Ls[0] if M else None)

    def init_zu(x):
        if not M:
            return x, torch.zeros_like(x)
        return utils.initZU(x, L_struct)

    return init_zu


def _check_adapt(adapt_step, steps_g):
    if adapt_step and any(sg is not None for sg in steps_g):
        raise ValueError(
            "adapt_step requires the derived step_g coupling "
            "(step_g=None): a fixed user step_g cannot track the "
            "adapted step_f, which corrupts the dual rescale and can "
            "cross the linearized-ADMM stability bound"
        )


def _sdmm_core(x0, prox_f, step_f, proxs_g, steps_g, Ls, e_rel, e_abs,
               max_iter, callback, trace=False, admm_convention=True,
               adapt_step=False, resume=None):
    """The shared solver loop. ``proxs_g``: tuple of M callables (empty for the
    no-constraint fall-back); ``steps_g``: tuple of M user values or None;
    ``Ls``: tuple of M operators.

    ``admm_convention``: the reference's admm passes the user's ``step_g``
    (None when defaulted) to the convergence test while its sdmm passes
    the evaluated value; the flag selects which the single-constraint
    branch keeps.

    ``adapt_step``: Boyd (2011) sec. 3.4.1 residual balancing. When the
    primal residual dominates (``||R|| > 10 ||S||``) the f-prox step
    shrinks by 2 (steps here are ~1/rho), when the dual dominates it grows
    by 2, and the scaled duals U rescale by the effective ratio so that the
    multiplier ``y = U / step_g`` stays continuous, also at the clamp. It
    needs the derived ``step_g``: a fixed user ``step_g`` cannot track the
    adapted ``step_f``, which corrupts the dual rescale and can cross the
    stability bound ``step_f <= step_g / ||L||^2``."""
    M = len(proxs_g)
    _check_adapt(adapt_step, steps_g)
    dtype, device = x0.dtype, x0.device
    iteration = _make_iteration(prox_f, step_f, proxs_g, steps_g, Ls, e_rel,
                                e_abs, admm_convention, adapt_step)
    init_zu = _init_zu(proxs_g, Ls)

    x = x0
    if resume is None:
        z, u = init_zu(x)
        slack = 1.0
        step_scale = (torch.ones((), dtype=dtype, device=device)
                      if adapt_step else 1.0)
        r_prev = map_leaves(torch.zeros_like, z)
        it0 = tot0 = 0
        conv = diverged = False
    else:
        # the Z/U splitting, the slack, the residual-balancing multiplier,
        # the stall detector's residual and both clocks continue: the `it`
        # clock is restart-resettable (the stall detector's `it > 1` guard
        # and the stop bound key on it), so only carrying it walks the
        # uninterrupted trajectory; max_iter still means "this many further
        # steps" through the shifted bounds
        z, u, r_prev = (map_leaves(lambda t: as_tensor(t, device=device),
                                   resume[k]) for k in ("z", "u", "r_prev"))
        slack = float(resume["slack"])
        step_scale = (as_tensor(resume["step_scale"], dtype, device)
                      if adapt_step else 1.0)
        it0, tot0 = int(resume.get("it", 0)), int(resume.get("total_it", 0))
        conv = bool(resume.get("converged", False))
        diverged = bool(resume.get("diverged", False))
    it, total_it = it0, tot0
    rows = max(M, 1)
    errors_arr = torch.zeros((rows, 4), dtype=dtype, device=device)
    history = (torch.zeros((2 * max_iter, rows, 4), dtype=dtype,
                           device=device) if trace else None)

    def go():
        # it0 + max_iter is the bound the uninterrupted solve runs under
        return (it < it0 + max_iter
                and total_it < tot0 + _RESTART_BUDGET * max_iter
                and not conv and not diverged)

    while go():
        if callback is not None:
            try:
                callback(x, it=it)
            except StopIteration:
                break
        (x_new, z, u, r, errors_arr, conv_t, nonfinite, stall,
         step_scale) = iteration(x, z, u, r_prev, it, slack, step_scale)
        it += 1
        if trace:
            # 2 * max_iter rows, not the whole restart budget; a restart
            # storm beyond that overwrites the last row
            history[min(total_it - tot0, history.shape[0] - 1)] = local_of(
                errors_arr)

        # the one blocking read of the iteration
        flags = [conv_t, nonfinite] + ([] if stall is None else [stall])
        flags = host_values(torch.stack(flags))
        conv, diverged = flags[0], diverged or flags[1]
        x, r_prev = x_new, r
        total_it += 1
        if len(flags) == 3 and flags[2]:
            slack = slack / 2
            it = 0
            z, u = init_zu(x)

    return ADMMState(
        x=x, z=z, u=u, it=it, total_it=total_it, slack=slack,
        converged=conv, errors=errors_arr, r_prev=r_prev, history=history,
        step_scale=step_scale, total_it0=tot0, it0=it0, diverged=diverged)


def _sdmm_lanes(x0, prox_f, step_f, proxs_g, steps_g, Ls, e_rel, e_abs,
                max_iter, admm_convention=True, adapt_step=False):
    """The lanes controller of :func:`_sdmm_core` (a fresh solve under
    ``torch.func.vmap``): the same iteration, with the restart taken per
    lane by ``torch.where`` (the slack and the clocks are 0-d tensors) and
    each lane stopped by its own flags and clocks. Returns the final state
    as a dict."""
    M = len(proxs_g)
    _check_adapt(adapt_step, steps_g)
    dtype, device = x0.dtype, x0.device
    iteration = _make_iteration(prox_f, step_f, proxs_g, steps_g, Ls, e_rel,
                                e_abs, admm_convention, adapt_step)
    init_zu = _init_zu(proxs_g, Ls)
    z, u = init_zu(x0)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    false = torch.zeros((), dtype=torch.bool, device=device)
    st = dict(x=x0, z=z, u=u, r_prev=map_leaves(torch.zeros_like, z),
              it=zero, total_it=zero,
              slack=torch.ones((), dtype=dtype, device=device),
              step_scale=(torch.ones((), dtype=dtype, device=device)
                          if adapt_step else 1.0),
              converged=false, diverged=false,
              errors=torch.zeros((max(M, 1), 4), dtype=dtype, device=device))

    def step(st, _):
        (x_new, z, u, r, errors_arr, conv_t, nonfinite, stall,
         step_scale) = iteration(st["x"], st["z"], st["u"], st["r_prev"],
                                 st["it"], st["slack"], st["step_scale"])
        it, slack = st["it"] + 1, st["slack"]
        if stall is not None:
            z0, u0 = init_zu(x_new)
            z = select_lanes(stall, z0, z)
            u = select_lanes(stall, u0, u)
            slack = torch.where(stall, slack / 2, slack)
            it = torch.where(stall, torch.zeros_like(it), it)
        st.update(x=x_new, z=z, u=u, r_prev=r, it=it,
                  total_it=st["total_it"] + 1, slack=slack,
                  step_scale=step_scale, converged=conv_t,
                  diverged=torch.logical_or(st["diverged"], nonfinite),
                  errors=errors_arr)

    def stopped(st):
        return (st["converged"] | st["diverged"] | (st["it"] >= max_iter)
                | (st["total_it"] >= _RESTART_BUDGET * max_iter))

    run_lanes(st, step, stopped, _RESTART_BUDGET * max_iter, device)
    return st


def _finish(state, originals, trace, multi):
    """What ``admm`` and ``sdmm`` report from a final state."""
    # fresh solves report the reference's restart-relative counter; resumed
    # solves report this call's steps (restarts included): the continued
    # restart-relative `it` would overcount the call
    this_call = state.total_it - state.total_it0
    iterations = state.it if state.total_it0 == 0 else this_call
    logger.info("Completed %d iterations", iterations)
    status = status_from(state.converged, state.diverged, logger)
    errors = tuple(tuple(row) for row in host_values(state.errors))
    if not multi:
        errors = errors[0]
    history = (state.history[:min(this_call, state.history.shape[0])]
               .cpu().numpy() if trace else None)
    writeback(originals, (state.x,))
    return dict(
        x=state.x, iterations=iterations, converged=state.converged,
        errors=errors, slack=float(state.slack), total_iterations=this_call,
        history=history, status=status, state=_resume_state(state))


def admm(
    X,
    prox_f,
    step_f,
    prox_g=None,
    step_g=None,
    L=None,
    e_rel=1e-6,
    e_abs=0,
    max_iter=1000,
    callback=None,
    trace=False,
    adapt_step=False,
    state=None,
    device=None,
):
    """Linearized Alternating Direction Method of Multipliers.

    Minimizes ``f(x) + g(L x)`` for two proxable functions, with ``step_g``
    defaulting to ``step_f * ||L||_s^2`` and the stall-restart heuristic.

    Args:
        X: initial iterate. A NumPy array goes to ``device`` and is updated
            in place; a tensor stays on its device.
        prox_f, prox_g: ``prox(X, step)`` on tensors; ``prox_g=None`` is
            the plain fixed-point method on ``prox_f``.
        step_f: a number or ``step_f(X, it=it)``.
        L: None, a matrix (dense, scipy.sparse or ``torch.sparse``) or a
            :class:`~proxmin_tpu_torch.linop.LinearOperator`.
        callback: ``callback(X, it=it)`` before every iteration, with the
            iterate as a tensor (not to be modified); ``StopIteration``
            ends the solve.
        trace: keep the per-iteration ``(e_pri, e_dual, |R|, |S|)`` rows in
            ``.history`` (at most ``2 * max_iter`` rows).
        adapt_step: Boyd sec. 3.4.1 residual balancing with dual rescaling:
            a mis-scaled ``step_f`` is corrected on the fly. Needs
            ``step_g=None``.
        state: a previous solve's ``.state``, with its ``.x`` as ``X``: the
            Z/U splitting variables, the slack, the multiplier, the stall
            detector's residual and the clocks continue where that solve
            stopped; a resumed solve runs up to ``max_iter`` further
            iterations.
        device: where NumPy inputs go (default: the CUDA device; without
            one, pass ``device="cpu"``).

    Returns:
        ``SolverResult`` unpacking as ``(converged, error)`` with ``.x``,
        ``.iterations``, ``.slack``, ``.errors``, ``.total_iterations``,
        ``.history``, ``.status`` and ``.state``.
    """
    (x0,), originals, _ = tupleize(X, device)
    has_g = prox_g is not None
    Lop = as_linear_operator(L, device=x0.device)
    final = _sdmm_core(
        x0, prox_f, step_f, (prox_g,) if has_g else (),
        (step_g,) if has_g else (), (Lop,) if has_g else (),
        e_rel, e_abs, max_iter, callback, trace=trace,
        adapt_step=adapt_step, resume=state)
    out = _finish(final, originals, trace, multi=False)
    return SolverResult((out["converged"], out["errors"]), **out)


def sdmm(
    X,
    prox_f,
    step_f,
    proxs_g=None,
    steps_g=None,
    Ls=None,
    e_rel=1e-6,
    e_abs=0,
    max_iter=1000,
    callback=None,
    trace=False,
    adapt_step=False,
    state=None,
    device=None,
):
    """Simultaneous-Direction Method of Multipliers (M constraints).

    Linearized ADMM extended to a list of constraints ``proxs_g = [g_1 ..
    g_M]``, each with its own linear operator ``Ls[i]``; falls back to
    :func:`admm` when ``proxs_g`` is not a list, forwarding ``e_abs`` (so
    the scalar and the one-element-list spellings stop alike). The other
    arguments are :func:`admm`'s.

    Returns:
        ``BoolResult``, truthy iff converged, with ``.x``, ``.iterations``,
        ``.errors`` (one row per constraint), ``.slack``,
        ``.total_iterations``, ``.history``, ``.status`` and ``.state``.
    """
    if proxs_g is None or not hasattr(proxs_g, "__iter__"):
        return admm(
            X, prox_f, step_f, prox_g=proxs_g, step_g=steps_g, L=Ls,
            e_rel=e_rel, e_abs=e_abs, max_iter=max_iter, callback=callback,
            trace=trace, adapt_step=adapt_step, state=state, device=device,
        )

    (x0,), originals, _ = tupleize(X, device)
    M = len(proxs_g)
    if not hasattr(Ls, "__iter__"):
        Ls = [Ls] * M
    assert len(Ls) == M
    Lops = tuple(as_linear_operator(Li, device=x0.device) for Li in Ls)
    if steps_g is None:
        steps_g = (None,) * M
    else:
        assert len(steps_g) == M
        steps_g = tuple(steps_g)

    final = _sdmm_core(
        x0, prox_f, step_f, tuple(proxs_g), steps_g, Lops, e_rel, e_abs,
        max_iter, callback, trace=trace, admm_convention=False,
        adapt_step=adapt_step, resume=state)
    out = _finish(final, originals, trace, multi=True)
    return BoolResult(out["converged"], **out)
