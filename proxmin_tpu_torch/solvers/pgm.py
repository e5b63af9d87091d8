"""Proximal Gradient Method (ISTA / FISTA) as a host loop over tensor ops.

Counterpart of :func:`proxmin_tpu.solvers.pgm.pgm`, including its
segmented mode for strided steppers (one loop here). The JAX driver runs the
whole solve in one ``lax.while_loop`` with the stop test on the device
(``proxmin_tpu/solvers/pgm.py:337-340``). Here the loop runs on the host:
every iteration's math stays on the iterates' device, and the stop flags
(converged per block, diverged) are read back once per iteration, a single
device-to-host copy of one bool. The body is the JAX body term for term,
so the stopping iteration is the JAX driver's.
"""

import functools
import logging

import torch

from .. import utils
from ..utils import (fixed_point_norms, fixed_point_verdict, make_stepper,
                     nesterov_next)
from .common import (SolverResult, normalize_per_block, normalize_prox,
                     status_from, tupleize, writeback)

logger = logging.getLogger("proxmin")

__all__ = ["pgm"]

_LATER = "see ROADMAP.md Queue 1 item 4 (PGM driver)"


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


def _step(st, it, grad, stepper, prox, e_rel, accelerated, restart):
    """One PGM iteration on the carry (the JAX body, term for term)."""
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
    x_new = []
    for j in range(n):
        step_j = st["T"][j] * S[j]
        x_new.append(prox[j](x_ex[j] - step_j * G[j], step_j))
    x_new = tuple(x_new)

    verdicts = [fixed_point_verdict(*fixed_point_norms(x_new[j], x_old[j]),
                                    e_rel[j]) for j in range(n)]
    st["converged"] = torch.stack([c for c, _ in verdicts])
    finite = torch.stack([f for _, f in verdicts]).all()
    if accelerated and restart:
        # O'Donoghue & Candes adaptive restart: reset the momentum clock
        # when the extrapolation overshoots
        osc = sum(torch.sum((x_ex[j] - x_new[j]) * (x_new[j] - x_old[j]))
                  for j in range(n))
        t_next = torch.where(osc > 0, torch.ones_like(t_next), t_next)
    st["x_prev"] = x_old if accelerated else ()
    st["x"] = x_new
    st["t"] = t_next
    st["S"] = S
    st["diverged"] = torch.logical_or(st["diverged"],
                                      torch.logical_not(finite))


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
        grad: ``grad(*X) -> dX`` (a tuple for several blocks).
        step: step size(s), a callable ``step(*X, it=..., [grads=...])``
            or a stepper object.
        prox: proximal operator(s) ``prox(X, step)``; None is the identity.
        accelerated: Nesterov/FISTA momentum.
        restart: with ``accelerated``, gradient-based adaptive restart.
        e_rel: relative fixed-point tolerance (scalar or per block).
        max_iter: iteration cap (a resumed solve runs up to this many more).
        state: a previous solve's ``.state`` to continue from, together
            with its ``.x``.
        device: where NumPy inputs go (default: the CUDA device; without
            one, pass ``device="cpu"``).

    ``backtracking``, ``f``, ``callback`` and ``trace`` are not ported yet.

    Returns:
        ``SolverResult`` unpacking as ``(converged, G, S)``, with ``.x``,
        ``.iterations``, ``.converged``, ``.status`` and ``.state``.
    """
    if backtracking or f is not None:
        raise NotImplementedError(f"pgm backtracking / f= is not ported yet "
                                  f"({_LATER})")
    if callback is not None:
        raise NotImplementedError(f"pgm callback= is not ported yet ({_LATER})")
    if trace:
        raise NotImplementedError(f"pgm trace= is not ported yet ({_LATER})")
    if grad is None:
        raise NotImplementedError(
            f"pgm grad=None (autodiff of f) is not ported yet ({_LATER})")

    x0, originals, was_single = tupleize(X, device)
    n = len(x0)
    prox = normalize_prox(prox, n)
    e_rel = normalize_per_block(e_rel, n)
    # a strided stepper refreshes inside _step, on the host's next-refresh
    # clock: in a host loop that is the JAX driver's segmented mode too
    # (refresh at a segment boundary, frozen steps in between), and a
    # resume that lands mid-segment or on a boundary follows the carried
    # clock
    stepper = make_stepper(step, n)

    st = _init_state(x0, n, accelerated, state)
    if st["stepper_state"] is None:
        st["stepper_state"] = stepper.init_state(x0, None)
    st["S"] = tuple(torch.zeros((), dtype=st["t"].dtype,
                                device=st["t"].device) for _ in range(n))
    it = 0
    # one host read per iteration: the loop-continue flag
    go = torch.logical_not(torch.logical_or(st["converged"].all(),
                                            st["diverged"]))
    while it < max_iter and bool(go):
        _step(st, it, grad, stepper, prox, e_rel, accelerated, restart)
        it += 1
        go = torch.logical_not(torch.logical_or(st["converged"].all(),
                                                st["diverged"]))

    G_fin = utils._as_tuple(grad(*st["x"]))
    iterations = it
    logger.info("Completed %d iterations", iterations)
    converged = tuple(bool(c) for c in st["converged"].tolist())
    diverged = bool(st["diverged"])
    status = status_from(all(converged), diverged, logger)

    writeback(originals, st["x"])
    x_out = st["x"][0] if was_single else st["x"]
    G = G_fin[0] if was_single else G_fin
    S = st["S"][0] if was_single else st["S"]
    resume_state = {
        "x_prev": st["x_prev"], "t": st["t"], "T": st["T"],
        "f_prev": st["f_prev"], "stepper_state": st["stepper_state"],
        "it": iterations + st["it0"],
        "converged": st["converged"], "diverged": st["diverged"],
    }
    return SolverResult(
        (converged, G, S),
        x=x_out, iterations=iterations, converged=converged, G=G, S=S,
        history=None, status=status, state=resume_state,
    )
