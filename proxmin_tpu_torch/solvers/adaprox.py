"""AdaProx: adaptive proximal gradient (the Adam family) with prox
sub-iterations, as a host loop over tensor ops.

Counterpart of :func:`proxmin_tpu.solvers.adaprox.adaprox` (Melchior,
Joseph & Moolekamp, arXiv:1910.10094, Algorithm 1): six adaptive schemes
(Adam, NAdam, AMSGrad, PAdam, AdamX, RAdam) as Φ/Ψ functions over the
moments, followed per block by either the prox sub-iterations or, for
separable proxs, their exact closed form.

The JAX driver runs the solve in one ``lax.while_loop`` and the
sub-iterations in a nested one. Here both loops run on the host: the math
stays on the iterates' device, and the stop flags are read back once per
iteration and once per prox sub-iteration (the sub-loop's test decides
whether another sub-iteration runs); ``callback=`` and ``trace=`` add no
read. Under ``torch.func.vmap`` (``functional.make_adaprox_solver``) the
sub-iterations run as rounds over all the lanes, one read per round
(:func:`_prox_subloop_lanes`). Scalars that JAX computes as traced
scalars (bias corrections, the RAdam rectification) are computed on the
host in the block's dtype, so they cost no launch and no read.

The same deliberate fix as the JAX package: ``Vhat`` starts at zeros and
always accumulates (the reference never writes its running max back when
``Vhat=None``, so AMSGrad/PAdam/AdamX silently lose their max there).
"""

import functools
import logging
import math

import numpy as np
import torch

from .. import utils
from ..utils import fixed_point_norms, fixed_point_verdict, l2sq, make_stepper
from .common import (SolverResult, any_lane, as_tensor, as_torch_dtype,
                     check_stepper_state, grad_from_f, host_values,
                     local_of, normalize_per_block, normalize_prox,
                     separable_blocks, tupleize, writeback)

logger = logging.getLogger("proxmin")

__all__ = ["adaprox", "SCHEMES", "normalize_b1_schedule"]

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


# ---------------------------------------------------------------------------
# Φ/Ψ schemes, with the JAX package's signature:
#   (it, G, M, V, Vhat, b1, b2, eps, p, it0=0) -> (Phi, Psi, M', V', Vhat')
# ``b1`` is the schedule as a NumPy array and ``b2`` a NumPy scalar, both in
# the block's dtype; ``it`` (local, indexes the schedule) and ``it0`` (the
# global offset of a resumed solve, entering only the bias-correction clock
# t = it + it0 + 1) are Python ints. Each scheme is two parts: its scalar
# factors, NumPy scalars of the block dtype computed on the host from the
# clock, and their application to the tensors (as Python floats in the
# driver; an exported loop reads the same values from a table indexed by
# its counter, see :func:`scheme_table`, or, with a constant b1, computes
# them by the same expressions on 0-d CPU tensors from a clock kept on the
# host: ``b1`` a (1,) tensor, ``b2`` a 0-d one, ``it`` 0 and ``it0`` the
# clock, an int64 tensor).

def _moments(G, M, V, s):
    M_new = s[0] * G + s[1] * M
    V_new = s[2] * (G ** 2) + s[3] * V
    return M_new, V_new


def _moment_scalars(it, b1, b2, it0=0):
    """The moments' factors (amsgrad's and padam's whole set)."""
    return (1 - b1[it], b1[it], 1 - b2, b2)


def _floor(X, v):
    """``max(X, v)`` for a scalar ``v``, NaN-propagating like
    ``jnp.maximum``. ``v`` is filled on the device: ``X.new_tensor(v)``
    would copy it from host memory, which makes the host wait for the
    stream."""
    return torch.maximum(X, torch.full((), v, dtype=X.dtype,
                                       device=X.device))


def _adam_scalars(it, b1, b2, it0):
    t = it + it0 + 1
    return _moment_scalars(it, b1, b2) + (1 - b1[it] ** t, 1 - b2 ** t)


def _adam_apply(G, M, V, Vhat, s, eps, p):
    M, V = _moments(G, M, V, s)
    Phi = M / s[4]
    Psi = torch.sqrt(V / s[5]) + eps
    return Phi, Psi, M, V, Vhat


def _nadam_apply(G, M, V, Vhat, s, eps, p):
    M, V = _moments(G, M, V, s)
    Phi = (s[1] * M + s[0] * G) / s[4]
    Psi = torch.sqrt(V / s[5]) + eps
    return Phi, Psi, M, V, Vhat


def _amsgrad_apply(G, M, V, Vhat, s, eps, p):
    M, V = _moments(G, M, V, s)
    Vhat = torch.maximum(Vhat, V)
    # eps clamps the returned Psi only, not the stored Vhat
    Psi = torch.sqrt(_floor(Vhat, eps)) if eps > 0 else torch.sqrt(Vhat)
    return M, Psi, M, V, Vhat


def _padam_apply(G, M, V, Vhat, s, eps, p):
    M, V = _moments(G, M, V, s)
    Vhat = torch.maximum(Vhat, V)
    Psi = (_floor(Vhat, eps) if eps > 0 else Vhat) ** p
    return M, Psi, M, V, Vhat


def _adamx_scalars(it, b1, b2, it0):
    # the factor is irrelevant at it == 0 (Vhat starts at 0); clamp the
    # index so the schedule is not read before its start
    prev = max(it - 1, 0)
    factor = (1 - b1[it]) ** 2 / (1 - b1[prev]) ** 2
    return _moment_scalars(it, b1, b2) + (factor,)


def _adamx_apply(G, M, V, Vhat, s, eps, p):
    M, V = _moments(G, M, V, s)
    Vhat = torch.maximum(s[4] * Vhat, V)
    Psi = torch.sqrt(_floor(Vhat, eps)) if eps > 0 else torch.sqrt(Vhat)
    return M, Psi, M, V, Vhat


def _radam_scalars(it, b1, b2, it0):
    rho_inf = 2 / (1 - b2) - 1
    t = it + it0 + 1
    rho = rho_inf - 2 * t * b2 ** t / (1 - b2 ** t)
    head = _moment_scalars(it, b1, b2) + (1 - b1[it] ** t, 1 - b2 ** t)
    rectified = rho > 4

    def r_arg():
        return ((rho - 4) * (rho - 2) * rho_inf / (rho_inf - 4)
                / (rho_inf - 2) / rho)

    if isinstance(rho, torch.Tensor):
        # a program's clock: both branches, the rectified one where it holds
        tiny = torch.finfo(rho.dtype).tiny
        r = torch.where(rectified, torch.sqrt(torch.clamp_min(r_arg(), tiny)),
                        torch.ones_like(rho))
        return head + (r, rectified.to(rho.dtype))
    r = b2.dtype.type(1)
    if rectified:
        r = np.sqrt(np.maximum(r_arg(), np.finfo(b2.dtype).tiny))
    return head + (r, float(rectified))


def _radam_apply(G, M, V, Vhat, s, eps, p):
    M, V = _moments(G, M, V, s)
    Phi = M / s[4]
    if isinstance(s[7], torch.Tensor):
        # a table's row: both branches, the rectified one where it holds
        Psi = torch.where(s[7] > 0, torch.sqrt(V / s[5]) / s[6],
                          torch.ones_like(V))
    elif s[7]:
        Psi = torch.sqrt(V / s[5]) / s[6]
    else:
        Psi = torch.ones_like(V)
    if eps > 0:
        Psi = _floor(Psi, math.sqrt(eps))
    return Phi, Psi, M, V, Vhat


def _scheme(scalars, apply):
    def phi_psi(it, G, M, V, Vhat, b1, b2, eps, p, it0=0):
        s = tuple(float(v) for v in scalars(it, b1, b2, it0))
        return apply(G, M, V, Vhat, s, eps, p)

    phi_psi.scalars, phi_psi.apply = scalars, apply
    return phi_psi


_adam_phi_psi = _scheme(_adam_scalars, _adam_apply)
_nadam_phi_psi = _scheme(_adam_scalars, _nadam_apply)
_amsgrad_phi_psi = _scheme(_moment_scalars, _amsgrad_apply)
_padam_phi_psi = _scheme(_moment_scalars, _padam_apply)
_adamx_phi_psi = _scheme(_adamx_scalars, _adamx_apply)
_radam_phi_psi = _scheme(_radam_scalars, _radam_apply)

SCHEMES = {
    "adam": _adam_phi_psi,
    "nadam": _nadam_phi_psi,
    "amsgrad": _amsgrad_phi_psi,
    "padam": _padam_phi_psi,
    "adamx": _adamx_phi_psi,
    "radam": _radam_phi_psi,
}


def scheme_table(phi_psi, b1, b2, n_iter, dtype, device):
    """The scalar factors of ``phi_psi`` for the local iterations ``0 ..
    n_iter - 1`` of a fresh solve, as an ``(n_iter, m)`` tensor of
    ``dtype`` on ``device``: row ``it`` holds the values the driver
    applies as Python floats at that iteration, so a loop whose counter is
    a tensor applies the same numbers."""
    np_dt = _NP_DTYPE[dtype]
    b1, b2 = b1.astype(np_dt), np_dt(b2)
    rows = [[float(v) for v in phi_psi.scalars(it, b1, b2, 0)]
            for it in range(n_iter)]
    return torch.tensor(rows, dtype=dtype).to(device)


def table_phi_psi(phi_psi, table):
    """``phi_psi`` reading its scalar factors from row ``it`` of
    :func:`scheme_table`'s ``table`` (``it`` a 0-d integer tensor)."""
    def table_scheme(it, G, M, V, Vhat, b1, b2, eps, p, it0=0):
        row = torch.index_select(table, 0, it.reshape(1).long())[0]
        s = tuple(row[i] for i in range(table.shape[1]))
        return phi_psi.apply(G, M, V, Vhat, s, eps, p)

    return table_scheme


def normalize_b1_schedule(b1, max_iter):
    """The per-iteration b1 schedule as a NumPy array of length
    ``max_iter``: a scalar broadcasts; a sequence must have exactly
    ``max_iter`` entries in [0, 1) (a short one would otherwise be read
    past its end)."""
    if not hasattr(b1, "__iter__"):
        b1 = np.full((max_iter,), b1, dtype=np.float64)
    b1 = np.asarray(b1)
    if b1.ndim != 1 or b1.shape[0] != max_iter:
        raise ValueError(f"the b1 schedule has shape {b1.shape}; it needs "
                         f"one value per iteration ({max_iter},)")
    if not ((b1 >= 0).all() and (b1 < 1).all()):
        raise ValueError("b1 values must lie in [0, 1)")
    return b1


def _check_options(scheme, b1, b2, eps, p, max_iter):
    """Validate the scheme's options: ``(b1 schedule, phi_psi)``."""
    b1 = normalize_b1_schedule(b1, max_iter)
    if not 0 <= b2 < 1:
        raise ValueError(f"b2 must lie in [0, 1), got {b2}")
    if eps < 0:
        raise ValueError(f"eps must be >= 0, got {eps}")
    if not 0 < p <= 0.5:
        raise ValueError(f"p must lie in (0, 0.5], got {p}")
    scheme = scheme.lower()
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; one of "
                         f"{sorted(SCHEMES)}")
    return b1, SCHEMES[scheme]


def _prox_subloop(prox_j, x_j, alpha_j, Psi, e_rel_j, prox_max_iter):
    """Solve the scaled proximal problem by fixed-point sub-iterations
    ``z <- prox(z - (gamma/alpha) Psi (z - x_j), gamma)`` with
    ``gamma = alpha / max(Psi)``, until
    ``||z' - z||^2 <= e_rel^2 ||z||^2`` or ``prox_max_iter`` of them.
    One host read per sub-iteration. Returns ``(z, tau)``."""
    psi_max = torch.max(Psi)
    gamma = alpha_j / psi_max
    scale = Psi / psi_max  # == (gamma / alpha) * Psi elementwise
    z, tau = x_j, 0
    while tau < prox_max_iter:
        z_new = prox_j(z - scale * (z - x_j), gamma)
        done = l2sq(z_new - z) <= e_rel_j ** 2 * l2sq(z)
        z, tau = z_new, tau + 1
        if bool(done):
            break
    return z, tau


def _prox_subloop_lanes(prox_j, x_j, alpha_j, Psi, e_rel_j, prox_max_iter,
                        live):
    """:func:`_prox_subloop` under ``torch.func.vmap``: each lane has its
    own stop test and count ``tau`` (a 0-d int32 tensor), and the rounds
    run while any ``live`` lane (one the lanes controller still runs) is
    not done, one blocking read of every lane's test per round after the
    first; ``z`` and ``tau`` advance only in the lanes still running, as
    ``lax.while_loop`` runs them under ``jax.vmap``. A lane still running
    after round ``r`` has ``tau == r``, so the cap is the host's round
    count. Returns ``(z, tau)``."""
    psi_max = torch.max(Psi)
    gamma = alpha_j / psi_max
    scale = Psi / psi_max
    z = x_j
    tau = torch.zeros((), dtype=torch.int32, device=x_j.device)
    run = live
    for r in range(prox_max_iter):
        if r and not any_lane(run):
            break
        z_new = prox_j(z - scale * (z - x_j), gamma)
        done = l2sq(z_new - z) <= e_rel_j ** 2 * l2sq(z)
        z = torch.where(run, z_new, z)
        tau = tau + run.to(torch.int32)
        run = torch.logical_and(run, torch.logical_not(done))
    return z, tau


def _prox_subloop_traced(prox_j, x_j, alpha_j, Psi, e_rel_j, prox_max_iter,
                         reduce=None):
    """:func:`_prox_subloop` as a ``while_loop`` that ``torch.export``
    captures (its condition reads the stop test once per sub-iteration, as
    the host loop does). ``reduce(t, op)`` completes the block's max and
    sums over the ranks that share it (a per-rank program of a sharded
    block). Returns ``(z, tau)`` with ``tau`` a 0-d int32 tensor."""
    from torch._higher_order_ops.while_loop import while_loop

    if reduce is None:
        def reduce(t, op):
            return t

    psi_max = reduce(torch.max(Psi), "max")
    gamma = alpha_j / psi_max
    scale = Psi / psi_max

    def cond(z, tau, done):
        return torch.logical_and(tau < prox_max_iter,
                                 torch.logical_not(done))

    def body(z, tau, done):
        z_new = prox_j(z - scale * (z - x_j), gamma)
        done = (reduce(l2sq(z_new - z), "sum")
                <= e_rel_j ** 2 * reduce(l2sq(z), "sum"))
        return z_new, tau + 1, done

    tau0 = torch.zeros((), dtype=torch.int32, device=x_j.device)
    done0 = torch.zeros((), dtype=torch.bool, device=x_j.device)
    z, tau, _ = while_loop(cond, body, (x_j, tau0, done0))
    return z, tau


def _step(st, it, grad, stepper, prox, has_prox, separable, phi_psi, b1, b2,
          eps, p, e_rel, check_convergence, prox_max_iter, moment_dtype,
          trace, subloop=_prox_subloop, reduce=None):
    """One AdaProx iteration on the carry (the JAX body, term for term):
    the loop body that the driver and ``functional.make_adaprox_solver``
    share. It reads the host only in the prox sub-iterations (``subloop``,
    or :func:`_prox_subloop_traced` in an exported program). ``reduce(j,
    t, op)`` completes block ``j``'s norms and the sub-iterations' sums
    and max over the ranks that share the block: a per-rank program of a
    sharded solve, whose blocks are local shards."""
    n = len(prox)
    x = st["x"]
    G = utils._as_tuple(grad(*x))
    Alpha, st["stepper_state"] = stepper(st["stepper_state"], x,
                                         it + st["it0"], G)
    x_new, M_new, V_new, Vhat_new = [], [], [], []
    for j in range(n):
        dt = x[j].dtype
        np_dt = _NP_DTYPE[dt]
        # moment_dtype stores the moments reduced; the EMA and bias math
        # computes in the block dtype (cast up here, down on store)
        Mj, Vj, Vhatj = (m.to(dt) for m in (st["M"][j], st["V"][j],
                                            st["Vhat"][j]))
        Phi, Psi, Mj, Vj, Vhatj = phi_psi(
            it, G[j], Mj, Vj, Vhatj, b1.astype(np_dt), np_dt(b2), eps, p,
            it0=st["it0"])
        if moment_dtype is not None:
            Mj, Vj, Vhatj = (m.to(moment_dtype) for m in (Mj, Vj, Vhatj))
        xj = x[j] - Alpha[j] * Phi / Psi
        if has_prox[j] and separable[j]:
            # the exact closed form of the scaled prox: the prox with the
            # per-element step alpha / Psi_i, one application
            gamma_el = Alpha[j] / _floor(Psi, float(torch.finfo(dt).tiny))
            xj = prox[j](xj, gamma_el)
            st["sub_iters"][j] += 1
        elif has_prox[j]:
            kw = ({} if reduce is None
                  else {"reduce": functools.partial(reduce, j)})
            xj, tau = subloop(prox[j], xj, Alpha[j], Psi, e_rel[j],
                              prox_max_iter, **kw)
            st["sub_iters"][j] = st["sub_iters"][j] + tau
        x_new.append(xj)
        M_new.append(Mj)
        V_new.append(Vj)
        Vhat_new.append(Vhatj)

    if check_convergence or trace:
        # one pair of reductions per block serves the convergence test, the
        # divergence detector and the trace residual
        norms = [fixed_point_norms(x_new[j], x[j]) for j in range(n)]
        if reduce is not None:
            norms = [(reduce(j, d, "sum"), reduce(j, nx, "sum"))
                     for j, (d, nx) in enumerate(norms)]
        verdicts = [fixed_point_verdict(d, nx, e_rel[j])
                    for j, (d, nx) in enumerate(norms)]
        if check_convergence:
            st["converged"] = torch.stack([c for c, _ in verdicts])
        finite = torch.stack([f for _, f in verdicts]).all()
        if trace:
            st["history"].append(torch.stack([
                torch.sqrt(d / torch.clamp_min(nx, 1e-30))
                for d, nx in norms]).to(st["history_dtype"]))
    else:
        finite = torch.stack([torch.isfinite(x_new[j]).all()
                              for j in range(n)]).all()
    st["x"], st["M"], st["V"], st["Vhat"] = (
        tuple(x_new), tuple(M_new), tuple(V_new), tuple(Vhat_new))
    st["diverged"] = torch.logical_or(st["diverged"],
                                      torch.logical_not(finite))


def _stopped(st, check_convergence):
    """The loop's stop flag on the device: diverged, or every block
    converged when the test is on."""
    stop = st["diverged"]
    if check_convergence:
        stop = torch.logical_or(stop, st["converged"].all())
    return stop


def adaprox(
    X,
    grad,
    step,
    prox=None,
    scheme="adam",
    b1=0.9,
    b2=0.999,
    eps=1e-8,
    check_convergence=True,
    p=0.25,
    e_rel=1e-6,
    max_iter=1000,
    prox_max_iter=1000,
    M=None,
    V=None,
    Vhat=None,
    callback=None,
    trace=False,
    f=None,
    separable_prox=False,
    moment_dtype=None,
    state=None,
    device=None,
):
    """Adaptive Proximal Gradient Method (proximal Adam family).

    Args:
        X: initial iterate, a tensor/array or a list of them (blocks).
            NumPy inputs go to ``device`` and are updated in place; tensors
            stay on their device.
        grad: ``grad(*X) -> dX`` (a tuple for several blocks). ``None``
            differentiates ``f`` by ``torch.autograd``
            (:func:`~proxmin_tpu_torch.solvers.common.grad_from_f`).
        step: step size(s) ``alpha``, a callable ``step(*X, it=...)`` or a
            stepper object; per-element steps broadcast.
        prox: proximal operator(s) ``prox(X, step)``. Blocks whose prox is
            None get no prox step at all (as in the reference).
        scheme: ``"adam"``, ``"nadam"``, ``"amsgrad"``, ``"padam"``,
            ``"adamx"`` or ``"radam"``.
        b1: scalar or per-iteration schedule of ``max_iter`` values.
        b2, eps, p: the moment decay, the denominator floor and PAdam's
            power.
        check_convergence: test ``||x' - x|| <= e_rel ||x'||`` per block;
            without it the solve runs ``max_iter`` iterations (divergence
            still stops it).
        e_rel: relative tolerance (scalar or per block), also the prox
            sub-iterations' tolerance.
        prox_max_iter: cap on the prox sub-iterations per iteration.
        M, V, Vhat: warm start from a previous run's moments (the
            bias-correction clock restarts, as in the reference).
        callback: ``callback(*X, it=it)`` before every iteration, with the
            blocks as tensors (not to be modified) and ``it`` counted from
            this call's start; ``StopIteration`` ends the solve cleanly.
        trace: record each iteration's relative fixed-point residual per
            block on the device, returned as ``.history`` of shape
            ``(iterations, n_blocks)``.
        f: the smooth function ``f(*X) -> scalar tensor``, for
            ``grad=None``.
        separable_prox: ``True`` asserts every prox has the closed-form
            scaled prox ``prox(x, alpha/Psi)`` per element, which replaces
            the sub-iterations; ``"auto"`` asks each operator's
            ``separable_when``; ``False`` (default) keeps the reference's
            sub-iterations.
        moment_dtype: store M/V/Vhat in this dtype (``torch.bfloat16`` or
            ``"bfloat16"``); the math computes in the block dtype.
        state: a previous solve's ``.state`` for an exact resume (moments,
            the global bias-correction clock, stepper state and the stop
            flags), together with its ``.x``. Excludes ``M=/V=/Vhat=``.
            With a scheduled ``b1``, pass the continuation slice. It goes
            through a file with :mod:`proxmin_tpu_torch.checkpoint`.
        device: where NumPy inputs go (default: the CUDA device; without
            one, pass ``device="cpu"``).

    Returns:
        ``SolverResult`` unpacking as ``(converged, M, V, Vhat)``, with
        ``.x``, ``.iterations``, ``.sub_iterations``, ``.converged``,
        ``.history``, ``.status`` and ``.state``.
    """
    x0, originals, was_single = tupleize(X, device)
    n = len(x0)
    if grad is None:
        assert f is not None, "grad=None requires f"
        grad = grad_from_f(f, n)
    prox_in = utils._as_tuple(prox)
    if len(prox_in) == 1:
        prox_in = prox_in * n
    # the reference runs no prox step for blocks whose prox is None;
    # remember which before normalization maps None to the identity
    has_prox = tuple(pj is not None for pj in prox_in)
    prox = normalize_prox(prox_in, n)
    e_rel = normalize_per_block(e_rel, n)
    separable = separable_blocks(prox_in, has_prox, separable_prox)

    b1, phi_psi = _check_options(scheme, b1, b2, eps, p, max_iter)
    moment_dtype = as_torch_dtype(moment_dtype)

    it0 = 0
    converged = torch.zeros((n,), dtype=torch.bool, device=x0[0].device)
    diverged = torch.zeros((), dtype=torch.bool, device=x0[0].device)
    stepper = make_stepper(step, n)
    stepper_state = stepper.init_state(x0, None)
    if state is not None:
        if M is not None or V is not None or Vhat is not None:
            raise ValueError("state= (exact resume) and M=/V=/Vhat= "
                             "(moment warm start) are mutually exclusive")
        M, V, Vhat = state["M"], state["V"], state["Vhat"]
        it0 = int(state["it"])
        if state.get("stepper_state") is not None:
            check_stepper_state(state["stepper_state"], stepper_state)
            stepper_state = state["stepper_state"]
        if state.get("converged") is not None:
            converged = as_tensor(state["converged"], torch.bool,
                                  x0[0].device).reshape((n,))
        diverged = as_tensor(state.get("diverged", False), torch.bool,
                             x0[0].device).reshape(())

    def moments(given):
        if given is None:
            return tuple(torch.zeros_like(x, dtype=moment_dtype or x.dtype)
                         for x in x0)
        given = utils._as_tuple(given)
        if len(given) != n:
            raise ValueError(f"got {len(given)} moment blocks for {n} "
                             "variable blocks")
        out = tuple(as_tensor(g, moment_dtype or x.dtype, x.device).clone()
                    for g, x in zip(given, x0))
        for g, x in zip(out, x0):
            if g.shape != x.shape:
                raise ValueError(f"moment block of shape {tuple(g.shape)} "
                                 f"for an iterate of {tuple(x.shape)}")
        return out

    st = dict(x=x0, M=moments(M), V=moments(V), Vhat=moments(Vhat),
              stepper_state=stepper_state, it0=it0, converged=converged,
              diverged=diverged, sub_iters=[0] * n, history=[],
              history_dtype=functools.reduce(
                  torch.promote_types, [x.dtype for x in x0], torch.float32))

    def keep_going():
        # the one host read per iteration
        return not bool(_stopped(st, check_convergence))

    it = 0
    while it < max_iter and keep_going():
        if callback is not None:
            try:
                callback(*st["x"], it=it)
            except StopIteration:
                break
        _step(st, it, grad, stepper, prox, has_prox, separable, phi_psi, b1,
              b2, eps, p, e_rel, check_convergence, prox_max_iter,
              moment_dtype, trace)
        it += 1

    iterations = it
    sub_iterations = tuple(st["sub_iters"])
    logger.info("Completed %d iterations and %s sub-iterations", iterations,
                list(sub_iterations))
    diverged = bool(st["diverged"])
    if check_convergence:
        converged = tuple(bool(c) for c in host_values(st["converged"]))
        if not diverged and not all(converged):
            logger.warning("Solution did not converge")
    else:
        converged = (None,) * n
    if diverged:
        status = "diverged"
        logger.warning("Solution diverged (non-finite iterate)")
    elif check_convergence and all(converged):
        status = "converged"
    else:
        status = "max_iter"

    writeback(originals, st["x"])
    x_out = st["x"][0] if was_single else st["x"]
    history = None
    if trace:
        # one copy at the end
        history = local_of(torch.stack(st["history"]) if st["history"] else
                           torch.zeros((0, n), dtype=st["history_dtype"])
                           ).cpu().numpy()
    resume_state = {
        "M": st["M"], "V": st["V"], "Vhat": st["Vhat"],
        "stepper_state": st["stepper_state"],
        "it": iterations + st["it0"],
        "converged": st["converged"], "diverged": st["diverged"],
    }
    return SolverResult(
        (converged, st["M"], st["V"], st["Vhat"]),
        x=x_out, iterations=iterations, converged=converged,
        sub_iterations=sub_iterations,
        M=st["M"], V=st["V"], Vhat=st["Vhat"], history=history,
        status=status, state=resume_state,
    )
