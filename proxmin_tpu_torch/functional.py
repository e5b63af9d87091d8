"""Pure solver factories: batched solves and implicitly differentiable ones.

Counterpart of :mod:`proxmin_tpu.functional`. The host drivers
(:func:`proxmin_tpu_torch.pgm`, ...) keep the reference's calling convention
(NumPy write-back, callbacks, logging). This module builds the same solves
as functions of their inputs, for composition with ``torch.func`` and
``torch.autograd``:

* ``torch.func.vmap(solve)`` solves a batch of independent problems in one
  call: each iteration runs once over all the lanes, as batched tensor
  operations, instead of one host loop per problem.
* ``make_differentiable_*_solver`` makes a solution a node of a larger
  differentiable program by the implicit function theorem at the fixed
  point (no unrolling, memory independent of the iteration count).

**One loop body, two loop controllers.** ``make_pgm_solver``,
``make_adaprox_solver``, ``make_admm_solver``, ``make_sdmm_solver`` and
``make_bsdmm_solver`` run their driver's own iteration (the body in
:mod:`proxmin_tpu_torch.solvers`), so they cannot drift from the drivers.
Outside ``vmap`` the host loop is the driver's: one blocking read of the
stop flags per iteration, and the same iterates bit for bit. Under
``vmap`` a host loop cannot end by reading a flag (``vmap`` refuses the
``bool()`` of a batched tensor), so the lanes controller
(:func:`~proxmin_tpu_torch.solvers.common.run_lanes`) reads every lane's
stop flag at once through functorch's unwrapping (the private
``torch._C._functorch`` interface, held on the chip machine's torch by a
card test), runs while any lane is active and freezes finished lanes with
``torch.where``, as ``lax.while_loop`` does under ``jax.vmap``: every
lane's iterate, iteration count and flags equal its own solve's, and the
batch stops at its slowest lane, not at ``max_iter``. The restart of the
ADMM family is taken per lane by ``torch.where`` there.

Two inner loops depend on each lane's data and raise ``ValueError`` under
``vmap``: PGM's backtracking (``backtracking=True``) and AdaProx's prox
sub-iterations (a prox without ``separable_prox``). The differentiable
solvers and ``make_nmf_solver``'s batched form need no such loop.

Returns are tensors on the iterates' device: ``it`` a 0-d int32 tensor and
the flags bool tensors, as JAX returns arrays. NumPy inputs go to the card
unless the factory gets ``device=``.
"""

import functools
import logging

import torch
from torch.utils import _pytree as pytree

from . import operators as _ops
from . import utils
from .linop import as_linear_operator
from .nmf import (_lam_max_psd_batch, _weighted_lipschitz_S,
                  _weighted_lipschitz_S_v0, grad_likelihood)
from .solvers.adaprox import _check_options as _adaprox_options
from .solvers.adaprox import _step as _adaprox_step
from .solvers.adaprox import _stopped as _adaprox_stopped
from .solvers.admm import _check_adapt, _sdmm_core, _sdmm_lanes
from .solvers.bsdmm import _Program as _BSDMMProgram
from .solvers.pgm import _init_state as _pgm_init_state
from .solvers.pgm import _iterate as _pgm_iterate
from .solvers.pgm import _step as _pgm_step
from .solvers.common import (as_torch_dtype, grad_from_f, host_values,
                             normalize_per_block, normalize_prox,
                             promote_dtype, run_lanes, separable_blocks,
                             under_vmap)
from .utils import fixed_point_converged, make_stepper

logger = logging.getLogger("proxmin")

__all__ = ["make_pgm_solver", "make_adaprox_solver",
           "make_admm_solver", "make_sdmm_solver", "make_bsdmm_solver",
           "make_differentiable_pgm_solver",
           "make_differentiable_adaprox_solver",
           "make_differentiable_admm_solver",
           "make_differentiable_sdmm_solver",
           "make_differentiable_bsdmm_solver", "make_nmf_solver"]


def _inputs(arrays, device):
    """Tensors stay where they are; NumPy arrays go to ``device`` (by
    default the card)."""
    return tuple(promote_dtype(
        a, device=None if isinstance(a, torch.Tensor) else device)
        for a in arrays)


def _count(it, device):
    """A host iteration count as a 0-d int32 tensor, filled on the
    device."""
    return torch.full((), it, dtype=torch.int32, device=device)


def _lanes_refuse(option, why):
    return ValueError(
        f"{option} cannot run under torch.func.vmap: {why} depend on each "
        "lane's data, and a lane's host loop cannot read them there; solve "
        "the lanes one by one")


def make_pgm_solver(grad, step, prox=None, accelerated=False,
                    restart=False, backtracking=False, f=None,
                    e_rel=1e-6, max_iter=1000, device=None):
    """Build a pure PGM/FISTA solve: ``solve(*x0) -> (x, iterations,
    converged, diverged)``, ``converged`` per block.

    Same semantics as :func:`proxmin_tpu_torch.pgm` (its body) minus the
    host conveniences; ``torch.func.vmap(solve)`` runs a batch of problems
    (not with ``backtracking=True``). ``grad=None`` differentiates ``f``
    by ``torch.autograd``.
    """
    def solve(*x0):
        x0 = _inputs(x0, device)
        n = len(x0)
        dev = x0[0].device
        g = grad if grad is not None else grad_from_f(f, n)
        prox_t = normalize_prox(prox, n)
        e_rel_t = normalize_per_block(e_rel, n)
        assert backtracking is False or f is not None
        stepper = make_stepper(step, n)
        lanes = under_vmap()
        if lanes and backtracking:
            raise _lanes_refuse("backtracking=True", "its halvings")
        st = _pgm_init_state(x0, n, accelerated, None)
        st["stepper_state"] = stepper.init_state(x0, None)
        st["S"] = tuple(torch.zeros((), dtype=st["t"].dtype, device=dev)
                        for _ in range(n))
        st["history"] = []
        args = (g, stepper, prox_t, e_rel_t, accelerated, restart,
                backtracking, f, False)
        if lanes:
            it = run_lanes(
                st, lambda s, k: _pgm_step(s, k, *args),
                lambda s: torch.logical_or(s["converged"].all(),
                                           s["diverged"]), max_iter, dev)
        else:
            k = 0
            while k < max_iter:
                conv_h, div_h = _pgm_iterate(st, k, *args)
                k += 1
                if all(conv_h) or div_h:
                    break
            it = _count(k, dev)
        x = st["x"][0] if n == 1 else st["x"]
        return x, it, st["converged"], st["diverged"]

    return solve


def make_adaprox_solver(grad, step, prox=None, scheme="adam", b1=0.9,
                        b2=0.999, eps=1e-8, p=0.25, check_convergence=True,
                        e_rel=1e-6, max_iter=1000, prox_max_iter=1000,
                        f=None, separable_prox=False, moment_dtype=None,
                        device=None):
    """Build a pure AdaProx solve: ``solve(*x0) -> (x, M, V, Vhat,
    iterations, converged, diverged)`` (cold-started moments, one tensor
    per block in ``M``, ``V``, ``Vhat``).

    Same semantics as :func:`proxmin_tpu_torch.adaprox` (its body);
    ``torch.func.vmap(solve)`` runs a batch of problems when no block runs
    the prox sub-iterations (every prox separable, or none).
    """
    b1, phi_psi = _adaprox_options(scheme, b1, b2, eps, p, max_iter)
    moment_dtype = as_torch_dtype(moment_dtype)

    def solve(*x0):
        x0 = _inputs(x0, device)
        n = len(x0)
        dev = x0[0].device
        g = grad if grad is not None else grad_from_f(f, n)
        prox_in = utils._as_tuple(prox)
        if len(prox_in) == 1:
            prox_in = prox_in * n
        has_prox = tuple(pj is not None for pj in prox_in)
        prox_t = normalize_prox(prox_in, n)
        e_rel_t = normalize_per_block(e_rel, n)
        separable = separable_blocks(prox_in, has_prox, separable_prox)
        lanes = under_vmap()
        if lanes and any(h and not s for h, s in zip(has_prox, separable)):
            raise _lanes_refuse(
                "a prox without separable_prox (the prox sub-iterations)",
                "their counts")
        stepper = make_stepper(step, n)
        zeros = tuple(torch.zeros_like(x, dtype=moment_dtype or x.dtype)
                      for x in x0)
        st = dict(x=x0, M=zeros, V=zeros, Vhat=zeros,
                  stepper_state=stepper.init_state(x0, None), it0=0,
                  converged=torch.zeros((n,), dtype=torch.bool, device=dev),
                  diverged=torch.zeros((), dtype=torch.bool, device=dev),
                  sub_iters=[0] * n, history=[])

        def step_(s, k):
            _adaprox_step(s, k, g, stepper, prox_t, has_prox, separable,
                           phi_psi, b1, b2, eps, p, e_rel_t,
                           check_convergence, prox_max_iter, moment_dtype,
                           False)

        def stopped(s):
            return _adaprox_stopped(s, check_convergence)

        if lanes:
            it = run_lanes(st, step_, stopped, max_iter, dev)
        else:
            k = 0
            while k < max_iter:
                step_(st, k)
                k += 1
                if bool(stopped(st)):  # the one blocking read
                    break
            it = _count(k, dev)
        x = st["x"][0] if n == 1 else st["x"]
        return (x, st["M"], st["V"], st["Vhat"], it, st["converged"],
                st["diverged"])

    return solve


def _sdmm_solve(x0, device, proxs_g, steps_g, Ls, prox_f, step_f, e_rel,
                e_abs, max_iter, admm_convention, adapt_step):
    """``(x, iterations, converged, errors)`` of one ADMM-family solve: the
    driver's host loop, or its lanes controller under ``vmap``."""
    (x0,) = _inputs((x0,), device)
    if under_vmap():
        st = _sdmm_lanes(x0, prox_f, step_f, proxs_g, steps_g, Ls,
                               e_rel, e_abs, max_iter,
                               admm_convention=admm_convention,
                               adapt_step=adapt_step)
        return st["x"], st["it"], st["converged"], st["errors"]
    final = _sdmm_core(x0, prox_f, step_f, proxs_g, steps_g, Ls,
                             e_rel, e_abs, max_iter, None,
                             admm_convention=admm_convention,
                             adapt_step=adapt_step)
    dev = x0.device
    return (final.x, _count(final.it, dev),
            torch.full((), bool(final.converged), dtype=torch.bool,
                       device=dev), final.errors)


def make_admm_solver(prox_f, step_f, prox_g=None, step_g=None, L=None,
                     e_rel=1e-6, e_abs=0, max_iter=1000, adapt_step=False,
                     device=None):
    """Build a pure linearized-ADMM solve: ``solve(x0) -> (x, iterations,
    converged, errors)``, ``errors`` the Boyd sec. 3.3.1 residual row of
    shape ``(1, 4)``.

    Same semantics as :func:`proxmin_tpu_torch.admm`, the slack restart
    included; ``torch.func.vmap(solve)`` runs a batch of problems, each
    lane restarting on its own. ``device`` places a NumPy ``L`` and
    ``x0``.
    """
    if prox_g is None and L is not None:
        raise ValueError(
            "L is only applied inside the g-constraint (g(L x)); with "
            "prox_g=None the solve is unconstrained and L would be "
            "silently ignored — pass prox_g or drop L"
        )
    Lop = as_linear_operator(L, device=device)
    proxs_g = (prox_g,) if prox_g is not None else ()
    steps_g = (step_g,) if prox_g is not None else ()
    Ls = (Lop,) if prox_g is not None else ()
    _check_adapt(adapt_step, steps_g)

    def solve(x0):
        return _sdmm_solve(x0, device, proxs_g, steps_g, Ls, prox_f, step_f,
                           e_rel, e_abs, max_iter, True, adapt_step)

    return solve


def make_sdmm_solver(prox_f, step_f, proxs_g, steps_g=None, Ls=None,
                     e_rel=1e-6, e_abs=0, max_iter=1000, adapt_step=False,
                     device=None):
    """Build a pure SDMM solve (M simultaneous constraints):
    ``solve(x0) -> (x, iterations, converged, errors)``, ``errors`` of
    shape ``(M, 4)``.

    Same semantics as :func:`proxmin_tpu_torch.sdmm` with a list of
    constraints; batched under ``torch.func.vmap`` like
    :func:`make_admm_solver`.
    """
    proxs_g = tuple(proxs_g)
    M = len(proxs_g)
    if not hasattr(Ls, "__iter__"):
        Ls = [Ls] * M
    Lops = tuple(as_linear_operator(Li, device=device) for Li in Ls)
    steps_g = (None,) * M if steps_g is None else tuple(steps_g)
    assert len(steps_g) == M
    _check_adapt(adapt_step, steps_g)

    def solve(x0):
        return _sdmm_solve(x0, device, proxs_g, steps_g, Lops, prox_f,
                           step_f, e_rel, e_abs, max_iter, False, adapt_step)

    return solve


def _block_order(flags, order):
    """The blocks' flags (swept in ``order``, divergence last) in block
    order, on the device."""
    pos = {j: i for i, j in enumerate(order)}
    if all(pos[j] == j for j in range(len(order))):
        return flags[:-1]
    return torch.stack([flags[pos[j]] for j in range(len(order))])


def make_bsdmm_solver(proxs_f, steps_f_cb, proxs_g=None, steps_g=None,
                      Ls=None, update_order=None, steps_g_update="steps_f",
                      e_rel=1e-6, e_abs=0, max_iter=1000,
                      steps_f_stride=None, device=None):
    """Build a pure bSDMM solve: ``solve(*x_blocks) -> (x_blocks,
    iterations, converged_per_block)``.

    Same semantics as :func:`proxmin_tpu_torch.bsdmm` (its sweep);
    batched under ``torch.func.vmap``. The solver's structure (the
    normalized constraints and operators) is resolved from the blocks at
    the first call and kept per (block count, dtype, device), so repeated
    calls pay no reconstruction.
    """
    programs = {}

    def solve(*x_blocks):
        xs = _inputs(x_blocks, device)
        N = len(xs)
        dev = xs[0].device
        dtype = functools.reduce(torch.promote_types, [x.dtype for x in xs])
        key = (N, dtype, dev)
        prog = programs.get(key)
        if prog is None:
            prog = programs[key] = _BSDMMProgram(
                N, dev, proxs_f, steps_f_cb, proxs_g=proxs_g,
                steps_g=steps_g, Ls=Ls, update_order=update_order,
                steps_g_update=steps_g_update, e_rel=e_rel, e_abs=e_abs,
                steps_f_stride=steps_f_stride)
        st = prog.init_state(xs)
        st["converged"] = torch.zeros((N,), dtype=torch.bool, device=dev)
        st["diverged"] = torch.zeros((), dtype=torch.bool, device=dev)

        def sweep(s, k):
            flags, _ = prog.sweep(s, k)
            s["converged"] = _block_order(flags, prog.update_order)
            s["diverged"] = flags[-1]
            return flags

        if under_vmap():
            it = run_lanes(st, sweep,
                           lambda s: torch.logical_or(s["converged"].all(),
                                                      s["diverged"]),
                           max_iter, dev)
        else:
            k = 0
            while k < max_iter:
                flags = host_values(sweep(st, k))  # the one blocking read
                k += 1
                if all(flags[:-1]) or flags[-1]:
                    break
            it = _count(k, dev)
        return tuple(st["x"]), it, st["converged"]

    return solve


# ---------------------------------------------------------------------------
# Implicit differentiation at the fixed point

def _gap(x, x_prev):
    """``(||x - x_prev||^2, ||x||^2)`` over the leaves of two pytrees of
    one structure."""
    d = n = None
    for a, b in zip(pytree.tree_leaves(x), pytree.tree_leaves(x_prev)):
        da, na = torch.sum((a - b) * (a - b)), torch.sum(a * a)
        d, n = (da, na) if d is None else (d + da, n + na)
    return d, n


def _still_moving(x, x_prev, rtol):
    """The 0-d flag ``||x - x_prev||^2 > rtol^2 ||x||^2`` (False on NaN,
    as JAX's comparison)."""
    d, n = _gap(x, x_prev)
    return d > (rtol ** 2) * n


def _converged(x, x_prev, rtol):
    d, n = _gap(x, x_prev)
    return d <= (rtol ** 2) * n


class _ImplicitSolve(torch.autograd.Function):
    """``(x*, converged)`` with the implicit-function-theorem VJP. The
    inputs are the flattened leaves of ``(x0, theta)``; ``spec`` rebuilds
    them. ``x*`` comes out flattened, then ``converged``."""

    @staticmethod
    def forward(ctx, solver, spec, *leaves):
        x0, theta = pytree.tree_unflatten(list(leaves), spec)
        x, converged = solver.forward(x0, *theta)
        x_leaves, ctx.x_spec = pytree.tree_flatten(x)
        ctx.solver, ctx.spec = solver, spec
        ctx.n_x0 = len(pytree.tree_leaves(x0))
        ctx.is_tensor = [isinstance(leaf, torch.Tensor) for leaf in leaves]
        ctx.constants = [None if t else leaf
                         for t, leaf in zip(ctx.is_tensor, leaves)]
        ctx.save_for_backward(*x_leaves, *(leaf for leaf in leaves
                                           if isinstance(leaf, torch.Tensor)))
        ctx.n_x = len(x_leaves)
        ctx.mark_non_differentiable(converged)
        return (*x_leaves, converged)

    @staticmethod
    def backward(ctx, *cotangents):
        v = [c.detach() for c in cotangents[:ctx.n_x]]
        saved = ctx.saved_tensors
        x_star = saved[:ctx.n_x]
        given = iter(saved[ctx.n_x:])
        leaves = [next(given) if t else c
                  for t, c in zip(ctx.is_tensor, ctx.constants)]
        needs = ctx.needs_input_grad[2:]
        theta_needs = needs[ctx.n_x0:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(True) for x in x_star]
            th = [leaf.detach().requires_grad_(True) if need else
                  (leaf.detach() if isinstance(leaf, torch.Tensor) else leaf)
                  for leaf, need in zip(leaves[ctx.n_x0:], theta_needs)]
            _, theta = pytree.tree_unflatten(leaves[:ctx.n_x0] + th, ctx.spec)
            out = pytree.tree_leaves(ctx.solver.T(
                pytree.tree_unflatten(xs, ctx.x_spec), *theta))
            live = [i for i, o in enumerate(out) if o.requires_grad]

            def vjp(w, wrt, keep):
                if not wrt or not live:
                    return [torch.zeros_like(t) for t in wrt]
                return torch.autograd.grad(
                    [out[i] for i in live], wrt,
                    grad_outputs=[w[i] for i in live], retain_graph=keep,
                    allow_unused=True, materialize_grads=True)

            def step_w(w):
                return [a + b for a, b in zip(vjp(w, xs, True), v)]

            # adjoint fixed point w = A^T w + v, run to a RELATIVE RESIDUAL
            # (a fixed count silently truncates the Neumann series on an
            # ill-conditioned problem: at contraction factor q its error is
            # q^k), one blocking read per iteration
            w_prev, w = v, step_w(v)
            it, moving = 1, True
            solver = ctx.solver
            while it < solver.vjp_iters and moving:
                moving = bool(_still_moving(w, w_prev, solver.vjp_rtol))
                if moving:
                    w_prev, w = w, step_w(w)
                    it += 1
            if moving and bool(_still_moving(w, w_prev, solver.vjp_rtol)):
                # the JAX solver returns such a gradient silently
                logger.warning(
                    "the implicit gradient's adjoint stopped at vjp_iters="
                    "%d short of vjp_rtol=%g: the gradient is truncated",
                    solver.vjp_iters, solver.vjp_rtol)
            wanted = [t for t, need in zip(th, theta_needs) if need]
            grads = iter(vjp(w, wanted, False))
        out_grads = []
        for i, need in enumerate(needs):
            if not need:
                out_grads.append(None)
            elif i < ctx.n_x0:
                # the fixed point does not depend on the start
                out_grads.append(torch.zeros_like(leaves[i]))
            else:
                out_grads.append(next(grads))
        return (None, None, *out_grads)


class _FixedPoint:
    """What the VJP needs of a differentiable solve: the map ``T``, its
    forward solve and the adjoint's stopping rule."""

    def __init__(self, T, e_rel, max_iter, vjp_iters, vjp_rtol, forward):
        self.T, self.e_rel, self.max_iter = T, e_rel, max_iter
        self.vjp_iters, self.vjp_rtol = vjp_iters, vjp_rtol
        self.forward = forward or self.iterate

    def iterate(self, x0, *theta):
        """Plain fixed-point iteration to the relative tolerance, one
        blocking read per iteration."""
        x_prev, x = x0, self.T(x0, *theta)
        it = 1
        while it < self.max_iter and bool(
                _still_moving(x, x_prev, self.e_rel)):
            x_prev, x = x, self.T(x, *theta)
            it += 1
        converged = _converged(x, x_prev, self.e_rel)
        return x, converged


def _implicit_fixed_point_solver(T, e_rel, max_iter, vjp_iters, vjp_rtol,
                                 forward=None, device=None):
    """The shared implicit-differentiation scaffold: ``solve(w0, *theta)
    -> (w*, converged)`` for a locally contractive map ``T(w, *theta)``
    over a pytree state ``w`` (a tensor or nested tuples, lists, dicts of
    them). Forward, without grad: plain fixed-point iteration to the
    relative tolerance, or ``forward(w0, *theta) -> (w*, converged)``
    whose solution satisfies ``T(w*) = w*``. Backward: the adjoint fixed
    point ``v = (d_w T)^T v + cotangent`` to ``vjp_rtol`` (capped at
    ``vjp_iters``), then pushed through ``d_theta T``; the VJP of ``T`` is
    taken once at ``w*`` and reused. The ``w0`` cotangent is zero.

    It composes with ``.backward()``, ``torch.autograd.grad`` and outer
    loops around them; not with ``torch.func`` transforms (its loops read
    the host)."""
    solver = _FixedPoint(T, e_rel, max_iter, vjp_iters, vjp_rtol, forward)

    def solve(x0, *theta):
        leaves, spec = pytree.tree_flatten((x0, theta))
        # NumPy leaves go to the device; numbers stay constants
        leaves = [promote_dtype(leaf, device=device)
                  if not isinstance(leaf, torch.Tensor)
                  and hasattr(leaf, "__array__") else leaf
                  for leaf in leaves]
        out = _ImplicitSolve.apply(solver, spec, *leaves)
        x_star = pytree.tree_unflatten(list(out[:-1]),
                                       pytree.tree_structure(x0))
        return x_star, out[-1]

    return solve


def make_differentiable_pgm_solver(grad, step, prox=None, e_rel=1e-9,
                                   max_iter=1000, vjp_iters=10000,
                                   vjp_rtol=1e-9, prox_params=False,
                                   device=None):
    """Build a PGM solve differentiable in its parameters by implicit
    differentiation at the fixed point: ``solve(x0, *theta) -> (x*,
    converged)``.

    ``grad(x, *theta)`` is the smooth part's gradient, ``step`` a fixed
    scalar (< 2/L), ``prox(z, step)`` an optional constraint (with
    ``prox_params=True`` called as ``prox(z, step, *theta)``). ``x`` may be
    a pytree (e.g. the two blocks ``(a, s)``). The forward pass iterates
    ``x <- prox(x - step * grad(x, theta), step)`` to ``e_rel``; the
    backward pass solves ``w = A^T w + v`` with ``A = d_x T`` to
    ``vjp_rtol`` and returns ``B^T w`` with ``B = d_theta T``.

    The adjoint converges only where ``spectral_radius(d_x T) < 1`` at the
    solution (local strong convexity, not just ``step < 2/L``); bilinear
    factorizations generally do not qualify. ALWAYS check ``converged``:
    at a non-fixed point the gradient means nothing.
    """
    def T(x, *theta):
        z = pytree.tree_map(lambda xi, gi: xi - step * gi, x, grad(x, *theta))
        if prox is None:
            return z
        return prox(z, step, *theta) if prox_params else prox(z, step)

    return _implicit_fixed_point_solver(T, e_rel, max_iter, vjp_iters,
                                        vjp_rtol, device=device)


def make_differentiable_adaprox_solver(grad, step, prox=None, b1=0.9,
                                       b2=0.999, eps=1e-8, e_rel=1e-9,
                                       max_iter=1000, vjp_iters=10000,
                                       vjp_rtol=1e-9, prox_params=False,
                                       device=None):
    """Build a proximal-Adam (``scheme='adam'``) solve differentiable in
    its parameters: ``solve(x0, *theta) -> (x*, converged)``.

    Forward: bias-corrected proximal-Adam iterations ``x <- prox(x - step
    * Phi / Psi, step / Psi)`` to ``e_rel`` (the separable closed-form
    scaled prox: the prox takes elementwise step tensors). The bias
    corrections are float32 scalars, as the JAX solver computes them.
    Backward: implicit differentiation of the PGM condition ``x = prox(x -
    step * grad(x))`` at the solution, which Adam's positive diagonal
    metric shares; so ``step`` must meet the PGM map's contraction
    requirement (a fixed scalar < 2/L). ALWAYS check ``converged``.
    """
    def _prox(z, s, *theta):
        if prox is None:
            return z
        return prox(z, s, *theta) if prox_params else prox(z, s)

    def T(x, *theta):
        z = pytree.tree_map(lambda xi, gi: xi - step * gi, x, grad(x, *theta))
        return _prox(z, step, *theta)

    one32, b1_32, b2_32 = (torch.tensor(v, dtype=torch.float32)
                           for v in (1.0, b1, b2))

    def bias(b, t):
        # 1 - b^t in float32 on the host
        return float(one32 - b ** torch.tensor(float(t),
                                               dtype=torch.float32))

    def forward(x0, *theta):
        def body(x, m, v, it):
            g = grad(x, *theta)
            m1 = pytree.tree_map(lambda mi, gi: b1 * mi + (1.0 - b1) * gi,
                                 m, g)
            v1 = pytree.tree_map(lambda vi, gi: b2 * vi + (1.0 - b2) * gi * gi,
                            v, g)
            bc1, bc2 = bias(b1_32, it + 1), bias(b2_32, it + 1)
            psi = pytree.tree_map(lambda vi: torch.sqrt(vi / bc2) + eps, v1)
            z = pytree.tree_map(lambda xi, mi, pi: xi - step * (mi / bc1) / pi,
                                x, m1, psi)
            s_arr = pytree.tree_map(lambda pi: step / pi, psi)
            return _prox(z, s_arr, *theta), m1, v1

        zeros = pytree.tree_map(torch.zeros_like, x0)
        x, m, v = body(x0, zeros, zeros, 0)
        x_prev, it = x0, 1
        while it < max_iter and bool(_still_moving(x, x_prev, e_rel)):
            x_prev = x
            x, m, v = body(x, m, v, it)
            it += 1
        converged = _converged(x, x_prev, e_rel)
        return x, converged

    return _implicit_fixed_point_solver(T, e_rel, max_iter, vjp_iters,
                                        vjp_rtol, forward=forward,
                                        device=device)


def make_differentiable_admm_solver(prox_f, step_f, prox_g, step_g=None,
                                    L=None, e_rel=1e-9, max_iter=1000,
                                    vjp_iters=10000, vjp_rtol=1e-9,
                                    prox_params=False, device=None):
    """Build a linearized-ADMM solve differentiable in its parameters:
    ``solve(x0, *theta) -> (x*, converged)``.

    The map is one fixed-step ADMM update of ``w = (x, z, u)``
    (:func:`~proxmin_tpu_torch.utils.update_variables`; no slack restart,
    no residual balancing: those are not smooth). With
    ``prox_params=True`` both proxs are called as ``prox(v, step,
    *theta)``, so the parameters can drive the data term and the
    regularizer (e.g. a TV strength through ``prox_g``). The adjoint
    converges where ``spectral_radius(d_w T) < 1`` at the solution; ALWAYS
    check ``converged``.
    """
    Lop = as_linear_operator(L, device=device)
    sg = (step_g if step_g is not None
          else utils.get_step_g(step_f, Lop.spectral_norm_sq))

    def T(w, *theta):
        x, z, u = w
        if prox_params:
            def pf(v, s):
                return prox_f(v, s, *theta)

            def pg(v, s):
                return prox_g(v, s, *theta)
        else:
            pf, pg = prox_f, prox_g
        x, z, u, _, _, _ = utils.update_variables(x, z, u, pf, step_f, pg,
                                                  sg, Lop)
        return (x, z, u)

    inner = _implicit_fixed_point_solver(T, e_rel, max_iter, vjp_iters,
                                         vjp_rtol, device=device)

    def solve(x0, *theta):
        (x0,) = _inputs((x0,), device)
        z0, u0 = utils.initZU(x0, Lop)
        w, converged = inner((x0, z0, u0), *theta)
        return w[0], converged

    return solve


def make_differentiable_sdmm_solver(prox_f, step_f, proxs_g, steps_g=None,
                                    Ls=None, e_rel=1e-9, max_iter=1000,
                                    vjp_iters=10000, vjp_rtol=1e-9,
                                    prox_params=False, device=None):
    """Differentiable SDMM (M simultaneous constraints):
    ``solve(x0, *theta) -> (x*, converged)``.

    The map is one fixed-step SDMM update of ``w = (x, Z_1..M, U_1..M)``
    (no slack restart). ``steps_g[i]`` default to ``step_f * ||L_i||^2 *
    M``. With ``prox_params=True`` every prox is called as ``prox(v, step,
    *theta)``. The caveats of :func:`make_differentiable_admm_solver`
    apply.
    """
    proxs_g = tuple(proxs_g)
    M = len(proxs_g)
    if not hasattr(Ls, "__iter__"):
        Ls = [Ls] * M
    Lops = tuple(as_linear_operator(Li, device=device) for Li in Ls)
    if steps_g is None:
        steps_g = tuple(utils.get_step_g(step_f, Lops[i].spectral_norm_sq,
                                         M=M) for i in range(M))
    steps_g = tuple(steps_g)
    assert len(steps_g) == M

    def T(w, *theta):
        x, z, u = w
        if prox_params:
            def pf(v, s):
                return prox_f(v, s, *theta)

            pgs = [functools.partial(_with_theta, p, theta) for p in proxs_g]
        else:
            pf, pgs = prox_f, list(proxs_g)
        x, z, u, _, _, _ = utils.update_variables(
            x, list(z), list(u), pf, step_f, pgs, list(steps_g), list(Lops))
        return (x, tuple(z), tuple(u))

    inner = _implicit_fixed_point_solver(T, e_rel, max_iter, vjp_iters,
                                         vjp_rtol, device=device)

    def solve(x0, *theta):
        (x0,) = _inputs((x0,), device)
        z0, u0 = utils.initZU(x0, list(Lops))
        w, converged = inner((x0, tuple(z0), tuple(u0)), *theta)
        return w[0], converged

    return solve


def _with_theta(prox, theta, v, s):
    return prox(v, s, *theta)


def make_differentiable_bsdmm_solver(proxs_f, steps_f, proxs_g=None,
                                     steps_g=None, Ls=None,
                                     update_order=None, e_rel=1e-9,
                                     max_iter=1000, vjp_iters=10000,
                                     vjp_rtol=1e-9, prox_params=False,
                                     device=None):
    """Differentiable block-SDMM: ``solve(x_blocks, *theta) -> (x_blocks,
    converged)``.

    The map is one Gauss-Seidel sweep over the N blocks (block j's
    ``proxs_f`` sees the blocks already updated) with fixed steps:
    ``steps_f`` is a scalar or N scalars. ``proxs_g[j]`` is an optional
    list of M_j constraint proxs with ``Ls[j]``; ``steps_g[j][i]`` default
    to ``steps_f[j] * ||L_ji||^2 * N * M_j``. ``proxs_f(v, step, *theta,
    Xs=..., j=...)`` is the block's data-term prox; with
    ``prox_params=True`` the constraint proxs are called as ``prox(v,
    step, *theta)``. The caveats of :func:`make_differentiable_admm_solver`
    apply; bilinear objectives are generically not locally strongly
    convex.
    """
    def solve(x0, *theta):
        x0 = _inputs(tuple(x0), device)
        N = len(x0)
        steps = (list(steps_f) if hasattr(steps_f, "__iter__")
                 else [steps_f] * N)
        assert len(steps) == N
        pg = list(proxs_g) if proxs_g is not None else [None] * N
        assert len(pg) == N
        Ls_n = list(Ls) if hasattr(Ls, "__iter__") else [Ls] * N
        sg_n = list(steps_g) if steps_g is not None else [None] * N
        order = (tuple(update_order) if update_order is not None
                 else tuple(range(N)))

        M = [0] * N
        Lops = [None] * N
        sgs = [None] * N
        for j in range(N):
            if pg[j] is not None:
                pj = pg[j] if hasattr(pg[j], "__iter__") else [pg[j]]
                pg[j] = tuple(pj)
                M[j] = len(pg[j])
                Lj = (Ls_n[j] if hasattr(Ls_n[j], "__iter__")
                      else [Ls_n[j]] * M[j])
                Lops[j] = tuple(as_linear_operator(Li, device=device)
                                for Li in Lj)
                if sg_n[j] is None:
                    sgs[j] = tuple(
                        utils.get_step_g(steps[j], Lops[j][i].spectral_norm_sq,
                                         N=N, M=M[j])
                        for i in range(M[j]))
                else:
                    sgs[j] = tuple(sg_n[j])
            else:
                Lops[j] = as_linear_operator(None)

        def T(w, *theta):
            xs, zs, us = list(w[0]), list(w[1]), list(w[2])
            for j in order:
                pf_j = functools.partial(_block_prox, proxs_f, theta,
                                         tuple(xs), j)
                if M[j] > 0:
                    pgs_j = ([functools.partial(_with_theta, p, theta)
                              for p in pg[j]] if prox_params
                             else list(pg[j]))
                    xj, zj, uj, _, _, _ = utils.update_variables(
                        xs[j], list(zs[j]), list(us[j]), pf_j, steps[j],
                        pgs_j, list(sgs[j]), list(Lops[j]))
                    zs[j], us[j] = tuple(zj), tuple(uj)
                else:
                    xj, zj, uj, _, _, _ = utils.update_variables(
                        xs[j], zs[j], us[j], pf_j, steps[j], None, None,
                        Lops[j])
                    zs[j], us[j] = zj, uj
                xs[j] = xj
            return (tuple(xs), tuple(zs), tuple(us))

        inner = _implicit_fixed_point_solver(T, e_rel, max_iter, vjp_iters,
                                             vjp_rtol, device=device)
        z0, u0 = [], []
        for j in range(N):
            if M[j] > 0:
                zj, uj = utils.initZU(x0[j], list(Lops[j]))
                z0.append(tuple(zj))
                u0.append(tuple(uj))
            else:
                z0.append(x0[j])
                u0.append(torch.zeros_like(x0[j]))
        w, converged = inner((tuple(x0), tuple(z0), tuple(u0)), *theta)
        return w[0], converged

    return solve


def _block_prox(proxs_f, theta, xs, j, v, s):
    return proxs_f(v, s, *theta, Xs=xs, j=j)


# ---------------------------------------------------------------------------
# Batched NMF

def _lam_max(G, iters=24):
    """The top eigenvalue of a small PSD Gram by ``iters`` power passes:
    products and elementwise operations only, so it runs under
    ``torch.func.vmap`` (the drivers take ``eigvalsh``)."""
    k = G.shape[0]
    tiny = torch.finfo(G.dtype).tiny
    v = (torch.ones((k,), dtype=G.dtype, device=G.device)
         + 0.01 * torch.arange(k, dtype=G.dtype, device=G.device))
    for _ in range(iters):
        w = G @ v
        v = w * torch.rsqrt(torch.clamp_min(torch.sum(w * w), tiny))
    return (v @ (G @ v)) / torch.clamp_min(torch.sum(v * v), tiny)


def make_nmf_solver(prox_A=None, prox_S=None, e_rel=1e-3, max_iter=1000,
                    weighted=False, cold_iters=32, warm_iters=8,
                    safety=0.9, device=None):
    """Build a pure PGM-NMF solve with the data as an argument:
    ``solve(A0, S0, Y) -> (A, S, iterations, converged)``, or with
    ``weighted=True`` ``solve(A0, S0, Y, W)``.

    Unlike :func:`proxmin_tpu_torch.nmf.nmf`, ``Y`` (and ``W``) are
    inputs, so ``torch.func.vmap(solve)`` factorizes a batch of problems
    (per-patch unmixing of an image grid) in one call, each lane running
    the PGM-NMF iteration (gradients, Lipschitz steps on the device,
    non-negativity by default) to its own tolerance.

    The Lipschitz bounds are power iterations, never ``eigvalsh``: the
    K x K Grams by 24 passes unweighted; weighted, the C channel Grams by
    ``cold_iters`` passes and the per-pixel bound by the implicit batched
    power iteration warm-started across iterations (``cold_iters`` passes
    on the first, ``warm_iters`` after), shrunk by ``safety``.
    """
    pA = prox_A if prox_A is not None else _ops.prox_plus
    pS = prox_S if prox_S is not None else _ops.prox_plus

    def update(st, gA, gS, sA, sS):
        A, S = st["A"], st["S"]
        A_new = pA(A - sA * gA, sA)
        S_new = pS(S - sS * gS, sS)
        st["converged"] = torch.logical_and(
            fixed_point_converged(A_new, A, e_rel),
            fixed_point_converged(S_new, S, e_rel))
        st["A"], st["S"] = A_new, S_new

    def run(st, step):
        dev = st["A"].device
        if under_vmap():
            it = run_lanes(st, step, lambda s: s["converged"], max_iter, dev)
        else:
            k = 0
            while k < max_iter:
                step(st, k)
                k += 1
                if bool(st["converged"]):  # the one blocking read
                    break
            it = _count(k, dev)
        return st["A"], st["S"], it, st["converged"]

    def fresh(A0, S0):
        return dict(A=A0, S=S0, converged=torch.zeros(
            (), dtype=torch.bool, device=A0.device))

    def solve_unweighted(A0, S0, Y):
        A0, S0, Y = _inputs((A0, S0, Y), device)

        def step(st, _):
            A, S = st["A"], st["S"]
            gA, gS = grad_likelihood(A, S, Y=Y)
            update(st, gA, gS, 1.0 / _lam_max(S @ S.T),
                   1.0 / _lam_max(A.T @ A))

        return run(fresh(A0, S0), step)

    def solve_weighted(A0, S0, Y, W):
        A0, S0, Y, W = _inputs((A0, S0, Y, W), device)
        st = fresh(A0, S0)
        dtype = functools.reduce(torch.promote_types,
                                 [A0.dtype, S0.dtype, W.dtype])
        st["v"] = _weighted_lipschitz_S_v0(S0.shape[1], A0.shape[1], dtype,
                                           A0.device)

        def step(st, k):
            A, S = st["A"], st["S"]
            gA, gS = grad_likelihood(A, S, Y=Y, W=W)
            H = torch.einsum("kn,cn,ln->ckl", S, W, S)
            LA = _lam_max_psd_batch(H, cold_iters)
            LS, st["v"] = _weighted_lipschitz_S(
                A, W, cold_iters if k == 0 else warm_iters, v0=st["v"],
                return_v=True)
            update(st, gA, gS, safety / LA, safety / LS)

        return run(st, step)

    return solve_weighted if weighted else solve_unweighted
