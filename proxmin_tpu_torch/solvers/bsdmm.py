"""Block-Simultaneous Method of Multipliers (bSDMM) as a host loop over
tensor ops.

Counterpart of :func:`proxmin_tpu.solvers.bsdmm.bsdmm`: linearized SDMM
extended to N variable blocks with a Gauss-Seidel sweep in ``update_order``,
each block with its own list of M_j constraints, proxs and linear
operators, and per-block Boyd residual convergence. Block j's ``prox_f``
sees the blocks already updated in the current sweep.

The JAX solver runs the sweeps in one ``lax.while_loop`` (segmented around
strided step refreshes, which gives the flat loop's trajectory by
construction). Here the flat loop runs on the host, and whether a block's
step refreshes is decided there: the sweep clock, a stateful stepper's
strides and its next-refresh clocks are host integers. The per-block
convergence flags and the divergence flag are read together, once per
sweep. An exported program (``export.export_bsdmm_solver``) runs the same
sweep on tensor clocks: the loop's counter on the device, the refresh
schedule in 0-d CPU tensors.

As in the JAX package, ``steps_g_update='relative'`` skips the rescale on
the first sweep (the reference divides by a ``None`` there).
"""

import functools
import logging

import numpy as np
import torch

from .. import utils
from ..linop import as_linear_operator
from .common import (SolverResult, as_tensor, host_values, local_of,
                     map_leaves, status_from, tupleize, writeback)

logger = logging.getLogger("proxmin")

__all__ = ["bsdmm"]


def _normalize(N, proxs_g, steps_g, Ls, steps_g_update, device):
    """The nested constraint structure as static tuples:
    ``proxs_g[j][i]``, ``steps_g[j][i]``, ``Ls[j][i]`` for block j's M_j
    constraints (``proxs_g[j]`` None and ``Ls[j]`` the identity for an
    unconstrained block), and the effective update mode."""
    proxs_g = [None] * N if proxs_g is None else list(proxs_g)
    assert len(proxs_g) == N
    steps_g_update = steps_g_update.lower()
    assert steps_g_update in ("steps_f", "fixed", "relative")
    if steps_g_update == "steps_f" and steps_g is not None:
        logger.debug("Setting steps_g = None for update strategy 'steps_f'.")
        steps_g = None
    if steps_g_update in ("fixed", "relative") and steps_g is None:
        logger.debug(
            "Ignoring steps_g update strategy %r because steps_g is None.",
            steps_g_update)
        steps_g_update = "steps_f"

    steps_g = (list(steps_g) if hasattr(steps_g, "__iter__")
               else [steps_g] * N)
    Ls = list(Ls) if hasattr(Ls, "__iter__") else [Ls] * N
    assert len(steps_g) == N and len(Ls) == N

    for j in range(N):
        if proxs_g[j] is None:
            Ls[j] = as_linear_operator(None)
            continue
        if not hasattr(proxs_g[j], "__iter__"):
            proxs_g[j] = [proxs_g[j]]
        proxs_g[j] = tuple(proxs_g[j])
        Mj = len(proxs_g[j])
        if not hasattr(steps_g[j], "__iter__"):
            steps_g[j] = [steps_g[j]] * Mj
        if not hasattr(Ls[j], "__iter__"):
            Ls[j] = [Ls[j]] * Mj
        steps_g[j] = tuple(steps_g[j])
        Ls[j] = tuple(as_linear_operator(Li, device=device) for Li in Ls[j])
        assert len(steps_g[j]) == Mj and len(Ls[j]) == Mj
    return proxs_g, steps_g, Ls, steps_g_update


class _Program:
    """The solver's structure resolved for N blocks on a device (the
    normalized constraints, tolerances, sweep order and step mode) and its
    sweep: the loop body that the driver and
    ``functional.make_bsdmm_solver`` share, as the JAX driver's
    ``_build_bsdmm`` is shared there."""

    def __init__(self, N, device, proxs_f, steps_f_cb, proxs_g=None,
                 steps_g=None, Ls=None, update_order=None,
                 steps_g_update="steps_f", e_rel=1e-6, e_abs=0,
                 steps_f_stride=None):
        self.N = N
        self.proxs_f, self.steps_f_cb = proxs_f, steps_f_cb
        self.steps_f_stride = steps_f_stride
        (self.proxs_g, self.steps_g, self.Ls,
         self.steps_g_update) = _normalize(N, proxs_g, steps_g, Ls,
                                           steps_g_update, device)
        self.M = [0 if p is None else len(p) for p in self.proxs_g]
        self.e_rel = [e_rel] * N if np.ndim(e_rel) == 0 else list(e_rel)
        self.e_abs = [e_abs] * N if np.ndim(e_abs) == 0 else list(e_abs)
        assert len(self.e_rel) == N and len(self.e_abs) == N
        self.update_order = (tuple(range(N)) if update_order is None
                             else tuple(int(j) for j in update_order))
        self.stateful_steps = hasattr(steps_f_cb, "init_bsdmm_state")
        assert not (self.stateful_steps and steps_f_stride), \
            "stateful steps_f_cb handles striding itself"
        self.strided = (not self.stateful_steps
                        and steps_f_stride is not None
                        and steps_f_stride > 1)

    def init_state(self, x0):
        """The fresh carry: the blocks, per-block Z/U, the carried steps
        and the stateful stepper's state."""
        M, N = self.M, self.N
        x = list(x0)
        z, u = [], []
        for j in range(N):
            if M[j]:
                zj, uj = utils.initZU(x[j], list(self.Ls[j]))
            else:
                zj, uj = x[j], torch.zeros_like(x[j])
            z.append(zj)
            u.append(uj)
        steps_g = [
            tuple(self.steps_g[j]) if M[j] and self.steps_g[j][0] is not None
            else (0.0,) * M[j] for j in range(N)]
        return dict(x=x, z=z, u=u, steps_f=[1.0] * N, steps_g=steps_g,
                    steps_state=(self.steps_f_cb.init_bsdmm_state(tuple(x))
                                 if self.stateful_steps else ()))

    def carried_keys(self):
        """The carry entries a loop over :meth:`sweep` threads from sweep
        to sweep, beside the blocks and their Z and U: the last steps
        where a later sweep reads them (strided, stateful or relative
        steps), the rescaled ``steps_g`` and the stepper's state."""
        keys = ("x", "z", "u")
        if self.strided or self.stateful_steps or (
                self.steps_g_update == "relative"):
            keys += ("steps_f",)
        if self.steps_g_update == "relative":
            keys += ("steps_g",)
        if self.stateful_steps:
            keys += ("steps_state",)
        if self.strided or self.stateful_steps:
            keys += ("clock",)
        return keys

    def init_traced(self, x0):
        """:meth:`init_state` for a sweep on a tensor clock: every step
        and ``steps_g`` a 0-d tensor of the blocks' dtype (the JAX carry's
        layout). The refresh schedule stays on the host: with strided or
        stateful steps the carry's ``clock`` is the sweep clock as a 0-d
        int64 CPU tensor, and the stepper state's integers are 0-d int64
        CPU tensors too, so a refresh test reads nothing from the card."""
        st = self.init_state(x0)
        x = st["x"]
        dtype = functools.reduce(torch.promote_types, [xi.dtype for xi in x])
        dev = x[0].device
        host = torch.device("cpu")

        def scalar(v):
            return torch.as_tensor(v, dtype=dtype, device=dev)

        def clock(v):
            if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
                return torch.tensor(int(v), dtype=torch.int64, device=host)
            return v

        st["steps_f"] = [scalar(v) for v in st["steps_f"]]
        st["steps_g"] = [tuple(scalar(v) for v in g) for g in st["steps_g"]]
        st["steps_state"] = map_leaves(clock, st["steps_state"])
        if self.strided or self.stateful_steps:
            st["clock"] = clock(0)
        return st

    def _strided_step(self, xs, j, it, cached):
        """The strided step of block j on a tensor clock: the step
        callable (shrunk by 0.9) inside a ``torch.cond`` on ``it %
        steps_f_stride == 0``, so that it runs on refresh sweeps only; the
        carried step otherwise."""
        dtype, dev = cached.dtype, cached.device

        def refresh(cached):
            return torch.as_tensor(0.9 * self.steps_f_cb(xs, j=j),
                                   dtype=dtype, device=dev)

        def keep(cached):
            # a new tensor: a branch may not return its input
            return cached.clone()

        return torch.cond(it % self.steps_f_stride == 0, refresh, keep,
                          (cached,))

    def sweep(self, st, it, trace=False):
        """One Gauss-Seidel sweep on the carry ``st`` at sweep clock
        ``it``, with no host read. Returns the flags as one tensor (the
        blocks' convergence in ``update_order``, then divergence) and,
        with ``trace``, the (N, 2) row of aggregated residual norms.

        ``it`` is the driver's host integer, or a 0-d integer tensor (an
        exported loop's counter, on the carry of :meth:`init_traced`):
        then the relative rescale is a ``torch.where`` on ``it``, and the
        stride test a ``torch.cond`` on the carry's host ``clock``, which a
        stateful stepper receives as its clock and which the sweep
        advances. Both compute the same numbers.

        The driver keeps the host-clock forms: run on the tensor clock it
        ends bit for bit where it does, but eager ``torch.cond`` and
        ``while_loop`` make a strided or stateful sweep 2.6-4.1x as long
        at the flagship (C 5, K 7, N 1e6) and its first call compile for
        up to 10 s (``tools/bsdmm_clock_cost.py`` on an NVIDIA H100 80GB
        HBM3 at 700 W)."""
        N, M, Ls = self.N, self.M, self.Ls
        traced = isinstance(it, torch.Tensor)
        # the refresh schedule's clock: the host copy where the carry has one
        clock = st["clock"] if traced and "clock" in st else it
        # new lists: the carry's own stay as they were (the lanes
        # controller selects between the two)
        x, z, u = list(st["x"]), list(st["z"]), list(st["u"])
        steps_f, steps_g_carry = list(st["steps_f"]), list(st["steps_g"])
        conv_t = {}
        errs, trace_row = [], {}
        for j in self.update_order:
            # the block's prox sees all current blocks (Gauss-Seidel)
            xs_now = tuple(x)
            prox_f_j = functools.partial(self.proxs_f, Xs=xs_now, j=j)

            if self.stateful_steps:
                steps_f_j, st["steps_state"] = self.steps_f_cb(
                    xs_now, j=j, state=st["steps_state"], it=clock,
                    cached=steps_f[j])
            elif self.strided and traced:
                steps_f_j = self._strided_step(xs_now, j, clock, steps_f[j])
            elif self.strided:
                # the step callable runs only every steps_f_stride sweeps;
                # in between the carried, safety-shrunk step serves
                steps_f_j = (0.9 * self.steps_f_cb(xs_now, j=j)
                             if it % self.steps_f_stride == 0
                             else steps_f[j])
            else:
                steps_f_j = self.steps_f_cb(xs_now, j=j)

            if M[j]:
                if self.steps_g_update == "relative" and (traced or it > 0):
                    scale = steps_f_j / steps_f[j]
                    if traced:
                        # the first sweep keeps the given steps_g (x 1 is
                        # exact)
                        scale = torch.where(it > 0, scale, 1.0)
                    steps_g_carry[j] = tuple(s * scale
                                             for s in steps_g_carry[j])
                if self.steps_g_update == "steps_f":
                    steps_g_j = [
                        utils.get_step_g(steps_f_j,
                                         Ls[j][i].spectral_norm_sq, N=N,
                                         M=M[j]) for i in range(M[j])]
                else:
                    steps_g_j = list(steps_g_carry[j])
                xj, zj, uj, lxj, rj, sj = utils.update_variables(
                    x[j], z[j], u[j], prox_f_j, steps_f_j,
                    list(self.proxs_g[j]), steps_g_j, list(Ls[j]))
                conv_t[j], err_list = utils.check_constraint_convergence(
                    xj, list(Ls[j]), lxj, zj, uj, rj, sj, steps_f_j,
                    steps_g_j, self.e_rel[j], self.e_abs[j])
            else:
                xj, zj, uj, lxj, rj, sj = utils.update_variables(
                    x[j], z[j], u[j], prox_f_j, steps_f_j, None, None, Ls[j])
                conv_t[j], err_j = utils.check_constraint_convergence(
                    xj, Ls[j], lxj, zj, uj, rj, sj, steps_f_j, None,
                    self.e_rel[j], self.e_abs[j])
                err_list = (err_j,)
            errs.extend(v for e in err_list for v in e)
            if trace:
                # primal and dual residual norms over the constraints
                trace_row[j] = (
                    torch.sqrt(sum(e[2] ** 2 for e in err_list)),
                    torch.sqrt(sum(e[3] ** 2 for e in err_list)))
            x[j], z[j], u[j] = xj, zj, uj
            if traced:
                # the carry keeps its dtype from sweep to sweep
                steps_f_j = torch.as_tensor(steps_f_j,
                                            dtype=steps_f[j].dtype,
                                            device=steps_f[j].device)
            steps_f[j] = steps_f_j

        st.update(x=x, z=z, u=u, steps_f=steps_f, steps_g=steps_g_carry)
        if traced and "clock" in st:
            st["clock"] = clock + 1
        row = None
        if trace:
            dtype = functools.reduce(torch.promote_types,
                                     [xi.dtype for xi in x])
            zero = torch.zeros((), dtype=dtype, device=x[0].device)
            row = torch.stack(
                [v.to(dtype) for j in range(N)
                 for v in trace_row.get(j, (zero, zero))]).reshape(N, 2)
        # the error norms cover every live quantity, so their finiteness
        # detects a diverged block for free
        flags = [conv_t[j] for j in self.update_order]
        flags.append(torch.logical_not(
            torch.isfinite(torch.stack(errs)).all()))
        return torch.stack(flags), row


def bsdmm(
    X,
    proxs_f,
    steps_f_cb,
    proxs_g=None,
    steps_g=None,
    Ls=None,
    update_order=None,
    steps_g_update="steps_f",
    max_iter=1000,
    e_rel=1e-6,
    e_abs=0,
    callback=None,
    trace=False,
    steps_f_stride=None,
    state=None,
    device=None,
):
    """Block-Simultaneous Method of Multipliers.

    Args:
        X: the N blocks. NumPy arrays go to ``device`` and are updated in
            place; tensors stay on their device.
        proxs_f: ``proxs_f(X_j, step, Xs=None, j=None)`` on tensors.
        steps_f_cb: ``steps_f_cb(Xs, j=None)``, the step of block j; or a
            stateful stepper, an object with ``init_bsdmm_state(Xs)`` that
            is called as ``steps_f_cb(Xs, j=, state=, it=, cached=) ->
            (step_j, state)`` and strides by itself (then
            ``steps_f_stride`` must not be set).
        proxs_g, steps_g, Ls: per block, one entry or a list of M_j
            entries; None for an unconstrained block.
        update_order: the order of the Gauss-Seidel sweep.
        steps_g_update: ``'steps_f'`` (derived from the block's step),
            ``'fixed'`` or ``'relative'`` (the given ``steps_g``, rescaled
            by the change of the block's step).
        steps_f_stride: evaluate ``steps_f_cb`` only on sweeps that are a
            multiple of this, with the carried step shrunk by 0.9.
        callback: ``callback(*X, it=it)`` before every sweep, with the
            blocks as tensors (not to be modified); ``StopIteration`` ends
            the solve.
        trace: keep the per-sweep aggregated ``(|R|, |S|)`` per block in
            ``.history``.
        state: a previous solve's ``.state``, with its blocks as ``X``:
            Z/U, the carried steps, the stepper state and the sweep clock
            continue; a resumed solve runs up to ``max_iter`` further
            sweeps. The stride settings must match the state's.
        device: where NumPy inputs go (default: the CUDA device; without
            one, pass ``device="cpu"``).

    Returns:
        ``SolverResult`` unpacking as the per-block converged tuple, with
        ``.x``, ``.iterations``, ``.converged``, ``.history``, ``.status``
        and ``.state``.
    """
    x0, originals, _ = tupleize(X, device)
    N = len(x0)
    dev = x0[0].device
    dtype = functools.reduce(torch.promote_types, [x.dtype for x in x0])

    # the refresh phase of strided steps lives partly in the call's
    # settings (`it % steps_f_stride`, a stateful stepper's stride/adapt),
    # so a resume under other settings would refresh on the wrong schedule
    stride_cfg = (0 if steps_f_stride is None else int(steps_f_stride),
                  int(getattr(steps_f_cb, "stride", 0) or 0),
                  bool(getattr(steps_f_cb, "adapt", False)))
    if state is not None and "stride_config" in state:
        st_cfg = tuple(state["stride_config"])
        st_cfg = (int(st_cfg[0]), int(st_cfg[1]), bool(st_cfg[2]))
        if st_cfg != stride_cfg:
            raise ValueError(
                "state= was produced under a different step-stride "
                "configuration ((steps_f_stride, stepper stride, "
                "adapt) = {} vs this call's {}); resume with the same "
                "settings".format(st_cfg, stride_cfg))

    prog = _Program(N, dev, proxs_f, steps_f_cb, proxs_g=proxs_g,
                    steps_g=steps_g, Ls=Ls, update_order=update_order,
                    steps_g_update=steps_g_update, e_rel=e_rel, e_abs=e_abs,
                    steps_f_stride=steps_f_stride)
    if state is None:
        st = prog.init_state(x0)
        it0 = 0
        converged = [False] * N
        diverged = False
    else:
        # per-block Z/U, the carried steps, the stepper state and the sweep
        # clock continue: the stepper states carry absolute next-refresh
        # sweeps, so a restarted clock would serve stale steps until it
        # caught up
        z, u = (list(map_leaves(lambda t: as_tensor(t, device=dev),
                                state[k]))
                for k in ("z", "u"))
        st = dict(x=list(x0), z=z, u=u, steps_f=list(state["steps_f"]),
                  steps_g=[tuple(s) for s in state["steps_g"]],
                  steps_state=state["steps_state"])
        it0 = int(state.get("it", 0))
        converged = [bool(c) for c in state.get("converged", [False] * N)]
        diverged = bool(state.get("diverged", False))
    it = it0
    history = (torch.zeros((max_iter, N, 2), dtype=dtype, device=dev)
               if trace else None)

    while it < it0 + max_iter and not all(converged) and not diverged:
        if callback is not None:
            try:
                callback(*st["x"], it=it)
            except StopIteration:
                break
        flags, row = prog.sweep(st, it, trace)
        if trace:
            history[it - it0] = local_of(row)
        # one blocking read per sweep, of the blocks' flags and the
        # divergence flag
        flags = host_values(flags)
        for j, c in zip(prog.update_order, flags):
            converged[j] = c
        diverged = flags[-1]
        it += 1

    iterations = it - it0
    logger.info("Completed %d iterations", iterations)
    converged = tuple(converged)
    status = status_from(all(converged), diverged, logger)
    x = tuple(st["x"])
    writeback(originals, x)
    return SolverResult(
        converged,
        x=x, iterations=iterations, converged=converged,
        history=(history[:iterations].cpu().numpy() if trace else None),
        status=status,
        # per block: Z and U (a tuple of M_j, or one tensor for a block
        # without constraints), the last step_f (a number or a 0-d tensor,
        # as the step callable gave it) and the carried steps_g; a stateful
        # stepper's carry; the sweep clock, which continues across resumes
        state={"z": tuple(st["z"]), "u": tuple(st["u"]),
               "steps_f": tuple(st["steps_f"]),
               "steps_g": tuple(st["steps_g"]),
               "steps_state": st["steps_state"],
               "it": it, "stride_config": stride_cfg,
               # a stopped solve stays stopped on resume
               "converged": converged, "diverged": diverged},
    )
