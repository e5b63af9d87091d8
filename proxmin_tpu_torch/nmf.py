"""Constrained matrix factorization, unweighted PGM.

Counterpart of :mod:`proxmin_tpu.nmf` for ``min 0.5 ||Y - A S||^2`` under
proximal constraints on A and S, on two engines:

* ``engine="torch"`` (default; the JAX ``"xla"`` engine's counterpart): the
  generic :func:`~proxmin_tpu_torch.solvers.pgm.pgm` driver with
  :func:`grad_likelihood` and :func:`step_pgm` as tensor ops.
* ``engine="cuda"`` (the JAX ``"pallas"`` engine's counterpart):
  :func:`nmf_pgm_fused`, one launch of the fused kernel
  :func:`~proxmin_tpu_torch.ops.nmf_kernels.fused_nmf_pgm_step` per
  iteration.

Weighted problems, the strided/adaptive steps, ``engine="auto"``,
``mesh=`` and the other algorithms are later slices (ROADMAP.md Queue 1).
"""

import logging
from functools import partial

import numpy as np
import torch

from . import algorithms, operators
from .ops.nmf_kernels import DEFAULT_TILE_N, fused_nmf_pgm_step
from .solvers.common import (SolverResult, promote_dtype, status_from,
                             writeback)

logger = logging.getLogger("proxmin")

__all__ = [
    "log_likelihood",
    "grad_likelihood",
    "step_A",
    "step_S",
    "step_pgm",
    "pgm_nmf_iteration",
    "nmf",
    "nmf_pgm_fused",
]


def _not_yet(what, item):
    return NotImplementedError(
        f"{what} is not ported to proxmin_tpu_torch yet (ROADMAP.md Queue 1 "
        f"item {item}); use proxmin_tpu for it")


def _is_unweighted(W):
    """True for None or the scalar 1 (the reference's ``W == 1``)."""
    if W is None:
        return True
    if np.isscalar(W) or getattr(W, "ndim", None) == 0:
        return float(W) == 1.0
    return False


def _device_for(device, *arrays):
    """Where NumPy inputs go: ``device`` when given, else the device of the
    first tensor among ``arrays``, else the CPU."""
    if device is not None:
        return torch.device(device)
    return next((a.device for a in arrays if isinstance(a, torch.Tensor)),
                torch.device("cpu"))


def log_likelihood(*X, Y=0, W=1):
    """Gaussian NMF log-likelihood ``sum(W (Y - A S)^2) / 2``."""
    A, S = X
    R = Y - A @ S
    return torch.sum(W * R ** 2) / 2


def grad_likelihood(*X, Y=0, W=1):
    """Gradient of :func:`log_likelihood` in (A, S): with
    ``D = W (A S - Y)``, returns ``(D S^T, A^T D)``."""
    A, S = X
    D = A @ S - Y
    if not _is_unweighted(W):
        D = W * D
    return D @ S.T, A.T @ D


def _lambda_max(G):
    """Largest eigenvalue of a small symmetric PSD matrix."""
    return torch.linalg.eigvalsh(G)[-1]


def step_A(A, S):
    """``1 / lambda_max(S S^T)``."""
    return 1.0 / _lambda_max(S @ S.T)


def step_S(A, S):
    """``1 / lambda_max(A^T A)``."""
    return 1.0 / _lambda_max(A.T @ A)


def step_pgm(*X, it=None, W=1):
    """Lipschitz PGM step sizes ``(step_A, step_S)`` (unweighted only)."""
    if not _is_unweighted(W):
        raise _not_yet("weighted step_pgm", 6)
    A, S = X
    return step_A(A, S), step_S(A, S)


def pgm_nmf_iteration(A, S, Y):
    """One PGM-NMF iteration with non-negativity on both factors; returns
    ``(A_new, S_new, converged_at_zero_tol)``."""
    gA, gS = grad_likelihood(A, S, Y=Y)
    sA, sS = step_pgm(A, S)
    A_new = operators.prox_plus(A - sA * gA, sA)
    S_new = operators.prox_plus(S - sS * gS, sS)
    conv = torch.logical_and(
        torch.sum((A_new - A) ** 2) <= 0.0 * torch.sum(A_new ** 2),
        torch.sum((S_new - S) ** 2) <= 0.0 * torch.sum(S_new ** 2),
    )
    return A_new, S_new, conv


def _poison_loss(loss, *norms):
    """``loss``, or NaN when any post-update norm is non-finite: the
    kernel's loss is taken at the pre-update iterate, so alone it would see
    a divergence one iteration late."""
    finite = torch.stack([torch.isfinite(v) for v in norms]).all()
    return torch.where(finite, loss, torch.full_like(loss, float("nan")))


def _fused_fp_conv(d_sq, n_sq, e_rel):
    """Fixed-point test of the fused engine; never true on non-finite
    norms."""
    ok = d_sq <= e_rel ** 2 * n_sq
    return torch.logical_and(
        ok, torch.logical_and(torch.isfinite(d_sq), torch.isfinite(n_sq)))


def _run_fused_pgm(A, S, Y, max_iter, prox_A, prox_S, e_rel, tile_n,
                   conv_A0=False, conv_S0=False, div0=False, loss0=np.inf,
                   SSt0=None):
    """The exact (unstrided) fused PGM loop on float32 tensors. Counterpart
    of the ``run`` built by ``proxmin_tpu.nmf._make_fused_pgm_runner``.

    The step sizes come from the Gram the kernel accumulated for the
    current S (``SSt``) and from ``A^T A``; both eigensolves are K x K.
    ``SSt0`` carries the kernel's own Gram across a resume: a fresh
    ``S S^T`` has another summation order, and its last-bit differences
    would compound. Returns ``(A, S, it, conv_A, conv_S, loss, SSt)``."""
    dev = A.device
    SSt = S @ S.T if SSt0 is None else SSt0.to(device=dev,
                                                dtype=torch.float32)
    conv_A = torch.tensor(bool(conv_A0), device=dev)
    conv_S = torch.tensor(bool(conv_S0), device=dev)
    loss = torch.tensor(float(loss0), dtype=torch.float32, device=dev)
    it = 0

    def keep_going():
        # one host read per iteration; a non-finite loss after the first
        # iteration means divergence (the initial loss is inf by design)
        if div0:
            return False
        stop = torch.logical_and(conv_A, conv_S)
        if it > 0:
            stop = torch.logical_or(stop,
                                    torch.logical_not(torch.isfinite(loss)))
        return not bool(stop)

    while it < max_iter and keep_going():
        sA = 1.0 / _lambda_max(SSt)
        sS = 1.0 / _lambda_max(A.T @ A)
        gA, S_new, SSt_new, loss, dS_sq, nS_sq = fused_nmf_pgm_step(
            A, S, Y, sS, prox_S=prox_S, tile_n=tile_n)
        A_new = prox_A(A - sA * gA, sA)
        dA_sq = torch.sum((A_new - A) ** 2)
        nA_sq = torch.sum(A_new ** 2)
        conv_A = _fused_fp_conv(dA_sq, nA_sq, e_rel)
        conv_S = _fused_fp_conv(dS_sq, nS_sq, e_rel)
        loss = _poison_loss(loss, dA_sq, nA_sq, dS_sq, nS_sq)
        A, S, SSt = A_new, S_new, SSt_new
        it += 1
    return A, S, it, bool(conv_A), bool(conv_S), float(loss), SSt


def nmf_pgm_fused(
    Y,
    A,
    S,
    W=None,
    prox_A=operators.prox_plus,
    prox_S=operators.prox_plus,
    e_rel=1e-3,
    max_iter=1000,
    tile_n=DEFAULT_TILE_N,
    state=None,
    device=None,
):
    """Unweighted PGM-NMF with one fused K1 step per iteration.

    The same iteration as ``nmf(engine="torch")``, with the S-side work
    (residual, both gradients, the proxed S update, the next ``S S^T``
    Gram and the convergence norms) done in one pass over the pixels by
    :func:`~proxmin_tpu_torch.ops.nmf_kernels.fused_nmf_pgm_step`. The
    Lipschitz recursion is exact, not lagged. Computes in float32.

    On CUDA tensors ``prox_S`` must be ``prox_plus`` or ``prox_id``/None
    (the kernel applies it); ``prox_A`` acts on the tiny C x K factor
    outside the kernel and may be any prox. On CPU tensors the kernel's
    plain version runs instead.

    ``state=`` continues a previous call's ``.state`` (with its final
    iterates) on the uninterrupted trajectory, bit for bit, and a solve
    that stopped stays stopped; ``max_iter`` counts the further
    iterations. ``tile_n`` must match the state's: it fixes the kernel's
    summation order.

    Returns a ``SolverResult`` unpacking as the ``(conv_A, conv_S)`` flags,
    with ``.x == (A, S)``, ``.iterations``, ``.converged``, ``.loss``,
    ``.status`` and ``.state``.
    """
    if not _is_unweighted(W):
        raise _not_yet("the weighted fused PGM runner", 6)
    A_in, S_in = A, S
    if prox_A is None:
        prox_A = operators.prox_id
    if prox_S is None:
        prox_S = operators.prox_id
    dev = _device_for(device, Y, A, S)
    A, S, Y = (promote_dtype(a, device=dev) for a in (A, S, Y))
    dtype = A.dtype
    stride_cfg = (0, False)
    conv0, div0, loss0, SSt0, it0 = (False, False), False, np.inf, None, 0
    if state is not None:
        if not (hasattr(state, "get")
                and state.get("kind") == "nmf_pgm_fused"):
            raise ValueError("state= must be a previous nmf_pgm_fused "
                             ".state dict")
        if bool(state["weighted"]):
            raise ValueError("state= was produced under a weighted solve; "
                             "this solve is unweighted")
        if tuple(state.get("stride_config", stride_cfg)) != stride_cfg:
            raise ValueError("state= was produced under a different stride "
                             "configuration; resume with the same settings")
        if state.get("store_dtype") is not None:
            raise ValueError("state= was produced under a reduced "
                             "store_dtype; this solve stores float32")
        if int(state.get("tile_n", tile_n)) != int(tile_n):
            raise ValueError(
                f"state= was produced under tile_n={state.get('tile_n')} "
                f"but this call uses {tile_n}: the carried Gram is "
                "tile-accumulated; resume with the same tile_n")
        it0 = int(state["it"])
        conv0 = tuple(bool(c) for c in np.asarray(state["converged"]))
        div0 = bool(np.asarray(state.get("diverged", False)))
        loss0 = float(state.get("loss", np.inf))
        SSt0 = state.get("steps")

    f32 = torch.float32
    A_f, S_f, iterations, conv_A, conv_S, loss, SSt_f = _run_fused_pgm(
        A.to(f32).contiguous(), S.to(f32).contiguous(),
        Y.to(f32).contiguous(), max_iter, prox_A, prox_S, float(e_rel),
        int(tile_n), conv_A0=conv0[0], conv_S0=conv0[1], div0=div0,
        loss0=loss0, SSt0=SSt0)
    A_out, S_out = A_f.to(dtype), S_f.to(dtype)
    converged = (conv_A, conv_S)
    diverged = div0 or (iterations > 0 and not np.isfinite(loss))
    logger.info("Completed %d iterations", iterations)
    status = status_from(all(converged), diverged, logger)
    writeback((A_in, S_in), (A_out, S_out))
    resume_state = {
        "kind": "nmf_pgm_fused", "weighted": False,
        "stride_config": stride_cfg, "store_dtype": None,
        "tile_n": int(tile_n), "it": it0 + iterations,
        "converged": np.asarray(converged, bool), "diverged": diverged,
        "loss": loss, "steps": SSt_f,
    }
    return SolverResult(
        converged,
        x=(A_out, S_out), iterations=iterations, converged=converged,
        loss=loss, status=status, state=resume_state,
    )


_LATER_ALGORITHMS = {"adaprox": 8, "bsdmm": 11}


def _resolve_algorithm(algorithm):
    """``None``, ``"pgm"`` or the port's ``pgm``; the JAX package's other
    nmf algorithms raise ``NotImplementedError``, anything else
    ``ValueError``."""
    if algorithm is None or algorithm is algorithms.pgm:
        return algorithms.pgm
    name = algorithm.lower() if isinstance(algorithm, str) else None
    if name == "pgm":
        return algorithms.pgm
    if name in _LATER_ALGORITHMS:
        raise _not_yet(f"nmf(algorithm={algorithm!r})",
                       _LATER_ALGORITHMS[name])
    raise ValueError(f"unknown algorithm {algorithm!r}; nmf supports 'pgm' "
                     "(adaprox and bsdmm are later slices)")


def nmf(
    Y,
    A,
    S,
    W=1,
    prox_A=operators.prox_plus,
    prox_S=operators.prox_plus,
    algorithm=None,
    step=None,
    max_iter=1000,
    e_rel=1e-3,
    callback=None,
    engine="torch",
    step_stride=None,
    step_adapt=False,
    mesh=None,
    device=None,
    **algorithm_args,
):
    """Non-negative / constrained matrix factorization by PGM.

    Solves ``minimize 0.5 ||Y - A S||^2`` under proximal constraints on A
    and S.

    Args:
        Y: target (C, N). A: initial (C, K). S: initial (K, N). NumPy
            inputs are updated in place; tensors stay on their device.
        W: only the scalar 1 (unweighted) so far.
        prox_A, prox_S: per-factor constraints (None = identity).
        algorithm: None or ``"pgm"``.
        step: optional step callable ``step(*X, it=...)`` (torch engine).
        max_iter, e_rel: forwarded to the solver.
        engine: ``"torch"`` (generic PGM driver on tensor ops) or
            ``"cuda"`` (the fused K1 kernel per iteration,
            :func:`nmf_pgm_fused`; on CPU tensors its plain version).
        device: where NumPy inputs go (default: the device of a tensor
            input, else the CPU).
        algorithm_args: ``accelerated``, ``restart``, ``state`` for the
            torch engine; ``tile_n``, ``state`` for the cuda engine.

    A ``state=`` from :func:`nmf_pgm_fused` pins ``engine="cuda"``.

    Returns:
        The solver's ``SolverResult``; ``result.x == (A, S)``.
    """
    algorithm = _resolve_algorithm(algorithm)
    if (np.ndim(Y) != 2 or np.ndim(A) != 2 or np.ndim(S) != 2
            or np.shape(A)[0] != np.shape(Y)[0]
            or np.shape(A)[1] != np.shape(S)[0]
            or np.shape(S)[1] != np.shape(Y)[1]):
        raise ValueError(
            f"factorization shape mismatch: Y {tuple(np.shape(Y))}, "
            f"A {tuple(np.shape(A))}, S {tuple(np.shape(S))}: need Y (C, N), "
            "A (C, K), S (K, N) with Y = A @ S")
    if not _is_unweighted(W):
        raise _not_yet("weighted nmf (W other than 1)", 6)
    if mesh is not None:
        raise _not_yet("nmf(mesh=) scale-out", 13)
    if engine == "auto":
        raise _not_yet("engine='auto' routing", 7)
    if (step_stride is not None and step_stride > 1) or step_adapt:
        raise _not_yet("step_stride / step_adapt", 6)

    device = _device_for(device, Y, A, S)
    if algorithm_args.get("state", True) is None:
        del algorithm_args["state"]
    st = algorithm_args.get("state")
    if hasattr(st, "get") and st.get("kind") == "nmf_pgm_fused":
        engine = "cuda"  # a fused state resumes only the fused engine

    if engine == "cuda":
        if step is not None or callback is not None:
            raise ValueError("engine='cuda' takes the default Lipschitz "
                             "steps and no callback; use engine='torch'")
        extra = set(algorithm_args) - {"tile_n", "state"}
        if extra:
            raise ValueError(f"unsupported fused-PGM options: "
                             f"{sorted(extra)}")
        return nmf_pgm_fused(Y, A, S, prox_A=prox_A, prox_S=prox_S,
                             e_rel=e_rel, max_iter=max_iter, device=device,
                             **algorithm_args)
    if engine != "torch":
        raise ValueError(f"unknown engine {engine!r}; the port has 'torch' "
                         "and 'cuda'")

    A_in, S_in = A, S
    Y, A, S = (promote_dtype(a, device=device) for a in (Y, A, S))
    grad = partial(grad_likelihood, Y=Y, W=1)
    if step is None:
        step = partial(step_pgm, W=1)
    res = algorithm([A, S], grad, step, prox=[prox_A, prox_S],
                    max_iter=max_iter, e_rel=e_rel, callback=callback,
                    **algorithm_args)
    writeback((A_in, S_in), res.x)
    return res
