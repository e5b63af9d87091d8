"""Constrained matrix factorization by PGM, AdaProx and bSDMM.

Counterpart of :mod:`proxmin_tpu.nmf` for ``min 0.5 ||sqrt(W) (Y - A S)||^2``
under proximal constraints on A and S, on two engines:

* ``engine="torch"`` (default; the JAX ``"xla"`` engine's counterpart): the
  generic :func:`~proxmin_tpu_torch.solvers.pgm.pgm` or
  :func:`~proxmin_tpu_torch.solvers.adaprox.adaprox` driver with
  :func:`grad_likelihood` and :func:`step_pgm` / :func:`step_adaprox` as
  tensor ops; ``step_stride``/``step_adapt`` wrap the steps in a
  :class:`~proxmin_tpu_torch.utils.StridedStepper`, or a
  :class:`WeightedPGMStepper` for weighted PGM.
* ``engine="cuda"`` (the JAX ``"pallas"`` engine's counterpart): one launch
  of a fused kernel per iteration, :func:`nmf_pgm_fused` on
  :func:`~proxmin_tpu_torch.ops.nmf_kernels.fused_nmf_pgm_step` (K1;
  weighted, strided and with a bfloat16 store) or
  :func:`nmf_adaprox_fused` on
  :func:`~proxmin_tpu_torch.ops.nmf_kernels.fused_nmf_adaprox_step` (K2).

``algorithm="bsdmm"`` runs the block-SDMM solver
(:func:`~proxmin_tpu_torch.solvers.bsdmm.bsdmm`) with each block's gradient
step wrapped as its ``prox_f``, on tensor ops; strided weighted steps come
from a :class:`WeightedBSDMMStepper`.

``engine="auto"`` picks one of the two per call, by the JAX package's
eligibility rules and a routing table measured on the H100
(``tools/engine_sweep.py``; ``_H100_REGIONS``): the cuda engine where it
was the faster, the torch engine elsewhere (and beyond the swept shapes)
and for everything the kernels do not run; bfloat16 moments or
store and an explicit ``tile_n`` go to the kernels. Inside the table's gray
zones the first solve of a shape times both engines
(:mod:`proxmin_tpu_torch.calibrate`).

``mesh=`` (a :func:`~proxmin_tpu_torch.parallel.make_mesh` mesh) runs PGM
and the adam-scheme AdaProx as the explicit-collective sharded solves of
:mod:`proxmin_tpu_torch.parallel` (``engine`` ``"torch"`` or ``"auto"``);
the other algorithms under a mesh are a later slice (ROADMAP.md Queue 1).
NumPy inputs go to the CUDA device unless ``device=`` says otherwise;
tensors stay where they are.
"""

import logging
from functools import partial

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from . import algorithms, operators, utils
from .ops.nmf_kernels import (DEFAULT_TILE_N, describe_prox,
                              fused_nmf_adaprox_step,
                              fused_nmf_pgm_step)
from .solvers.common import (SolverResult, as_tensor, as_torch_dtype,
                             default_device, promote_dtype, reduced,
                             replicated_like,
                             separable_blocks, status_from, writeback)
from .utils import StridedStepper, grow_stride

logger = logging.getLogger("proxmin")

__all__ = [
    "log_likelihood",
    "grad_likelihood",
    "step_A",
    "step_S",
    "step_pgm",
    "step_adaprox",
    "WeightedPGMStepper",
    "WeightedBSDMMStepper",
    "pgm_nmf_iteration",
    "nmf",
    "nmf_pgm_fused",
    "nmf_adaprox_fused",
]


def _is_unweighted(W):
    """True for None or the scalar 1 (the reference's ``W == 1``)."""
    if W is None:
        return True
    if isinstance(W, (int, float)):  # no NumPy: a captured program
        return float(W) == 1.0
    if isinstance(W, torch.Tensor) and W.ndim > 0:
        return False
    if np.isscalar(W) or getattr(W, "ndim", None) == 0:
        return float(W) == 1.0
    return False


def _promote_W(W, Y):
    """A weight argument as a full (C, N) tensor of Y's dtype on Y's
    device: scalars fill, lower-rank arrays broadcast against Y (the fused
    kernel needs the explicit 2-D form). One helper so the engines cannot
    drift."""
    if np.isscalar(W) or getattr(W, "ndim", None) == 0:
        # laid out as Y (a DTensor Y gives a DTensor W)
        return torch.full_like(Y, float(W),
                               memory_format=torch.contiguous_format)
    W = promote_dtype(W, device=Y.device)
    return torch.broadcast_to(W, Y.shape).to(Y.dtype).contiguous()


def _adaprox_separable_ok(prox_A, prox_S, mode):
    """True when every PRESENT prox has a known separable closed form under
    ``mode`` (the ``separable_prox`` argument); False instead of raising on
    an unknown mode."""
    prox_pair = (prox_A, prox_S)
    has = tuple(pj is not None for pj in prox_pair)
    try:
        sep = separable_blocks(prox_pair, has, mode)
    except ValueError:
        return False
    return all(s or not h for s, h in zip(sep, has))


def _fused_prox_safe(prox, block):
    """Can ``engine='auto'`` route this prox onto the fused PGM kernel?

    The JAX kernel applies ``prox_S`` per pixel tile (a prox that couples
    pixels, e.g. ``prox_unity(axis=1)`` on S, would compute tile-local
    sums) and ``prox_A`` on the padded factor; auto-routing therefore takes
    known library operators only, as the JAX rule does, and everything else
    stays on the torch engine. Explicit ``engine='cuda'`` keeps the
    trust-the-caller contract (:func:`nmf_pgm_fused`).
    """
    if prox is None:
        return True
    kw = {}
    if isinstance(prox, partial):
        if prox.args:  # positionally bound step or threshold
            return False
        kw = dict(prox.keywords)
        prox = prox.func
    if prox in (operators.prox_id, operators.prox_zero,
                operators.prox_plus, operators.prox_min,
                operators.prox_max, operators.prox_hard,
                operators.prox_hard_plus, operators.prox_soft,
                operators.prox_soft_plus, operators.prox_max_entropy):
        return True  # elementwise for every keyword
    if prox in (operators.prox_unity, operators.prox_unity_plus):
        # A is proxed whole; S only along the factor axis is pixel-local
        return True if block == "A" else kw.get("axis", 0) == 0
    if isinstance(prox, operators.AlternatingProjections):
        return all(_fused_prox_safe(p, block) for p in prox.operators)
    return False


#: The H100 routing table, from ``tools/engine_sweep.py`` on an NVIDIA H100
#: 80GB HBM3 at 700.00 W (``PERF.md`` section 6; printed by
#: ``tools/engine_sweep.py --table``). For each path and swept (C, K):
#: ``(n_x, gray)``. ``n_x`` is the least swept N (1e4, 1e5, 1e6, 1e7) from
#: which on the cuda engine's marginal ms/iter was the smaller at every
#: larger swept N: 0 where it was at every one, None where at none.
#: ``gray`` is the inclusive N range where the sweep could not tell the
#: engines apart around that crossover (their pair slopes overlapped, or
#: between the two swept N that straddle it); None without a crossover.
#: A shape takes the entry of the smallest swept (C, K) that covers it, and
#: the torch engine where none does. The very-wide rows (300, 8), (128, 64),
#: (425, 32) and (128, 128) were swept at N = 1e5 and 1e6 only; (128, 64)
#: again, and (128, 128) first, once the residual modes past K = 32 kept
#: everything on chip (``csrc/kwide_pass.cuh``).
_H100_REGIONS = {
    "pgm-exact": {
        (5, 7): (1_000_000, (10_000, 1_000_000)),
        (16, 8): (0, None),
        (32, 16): (100_000, (10_000, 100_000)),
        (64, 16): (1_000_000, (10_000, 999_999)),
        (128, 32): (100_000, (10_000, 100_000)),
        (128, 64): (0, None),
        (128, 128): (None, None),
        (256, 32): (1_000_000, (10_000, 999_999)),
        (300, 8): (0, None),
        (425, 32): (0, None),
    },
    "pgm-stride10": {
        (5, 7): (1_000_000, (10_000, 1_000_000)),
        (16, 8): (1_000_000, (10_000, 1_000_000)),
        (32, 16): (1_000_000, (100_001, 1_000_000)),
        (64, 16): (100_000, (10_000, 100_000)),
        (128, 32): (100_000, (10_000, 100_000)),
        (128, 64): (1_000_000, (100_001, 999_999)),
        (128, 128): (None, None),
        (256, 32): (1_000_000, (100_000, 999_999)),
        (300, 8): (1_000_000, (100_001, 999_999)),
        (425, 32): (0, None),
    },
    "pgm-w-stride10": {
        (5, 7): (10_000_000, (10_000, 9_999_999)),
        (16, 8): (100_000, (10_000, 1_000_000)),
        (32, 16): (1_000_000, (10_000, 1_000_000)),
        (64, 16): (100_000, (10_000, 99_999)),
        (128, 32): (0, None),
        (128, 64): (1_000_000, (100_000, 999_999)),
        (128, 128): (None, None),
        (256, 32): (100_000, (10_001, 100_000)),
        (300, 8): (1_000_000, (100_000, 999_999)),
        (425, 32): (0, None),
    },
    "adaprox-f32": {
        (5, 7): (0, None),
        (16, 8): (0, None),
        (32, 16): (0, None),
        (64, 16): (0, None),
        (128, 32): (0, None),
        (128, 64): (0, None),
        (128, 128): (0, None),
        (256, 32): (1_000_000, (10_000, 999_999)),
        (300, 8): (1_000_000, (100_000, 999_999)),
        (425, 32): (0, None),
    },
}


def _covering(table, C, K):
    """The entry of the smallest swept (c, k) with C <= c and K <= k."""
    for (c, k), entry in sorted(table.items()):
        if C <= c and K <= k:
            return entry
    return None, None


def _cuda_wins(path, C, K, N):
    n_x = _covering(_H100_REGIONS[path], C, K)[0]
    return n_x is not None and N >= n_x


def _gray_range(path, C, K):
    """The inclusive N range in which the sweep could not tell the engines
    apart for ``path`` at (C, K), or None."""
    return _covering(_H100_REGIONS[path], C, K)[1]


def _unweighted_fused_wins(C, K, N):
    """Where the cuda engine's exact PGM (K1, the Gram of the S it just
    wrote) beats the torch engine's, unweighted: measured by
    ``tools/engine_sweep.py`` on an NVIDIA H100 80GB HBM3 at 700.00 W
    (``_H100_REGIONS["pgm-exact"]``). Both engines are host-bound at
    N <= 1e5 (about 1.3-3.0 ms/iter on that host, device busy under a
    third of it): the two sat within their pair spread at every such point
    but (16, 8, 1e5). The cuda engine won from N = 1e6 at every shape
    (1.23x at (5, 7), 1.58-1.68x at (128, 32) and (256, 32)) and by
    2.6-3.6x at 1e7; from 1e5 at (32, 16) and (128, 32), at every N at
    (16, 8). Past C = 256 (the very-wide rows) the cuda engine won at
    1e5 and 1e6 at (300, 8) and (425, 32) (1.32x at (425, 32, 1e6)); at
    (128, 64) too since the residual modes past K = 32 keep gS and the
    epilogue on chip (1.25x at 1e6, within the spread at 1e5; the torch
    engine was the faster before); at (128, 128) the torch engine (1.02x
    at 1e6, within the spread at 1e5).
    Inside the gray ranges the probes decide
    (:mod:`proxmin_tpu_torch.calibrate`)."""
    return _cuda_wins("pgm-exact", C, K, N)


def _unweighted_strided_fused_wins(C, K, N):
    """Where the cuda engine's unweighted strided runner (steps refreshed
    once a segment from K1's Gram) beats the torch engine's
    :class:`~proxmin_tpu_torch.utils.StridedStepper`, at ``step_stride=10``
    (and for ``step_adapt``, which the sweep did not take separately):
    ``_H100_REGIONS["pgm-stride10"]``, NVIDIA H100 80GB HBM3 at 700.00 W.
    Within the spread at N <= 1e5 (torch ahead by 1.4x at (256, 32, 1e4)
    and (32, 16, 1e5)), the cuda engine from N = 1e6 (1.02x at (5, 7), up
    to 1.77x at (256, 32)) or 1e5 at (64, 16) and (128, 32), and 2.5-4.4x
    at 1e7. Separately measured from the exact region, with its own
    crossovers."""
    return _cuda_wins("pgm-stride10", C, K, N)


def _weighted_fused_wins(C, K, N):
    """Where the cuda engine's weighted runner (K1 with W, the batched power
    iteration every ``step_stride`` iterations) beats the torch engine's
    :class:`WeightedPGMStepper`, at ``step_stride=10``; weighted
    ``step_adapt`` takes the same region: ``_H100_REGIONS["pgm-w-stride10"]``,
    NVIDIA H100 80GB HBM3 at 700.00 W. The refresh runs on tensor ops in
    both engines, so the cuda engine gains least here: within the spread
    up to N = 1e6 at (5, 7) to (32, 16) (0.99-1.06x at 1e6), the faster
    from 1e5 at (16, 8), (64, 16) and (256, 32), from 1e6 at (32, 16),
    from 1e7 at (5, 7) and at every N at (128, 32); 1.15-1.35x at 1e6 from
    C = 64, 1.47-1.66x at 1e7. The adaptive path, swept beside it
    (``PERF.md``), sat within its spread at every N <= 1e5, and up to 1e6
    at C <= 32; the cuda engine won it from C = 64 at 1e6 and everywhere
    at 1e7 (2.3-3.4x)."""
    return _cuda_wins("pgm-w-stride10", C, K, N)


def _adaprox_fused_wins(C, K, N):
    """Where the cuda engine's float32 AdaProx (K2) beats the torch engine's
    driver with ``separable_prox="auto"``: ``_H100_REGIONS["adaprox-f32"]``,
    NVIDIA H100 80GB HBM3 at 700.00 W. At every swept N up to C = 128,
    K = 32 (1.02-1.25x at N <= 1e5, 1.13-2.02x at 1e6, 3.3-4.3x at 1e7);
    at (256, 32) within the spread at 1e4 and 1e5 and from 1e6 on (1.86x).
    The JAX package keeps float32 AdaProx on XLA: a v5e measurement that
    the H100 reverses. bfloat16 moments and store stay an opt-in: they
    always route to K2 and are never chosen for the caller."""
    return _cuda_wins("adaprox-f32", C, K, N)


def _calibrated_engine(Y, A, S, W, prox_A, prox_S, e_rel, step_stride,
                       step_adapt, algorithm_args, C, K, N, weighted,
                       strided, static, device):
    """Resolve the torch-vs-cuda decision of one auto-routed PGM solve: the
    static regions away from the measured crossovers, a one-shot probe
    (cached per device kind, shape, policy, dtype and ``e_rel``) inside
    the gray zone; see :mod:`proxmin_tpu_torch.calibrate`."""
    from . import calibrate

    if (calibrate._MODE != "on"
            or not calibrate.in_gray_zone(C, K, N, weighted, strided)):
        return static  # no probe: nothing to copy
    key = (calibrate.device_kind(device), C, K, N, weighted,
           int(step_stride) if step_stride else 0, bool(step_adapt),
           str(A.dtype).removeprefix("torch.")
           if isinstance(A, torch.Tensor) else str(np.asarray(A).dtype),
           float(e_rel))
    # copies on the solve's device: a probe never writes into the caller's
    # arrays (NumPy inputs are updated in place by nmf)
    Yp = promote_dtype(Y, device=device)
    Wp = 1 if _is_unweighted(W) else _promote_W(W, Yp)
    Ap = promote_dtype(A, device=device).clone()
    Sp = promote_dtype(S, device=device).clone()
    probe_kw = dict(algorithm_args)
    probe_kw.pop("state", None)  # a resume state never rides into a probe

    def make_probe(eng):
        def probe(n):
            # the caller's e_rel rides into the probe: a solve that
            # converges inside the budget is seen (it ran fewer than n)
            res = nmf(Yp, Ap, Sp, W=Wp, prox_A=prox_A, prox_S=prox_S,
                      e_rel=e_rel, max_iter=n, engine=eng,
                      step_stride=step_stride, step_adapt=step_adapt,
                      device=device, **probe_kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return res.iterations
        return probe

    # fixed-iteration probes "do not converge" by design: drop exactly that
    # message for the probe window
    class _ExpectedNonConvergence(logging.Filter):
        def filter(self, record):
            return "did not converge" not in record.getMessage()

    flt = _ExpectedNonConvergence()
    logger.addFilter(flt)
    try:
        return calibrate.measured_choice(
            key, {"torch": make_probe("torch"), "cuda": make_probe("cuda")},
            static)
    finally:
        logger.removeFilter(flt)


def _route_auto(Y, A, S, W, prox_A, prox_S, algorithm, step, callback,
                e_rel, step_stride, step_adapt, device, algorithm_args):
    """``engine='auto'``: the engine for this call and its options (a
    full-width ``store_dtype`` normalized away). The JAX package's rules,
    with the regions measured on the H100 (``_unweighted_fused_wins``,
    ``_unweighted_strided_fused_wins``, ``_weighted_fused_wins``,
    ``_adaprox_fused_wins``); the kernels take every (C, K)."""
    # None or a full-width store_dtype is the default layout; a reduced one
    # is a capacity request only the fused kernels honor
    if "store_dtype" in algorithm_args:
        sdt = as_torch_dtype(algorithm_args["store_dtype"])
        if sdt is None or sdt.itemsize >= 4:
            algorithm_args = dict(algorithm_args)
            del algorithm_args["store_dtype"]
    C, N = np.shape(Y)
    K = np.shape(A)[1]
    fused_adaprox_ok = False
    if (algorithm is algorithms.adaprox and step is None
            and callback is None and step_stride is None and not step_adapt
            and algorithm_args.get("scheme", "adam") == "adam"
            and set(algorithm_args) <= {
                "b1", "b2", "eps", "tile_n", "moment_dtype", "store_dtype",
                "M", "V", "state", "scheme", "separable_prox"}):
        fused_adaprox_ok = _adaprox_separable_ok(
            prox_A, prox_S, algorithm_args.get("separable_prox", "auto"))
    mdt = as_torch_dtype(algorithm_args.get("moment_dtype"))
    reduced_moments = mdt is not None and mdt.itemsize < 4
    st = algorithm_args.get("state")
    if fused_adaprox_ok and st is not None:
        # an adaprox state resumes on the engine that made it: the fused
        # engine's carries its configuration (and K2's row sums)
        return ("cuda" if "fused_config" in st else "torch"), algorithm_args
    if fused_adaprox_ok and (reduced_moments or "tile_n" in algorithm_args
                             or "store_dtype" in algorithm_args):
        # bfloat16 moments or store are a precision opt-in that only K2
        # serves at full speed; an explicit tile_n forces the kernel
        return "cuda", algorithm_args
    if fused_adaprox_ok:
        return ("cuda" if _adaprox_fused_wins(C, K, N) else "torch",
                algorithm_args)
    cuda_only = set(algorithm_args) & {"tile_n", "store_dtype"}
    weighted = not _is_unweighted(W)
    # a strided or adaptive refresh is what makes the weighted fused runner
    # worth routing to (a refresh every iteration dominates either engine)
    strided = (step_stride is not None and step_stride > 1) or step_adapt
    weighted_strided = weighted and strided
    weighted_store = weighted and "store_dtype" in algorithm_args
    cuda_ok = (algorithm is algorithms.pgm and step is None
               and callback is None
               and set(algorithm_args) <= {"tile_n", "store_dtype"}
               and _fused_prox_safe(prox_A, "A")
               and _fused_prox_safe(prox_S, "S")
               and (weighted_store or weighted_strided or not weighted))
    if cuda_only and not cuda_ok:
        raise ValueError(
            f"{sorted(cuda_only)} are cuda-engine options but the call is "
            "not auto-routable to the fused kernels (pgm needs default "
            "steps, no callback and library proxs the kernel can apply "
            "per pixel; other pixel-local proxs can force "
            "the engine with engine='cuda'; adaprox needs the adam scheme "
            "and separable proxs)")
    if cuda_ok and cuda_only:
        return "cuda", algorithm_args
    if cuda_ok and (not weighted or weighted_strided):
        if weighted:
            wins = _weighted_fused_wins
        else:
            wins = (_unweighted_strided_fused_wins if strided
                    else _unweighted_fused_wins)
        static = "cuda" if wins(C, K, N) else "torch"
        return _calibrated_engine(
            Y, A, S, W, prox_A, prox_S, e_rel, step_stride, step_adapt,
            algorithm_args, C, K, N, weighted, strided, static,
            device), algorithm_args
    return "torch", algorithm_args


def _device_for(device, *arrays):
    """Where NumPy inputs go: ``device`` when given, else the device of the
    first tensor among ``arrays``, else the card (raising without one)."""
    if device is not None:
        return torch.device(device)
    dev = next((a.device for a in arrays if isinstance(a, torch.Tensor)),
               None)
    return default_device() if dev is None else dev


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
    # on sharded factors each contraction completes before it meets a
    # block: D S^T over the pixels, A^T D over a channel-sharded model axis
    return reduced(D @ S.T), reduced(A.T @ D)


def _lambda_max(G):
    """Largest eigenvalue of a small symmetric PSD matrix."""
    return torch.linalg.eigvalsh(G)[-1]


def step_A(A, S):
    """``1 / lambda_max(S S^T)``."""
    # torch.t, not .T: inside a torch.cond branch (an exported strided
    # bsdmm) .T of an input is lifted as an aliasing input, which the
    # capture refuses
    return 1.0 / _lambda_max(S @ torch.t(S))


def step_S(A, S):
    """``1 / lambda_max(A^T A)``."""
    return 1.0 / _lambda_max(torch.t(A) @ A)


def _weighted_lipschitz_A(S, W):
    """``max_c lambda_max(S diag(W[c, :]) S^T)``: the C per-channel K x K
    Grams in one einsum, then a batched ``eigvalsh``; past ``C K K =
    2**20`` elements of Grams, a batched Lanczos iteration on the implicit
    blocks instead (:func:`~proxmin_tpu_torch.utils.batched_lanczos_max`,
    ``min(K, 32) + 2`` steps)."""
    C = W.shape[0]
    K = S.shape[0]
    if C * K * K <= (1 << 20):
        if isinstance(W, DTensor):
            # the einsum's flattening views do not propagate a channel-
            # sharded W, so a DTensor takes the batched product. It is the
            # same contraction but not the same bits on plain tensors (a
            # few ulps apart on the CPU, where opt_einsum orders the
            # einsum by size), and it always builds the (C, K, N) product,
            # where the einsum may take the smaller (K, K, N) one: plain
            # tensors keep the einsum.
            H = torch.matmul(W[:, None, :] * S[None, :, :], S.T)
        else:
            H = torch.einsum("kn,cn,ln->ckl", S, W, S)
        return torch.max(torch.linalg.eigvalsh(H)[:, -1])

    dtype = torch.promote_types(S.dtype, W.dtype)
    v0 = (torch.ones((C, K), dtype=dtype, device=S.device)
          + 0.01 * torch.arange(K, dtype=dtype, device=S.device))
    v0 = replicated_like(v0 / torch.linalg.norm(v0, dim=1, keepdim=True), S)

    def Hv(v):
        return reduced((W * (v @ S)) @ S.T)

    return utils.batched_lanczos_max(Hv, v0, min(K, 32) + 2)


def _weighted_lipschitz_S_v0(N, K, dtype, device, W=None):
    """The deterministic cold-start iterate (N, K) of the batched power
    iteration, each row normalized. With a ``DTensor`` ``W`` the iterate
    is laid out along W's pixel axis: each rank makes its own rows."""
    if isinstance(W, DTensor):
        n = W.to_local().shape[1]
        v = _weighted_lipschitz_S_v0(n, K, dtype, device)
        placements = [Shard(0) if p == Shard(1) else Replicate()
                      for p in W.placements]
        return DTensor.from_local(v, W.device_mesh, placements,
                                  run_check=False, shape=(N, K),
                                  stride=(K, 1))
    v = (torch.ones((N, K), dtype=dtype, device=device)
         + 0.01 * torch.arange(K, dtype=dtype, device=device))
    return v / torch.linalg.norm(v, dim=1, keepdim=True)


def _lam_max_psd_batch(H, iters):
    """The largest top eigenvalue over a stack of small PSD Grams ``(C, K,
    K)`` by a batched power iteration of ``iters`` passes: products and
    elementwise operations only, so it runs under ``torch.func.vmap``.
    :func:`~proxmin_tpu_torch.functional.make_nmf_solver`'s weighted path
    takes it; the drivers take ``eigvalsh``
    (:func:`_weighted_lipschitz_A`)."""
    c, k, _ = H.shape
    tiny = torch.finfo(H.dtype).tiny
    u = (torch.ones((c, k), dtype=H.dtype, device=H.device)
         + 0.01 * torch.arange(k, dtype=H.dtype, device=H.device))
    for _ in range(int(iters)):
        w = torch.einsum("ckl,cl->ck", H, u)
        ssq = torch.sum(w * w, dim=1, keepdim=True)
        u = w * torch.rsqrt(torch.clamp_min(ssq, tiny))
    hu = torch.einsum("ckl,cl->ck", H, u)
    ray = torch.sum(u * hu, dim=1) / torch.clamp_min(
        torch.sum(u * u, dim=1), tiny)
    return torch.max(ray)


def _weighted_lipschitz_S(A, W, num_iters=48, v0=None, return_v=False,
                          extra=None):
    """``max_n lambda_max(A^T diag(W[:, n]) A)`` by a batched power
    iteration over the N per-pixel K x K blocks, never formed: ``num_iters``
    passes from ``v0`` (default: the cold start), then the largest Rayleigh
    quotient. A fully masked pixel (``W[:, n] = 0``) gives 0, not NaN.
    ``return_v`` also returns the next warm start (one more pass,
    normalized). ``extra`` (a 0-d integer CPU tensor) adds that many passes
    after the first ``num_iters`` as a ``while_loop`` whose count the host
    holds: an exported program's cold start."""
    N = W.shape[1]
    K = A.shape[1]
    v = (_weighted_lipschitz_S_v0(N, K, A.dtype, A.device, W) if v0 is None
         else v0)
    tiny = torch.finfo(A.dtype).tiny

    def Hv(v):
        return reduced((W * (A @ v.T)).T @ A)

    def normalize(w):
        ssq = torch.sum(w * w, dim=1, keepdim=True)
        return w * torch.rsqrt(torch.clamp_min(ssq, tiny))

    for _ in range(int(num_iters)):
        v = normalize(Hv(v))
    if extra is not None:
        from torch._higher_order_ops.while_loop import while_loop

        _, v = while_loop(lambda k, v: k < extra,
                          lambda k, v: (k + 1, normalize(Hv(v))),
                          (torch.zeros_like(extra), v))
    hv = Hv(v)
    rayleigh = torch.sum(v * hv, dim=1) / torch.clamp_min(
        torch.sum(v * v, dim=1), tiny)
    lmax = torch.max(rayleigh)
    if return_v:
        return lmax, normalize(hv)
    return lmax


def step_pgm(*X, it=None, W=1):
    """Lipschitz PGM step sizes ``(step_A, step_S)``; weighted with a
    (C, N) ``W``: ``1 / max_c lambda_max(S diag(W_c) S^T)`` and
    ``1 / max_n lambda_max(A^T diag(W_n) A)`` (48 cold power passes)."""
    A, S = X
    if _is_unweighted(W):
        return step_A(A, S), step_S(A, S)
    return 1.0 / _weighted_lipschitz_A(S, W), 1.0 / _weighted_lipschitz_S(A, W)


#: Power passes of a weighted refresh: from the cold start at global
#: iteration 0, and warm-started from the previous refresh's iterate after.
_COLD_ITERS, _WARM_ITERS = 48, 12


class WeightedPGMStepper:
    """Strided weighted-Lipschitz steps with the power iterate carried in
    the state, warm-started between refreshes.

    Counterpart of :class:`proxmin_tpu.nmf.WeightedPGMStepper` (and its
    base ``_WeightedStepperBase``): a refresh every ``stride`` iterations
    computes both weighted bounds, ``cold_iters`` power passes on the first
    refresh (global iteration 0) and ``warm_iters`` after, each step shrunk
    by ``safety``; ``adapt=True`` grows or shrinks the interval with
    :func:`~proxmin_tpu_torch.utils.grow_stride`. The state is the JAX
    layout ``((step_A, step_S), v, stride, next_refresh)``, with the stride
    and the clock as host integers. The JAX ``split_data`` and
    ``stepper_cache_key`` hooks serve ``jit`` and have no counterpart in
    eager PyTorch.
    """

    segmentable = True

    def __init__(self, W, stride=10, safety=0.9, cold_iters=_COLD_ITERS,
                 warm_iters=_WARM_ITERS, adapt=False, max_stride=100):
        self.W = W
        self.stride = int(stride)
        self.safety = float(safety)
        self.cold_iters = int(cold_iters)
        self.warm_iters = int(warm_iters)
        self.adapt = bool(adapt)
        self.max_stride = int(max_stride)

    def init_state(self, X, G):
        A, _ = X
        v0 = _weighted_lipschitz_S_v0(self.W.shape[1], A.shape[1], A.dtype,
                                      A.device, self.W)
        zero = torch.zeros((), dtype=A.dtype, device=A.device)
        return ((zero, zero), v0, self.stride, 0)

    def segment_refresh(self, state, X, it):
        """Fresh steps and warm iterate at global iteration ``it``;
        returns ``(steps, state)``."""
        A, S = X
        cached, v, stride, _ = state
        LA = _weighted_lipschitz_A(S, self.W)
        LS, v_new = _weighted_lipschitz_S(
            A, self.W, self.cold_iters if it == 0 else self.warm_iters,
            v0=v, return_v=True)
        steps = (self.safety / LA, self.safety / LS)
        if self.adapt:
            stride = grow_stride(stride, cached, steps,
                                 (1.0 - self.safety) / 2, self.max_stride,
                                 first=(it == 0))
        return steps, (steps, v_new, stride, it + stride)

    def state_stride(self, state):
        return state[2]

    def state_steps(self, state):
        return state[0]

    def segment_end(self, state, it):
        return state[3]

    def __call__(self, state, X, it, G):
        if it >= state[3]:
            state = self.segment_refresh(state, X, it)[1]
        return state[0], state


class WeightedBSDMMStepper:
    """Stateful per-block steps for the weighted bsdmm route (the bsdmm
    solver's stateful-steps protocol).

    Counterpart of :class:`proxmin_tpu.nmf.WeightedBSDMMStepper`: each
    block's refresh computes only that block's weighted bound, the S
    block's batched power iterate warm-starts across refreshes
    (``cold_iters`` passes on sweep 0, ``warm_iters`` after), and each
    refreshed step shrinks by ``safety``; ``adapt=True`` grows or shrinks
    each block's interval with
    :func:`~proxmin_tpu_torch.utils.grow_stride`. The state is the JAX
    layout ``(v, strides, next_refresh)`` with the two strides and the two
    next-refresh sweeps (index 0 the A block, 1 the S block) as host
    integers. The JAX ``split_data``, ``stepper_cache_key``,
    ``segmented_bsdmm`` and ``state_seg_end`` hooks serve ``jit`` and have
    no counterpart in a host loop.

    Called with a tensor clock ``it`` (an exported bsdmm loop, whose carry
    holds the clock, the strides and the next refreshes as 0-d int64 CPU
    tensors), the refresh is a ``while_loop`` of zero or one trip on ``it
    >= next_refresh`` and the cold start's extra passes a ``while_loop`` on
    ``it == 0``, both decided on the host without a read; the adaptive
    interval is :func:`grow_stride`'s tensor form on the card, copied to
    the host clock once per refresh (where the host rule reads its drift).
    The numbers are the host path's; the driver keeps the host path, which
    runs faster (``solvers.bsdmm._Program.sweep``).
    """

    def __init__(self, W, stride=10, safety=0.9, cold_iters=_COLD_ITERS,
                 warm_iters=_WARM_ITERS, adapt=False, max_stride=100):
        self.W = W
        self.stride = int(stride)
        self.safety = float(safety)
        self.cold_iters = int(cold_iters)
        self.warm_iters = int(warm_iters)
        self.adapt = bool(adapt)
        self.max_stride = int(max_stride)

    def init_bsdmm_state(self, xs):
        A, _ = xs
        v0 = _weighted_lipschitz_S_v0(self.W.shape[1], A.shape[1], A.dtype,
                                      A.device, self.W)
        return (v0, (self.stride, self.stride), (0, 0))

    def _traced(self, Xs, j, state, it, cached):
        """:meth:`__call__` on a tensor clock (see the class docstring)."""
        from torch._higher_order_ops.while_loop import while_loop

        A, S = Xs
        v, strides, nxt = state
        due = (it >= nxt[j]).to(torch.int64)
        extra = (it == 0).to(torch.int64) * (self.cold_iters
                                             - self.warm_iters)

        def refresh(k, old, stride_j, nxt_j, *v):
            # ``old`` is the carried step (the loop takes one trip at most)
            if j == 0:
                step = self.safety / _weighted_lipschitz_A(S, self.W)
            else:
                LS, w = _weighted_lipschitz_S(A, self.W, self.warm_iters,
                                              v0=v[0], return_v=True,
                                              extra=extra)
                step, v = self.safety / LS, (w,)
            if self.adapt:
                grown = grow_stride(stride_j.to(old.device), (old,), (step,),
                                    (1.0 - self.safety) / 2,
                                    self.max_stride, first=(it == 0))
                # the host rule reads its drift here too
                stride_j = grown.to(stride_j.device)
            else:
                # a new tensor: a loop body may not return its input
                stride_j = stride_j.clone()
            return (k + 1, step.to(old.dtype), stride_j, it + stride_j, *v)

        # the power iterate rides through the S block's refresh only
        _, step, stride_j, nxt_j, *w = while_loop(
            lambda k, *r: k < due, refresh,
            (torch.zeros_like(due), cached, strides[j], nxt[j],
             *((v,) if j == 1 else ())))
        strides, nxt = list(strides), list(nxt)
        strides[j], nxt[j] = stride_j, nxt_j
        return step, (w[0] if j == 1 else v, tuple(strides), tuple(nxt))

    def __call__(self, Xs, j=None, state=None, it=None, cached=None):
        if isinstance(it, torch.Tensor):
            return self._traced(Xs, j, state, it, cached)
        A, S = Xs
        v, strides, nxt = state
        if it < nxt[j]:
            return cached, state
        if j == 0:
            step = self.safety / _weighted_lipschitz_A(S, self.W)
        else:
            LS, v = _weighted_lipschitz_S(
                A, self.W, self.cold_iters if it == 0 else self.warm_iters,
                v0=v, return_v=True)
            step = self.safety / LS
        stride_j = strides[j]
        if self.adapt:
            # suppressed on the first sweep: the carried step starts at 1,
            # not at a bound, so its drift would mean nothing
            stride_j = grow_stride(stride_j, (cached,), (step,),
                                   (1.0 - self.safety) / 2, self.max_stride,
                                   first=(it == 0))
        strides, nxt = list(strides), list(nxt)
        strides[j], nxt[j] = stride_j, it + stride_j
        return step, (v, tuple(strides), tuple(nxt))


def step_adaprox(*X, it=None, reduce=None, size=None):
    """Per-element AdaProx step heuristic: a tenth of the column means of A
    and of the row means of S (sums divided by the count, as
    ``jnp.mean``). A per-rank program, whose blocks are local shards,
    passes ``reduce(j, t)`` to complete block ``j``'s sums over the ranks
    that share it and ``size``, the global ``(C, N)``."""
    A, S = X
    C, N = (A.shape[0], S.shape[1]) if size is None else size
    if reduce is None:
        def reduce(j, t):
            return reduced(t)
    return (reduce(0, torch.sum(A, dim=0)) / C / 10,
            reduce(1, torch.sum(S, dim=1, keepdim=True)) / N / 10)


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


#: The strided runners' policy, as in the JAX package: each refresh's steps
#: shrink by this factor, and ``step_adapt`` caps the interval here.
_SAFETY = 0.9
_MAX_STRIDE = 100


def _exact_steps(A, SSt):
    """The exact Lipschitz steps ``(1 / lambda_max(S S^T), 1 /
    lambda_max(A^T A))`` from K1's Gram of the current S."""
    return 1.0 / _lambda_max(SSt), 1.0 / _lambda_max(A.T @ A)


def _weighted_steps(A, S, W32, v, passes, extra=None):
    """The weighted Lipschitz steps from float32 views of the store and the
    next power iterate: ``(step_A, step_S, v')`` after ``passes`` passes
    from ``v`` (and ``extra`` more, see :func:`_weighted_lipschitz_S`)."""
    LA = _weighted_lipschitz_A(S.to(torch.float32), W32)
    LS, v = _weighted_lipschitz_S(A, W32, passes, v0=v, return_v=True,
                                  extra=extra)
    return 1.0 / LA, 1.0 / LS, v


def _pgm_iterate(A, S, Y, W, sA, sS, prox_A, prox_S, e_rel, tile_n):
    """One fused PGM iteration with frozen steps: K1, the C x K A update
    and the stop flags, ``(A', S', SSt', conv_A, conv_S, loss)``. The loop
    body that the host loop (:func:`_run_fused_pgm`) and the exported
    programs (:func:`_fused_pgm_program`, :func:`_fused_weighted_program`)
    share."""
    gA, S_new, SSt_new, loss, dS_sq, nS_sq = fused_nmf_pgm_step(
        A, S, Y, sS, W=W, prox_S=prox_S, tile_n=tile_n)
    A_new = prox_A(A - sA * gA, sA)
    dA_sq = torch.sum((A_new - A) ** 2)
    nA_sq = torch.sum(A_new ** 2)
    conv_A = _fused_fp_conv(dA_sq, nA_sq, e_rel)
    conv_S = _fused_fp_conv(dS_sq, nS_sq, e_rel)
    loss = _poison_loss(loss, dA_sq, nA_sq, dS_sq, nS_sq)
    return A_new, S_new, SSt_new, conv_A, conv_S, loss


def _run_fused_pgm(A, S, Y, W, max_iter, prox_A, prox_S, e_rel, tile_n,
                   stride=1, adapt=False, safety=1.0, it0=0,
                   conv0=(False, False), div0=False, loss0=np.inf,
                   steps0=None):
    """The fused PGM loop on K1, one launch per iteration. Counterpart of
    the ``run`` built by ``proxmin_tpu.nmf._make_fused_pgm_runner`` (the
    exact steps: ``stride=1``, ``safety=1``),
    ``_make_fused_strided_pgm_runner`` and
    ``_make_fused_weighted_pgm_runner``, as one host loop.

    A is (C, K) float32; S and Y, and W when weighted, are all float32 or
    all bfloat16 (the store). The steps refresh when the global iteration
    reaches the next-refresh clock, a host integer: unweighted from the
    ``S S^T`` Gram K1 carried out of the previous iteration and ``A^T A``
    (two K x K eigensolves, no pixel traffic); weighted from the weighted
    bounds on float32 views of the stores, with the power iterate ``v``
    (N, K) warm-started (``_COLD_ITERS`` passes at global iteration 0,
    ``_WARM_ITERS`` after). Each
    refresh's steps shrink by ``safety``; with ``adapt`` the interval
    follows :func:`grow_stride`, which reads the device once per refresh.
    Between refreshes the steps stay frozen and nothing but K1 and the
    C x K A update runs (:func:`_pgm_iterate`).

    ``steps0`` resumes from ``(sA, sS, Gram or v, stride, next_refresh)``:
    the frozen steps serve until the carried clock, so a resume mid-segment
    or on a boundary walks the straight solve's iterations; the Gram is
    K1's own (a fresh ``S S^T`` sums in another order, and its last-bit
    differences would compound). Returns ``(A, S, it, conv_A, conv_S,
    loss, steps)`` with ``steps`` in that layout."""
    dev = A.device
    f32 = torch.float32
    weighted = W is not None
    K, N = S.shape
    if steps0 is None:
        zero = torch.zeros((), dtype=f32, device=dev)
        sA, sS, stride_c, nxt = zero, zero, int(stride), int(it0)
        if weighted:
            aux = _weighted_lipschitz_S_v0(N, K, f32, dev)
        else:
            S32 = S.to(f32)
            aux = S32 @ S32.T
    else:
        sA, sS, aux, stride_c, nxt = steps0
        sA, sS = (as_tensor(v, f32, dev).reshape(()) for v in (sA, sS))
        aux = as_tensor(aux, f32, dev)
        stride_c, nxt = int(stride_c), int(nxt)
    W32 = None if W is None else W.to(f32)
    budget = (1.0 - safety) / 2
    conv_A = torch.tensor(bool(conv0[0]), device=dev)
    conv_S = torch.tensor(bool(conv0[1]), device=dev)
    loss = torch.tensor(float(loss0), dtype=f32, device=dev)
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
        g = it0 + it
        if g >= nxt:
            if weighted:
                sA_n, sS_n, aux = _weighted_steps(
                    A, S, W32, aux, _COLD_ITERS if g == 0 else _WARM_ITERS)
            else:
                sA_n, sS_n = _exact_steps(A, aux)
            if safety != 1.0:
                sA_n, sS_n = safety * sA_n, safety * sS_n
            if adapt:
                stride_c = grow_stride(stride_c, (sA, sS), (sA_n, sS_n),
                                       budget, _MAX_STRIDE, first=(g == 0))
            nxt = g + stride_c
            sA, sS = sA_n, sS_n
        A, S, SSt_new, conv_A, conv_S, loss = _pgm_iterate(
            A, S, Y, W, sA, sS, prox_A, prox_S, e_rel, tile_n)
        if not weighted:
            aux = SSt_new
        it += 1
    return (A, S, it, bool(conv_A), bool(conv_S), float(loss),
            (sA, sS, aux, stride_c, nxt))


def _fused_go0(conv_A, conv_S, div0):
    """Whether a fused loop takes its first iteration: not both factors
    converged and no carried divergence (the initial loss is inf by design
    and is not tested)."""
    return torch.logical_not(
        torch.logical_or(torch.logical_and(conv_A, conv_S), div0))


def _fused_go(conv_A, conv_S, loss):
    """Whether a fused loop goes on after an iteration: a finite loss (a
    non-finite one means divergence) and not both factors converged."""
    return torch.logical_and(
        torch.isfinite(loss),
        torch.logical_not(torch.logical_and(conv_A, conv_S)))


def _fused_pgm_program(A, S, Y, max_iter, conv_A0, conv_S0, div0, loss0,
                       SSt0, prox_A, prox_S, e_rel, tile_n):
    """The exact fused PGM solve as one ``while_loop`` that
    ``torch.export`` captures: the counterpart of the ``run`` of
    ``proxmin_tpu.nmf._make_fused_pgm_runner``, on :func:`_exact_steps` and
    :func:`_pgm_iterate` as :func:`_run_fused_pgm` runs them. Every input
    is a tensor (``max_iter`` 0-d int32, the flags bool, ``loss0``
    float32, ``SSt0`` K1's Gram); returns ``(A, S, it, conv_A, conv_S,
    loss, SSt)`` with ``it`` counted from 0."""
    from torch._higher_order_ops.while_loop import while_loop

    def cond(A, S, SSt, it, conv_A, conv_S, loss, go):
        return torch.logical_and(go, it < max_iter)

    def body(A, S, SSt, it, conv_A, conv_S, loss, go):
        sA, sS = _exact_steps(A, SSt)
        A, S, SSt, conv_A, conv_S, loss = _pgm_iterate(
            A, S, Y, None, sA, sS, prox_A, prox_S, e_rel, tile_n)
        return (A, S, SSt, it + 1, conv_A, conv_S, loss,
                _fused_go(conv_A, conv_S, loss))

    it = torch.zeros((), dtype=torch.int32, device=A.device)
    return while_loop(cond, body,
                      (A, S, SSt0, it, conv_A0, conv_S0, loss0,
                       _fused_go0(conv_A0, conv_S0, div0)))[:7]


def _fused_weighted_program(A, S, Y, W, max_iter, it0, conv_A0, conv_S0,
                            div0, loss0, steps0, prox_A, prox_S, e_rel,
                            tile_n, stride=1, adapt=False, resume=False):
    """The weighted fused PGM solve as one ``while_loop`` that
    ``torch.export`` captures: the counterpart of the ``run`` of
    ``proxmin_tpu.nmf._make_fused_weighted_pgm_runner``, on
    :func:`_weighted_steps` and :func:`_pgm_iterate` as
    :func:`_run_fused_pgm` runs them.

    Every input is a tensor; ``steps0`` is ``(step_A, step_S, v, stride,
    next_refresh)`` and ``it0`` the global clock. As in the host loop, the
    steps refresh when the global clock reaches the next refresh (every
    iteration at ``stride=1``; shrunk by the safety factor and the interval
    grown by :func:`~proxmin_tpu_torch.utils.grow_stride` in its tensor
    form when strided), with the cold start's passes at global iteration 0.
    The clock and the next refresh are kept on the host too (CPU tensors,
    read from the card once per call on a resume, and after each adaptive
    refresh, as the host rule reads its drift): the refresh is a
    ``while_loop`` of zero or one trip on a host condition, so a loop
    iteration reads the card once, for its stop test. Returns ``(A, S, it,
    conv_A, conv_S, loss, step_A, step_S, v, stride, next_refresh)`` in
    the JAX runner's layout (at ``stride=1`` the carried steps and stride
    come back unchanged)."""
    from torch._higher_order_ops.while_loop import while_loop

    W32 = W.to(torch.float32)
    segmented = adapt or stride > 1
    safety = _SAFETY if segmented else 1.0
    budget = (1.0 - safety) / 2
    sA_in, sS_in, v_in, stride_in, seg_in = steps0
    host = torch.device("cpu")
    if resume:
        it_h, seg_h = (t.to(host, torch.int64) for t in (it0, seg_in))
    else:
        it_h = torch.zeros((), dtype=torch.int64, device=host)
        seg_h = torch.zeros((), dtype=torch.int64, device=host)
    cold = _COLD_ITERS - _WARM_ITERS

    def refresh(k, sA_o, sS_o, v, stride_c, seg, seg_h, A, S, it, it_h):
        sA, sS, v = _weighted_steps(A, S, W32, v, _WARM_ITERS,
                                    extra=(it_h == 0).to(torch.int64) * cold)
        if safety != 1.0:
            sA, sS = safety * sA, safety * sS
        if adapt:
            stride_c = grow_stride(stride_c, (sA_o, sS_o), (sA, sS), budget,
                                   _MAX_STRIDE, first=(it == 0))
            # the host rule reads its drift here too
            seg_h = it_h + stride_c.to(host, torch.int64)
        else:
            stride_c = stride_c.clone()
            seg_h = it_h + stride
        return k + 1, sA, sS, v, stride_c, it + stride_c, seg_h

    end = it0 + max_iter

    def body(A, S, it, conv_A, conv_S, loss, sA, sS, v, stride_c, seg, it_h,
             seg_h, go):
        due = (it_h >= seg_h).to(torch.int64)
        _, sA, sS, v, stride_c, seg, seg_h = while_loop(
            lambda k, *r: k < due,
            lambda k, *r: refresh(k, *r, A, S, it, it_h),
            (torch.zeros_like(due), sA, sS, v, stride_c, seg, seg_h))
        A, S, _, conv_A, conv_S, loss = _pgm_iterate(
            A, S, Y, W, sA, sS, prox_A, prox_S, e_rel, tile_n)
        return (A, S, it + 1, conv_A, conv_S, loss, sA, sS, v, stride_c, seg,
                it_h + 1, seg_h, _fused_go(conv_A, conv_S, loss))

    out = while_loop(lambda *c: torch.logical_and(c[-1], c[2] < end), body,
                     (A, S, it0, conv_A0, conv_S0, loss0, sA_in, sS_in, v_in,
                      stride_in, seg_in, it_h, seg_h,
                      _fused_go0(conv_A0, conv_S0, div0)))
    A, S, it, conv_A, conv_S, loss, sA, sS, v, stride_c, seg = out[:11]
    if not segmented:
        return (A, S, it, conv_A, conv_S, loss, sA_in, sS_in, v, stride_in,
                it)
    return A, S, it, conv_A, conv_S, loss, sA, sS, v, stride_c, seg


def _store_dtype(store_dtype):
    """``store_dtype`` as None (full width, the default layout) or
    ``torch.bfloat16``."""
    sdt = as_torch_dtype(store_dtype)
    if sdt is not None and sdt.itemsize >= 4:
        return None
    if sdt not in (None, torch.bfloat16):
        raise ValueError(f"store_dtype must be bfloat16 or a full-width "
                         f"dtype, got {store_dtype!r}")
    return sdt


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
    store_dtype=None,
    step_stride=None,
    step_adapt=False,
    state=None,
    device=None,
):
    """PGM-NMF with one fused K1 step per iteration.

    The same iteration as ``nmf(engine="torch")``, with the S-side work
    (residual, both gradients, the proxed S update, the next ``S S^T``
    Gram and the convergence norms) done in one pass over the pixels by
    :func:`~proxmin_tpu_torch.ops.nmf_kernels.fused_nmf_pgm_step`.
    Computes in float32.

    Unweighted, the Lipschitz recursion is exact (not lagged): K1's Gram of
    the S it just wrote is the next step's input. ``W`` (C x N, or a scalar
    or anything that broadcasts) weights the residual in the same pass; the
    weighted bounds (a batched power iteration, outside the kernel) refresh
    every ``step_stride`` iterations (default 1: every iteration, exact
    steps), with a warm-started power iterate and the 0.9 safety factor
    when strided. ``step_stride > 1`` or ``step_adapt=True`` on an
    unweighted problem refresh the steps once per segment from K1's Gram
    (no eigensolve between refreshes), shrunk by 0.9; ``step_adapt`` grows
    or halves the interval (:func:`~proxmin_tpu_torch.utils.grow_stride`,
    capped at 100). Unweighted ``step_stride=1`` without ``step_adapt`` is
    the exact engine.

    ``store_dtype=torch.bfloat16`` (or ``"bfloat16"``) stores S, Y and W in
    bfloat16 (compute stays float32; the residual multiplies A rounded to
    bfloat16). The fixed-point residual then floors at bfloat16
    quantization, so keep ``e_rel`` loose. A full-width ``store_dtype`` is
    the default layout.

    ``prox_S`` may be any prox (None: identity). On CUDA tensors a library
    operator that acts on a pixel column alone (and an
    ``AlternatingProjections`` of such) runs compiled in the kernel; any
    other prox runs in PyTorch on the whole (K, N) iterate between two
    kernel passes (:func:`~proxmin_tpu_torch.ops.nmf_kernels.describe_prox`).
    The kernels take any C and K. ``prox_A`` acts on the tiny
    C x K factor outside the kernel and may be any prox. On CPU tensors the
    kernel's plain version runs instead. NumPy inputs go to ``device``
    (default: the CUDA device).

    ``state=`` continues a previous call's ``.state`` (with its final
    iterates) on the uninterrupted trajectory, bit for bit, and a solve
    that stopped stays stopped; ``max_iter`` counts the further
    iterations. The weighting, ``step_stride``/``step_adapt``,
    ``store_dtype`` and ``tile_n`` (which fixes the kernel's summation
    order) must match the state's. Its ``"steps"`` are K1's Gram (exact),
    ``(step_A, step_S, Gram, stride, next_refresh)`` (unweighted strided)
    or ``(step_A, step_S, v, stride, next_refresh)`` (weighted).

    Returns a ``SolverResult`` unpacking as the ``(conv_A, conv_S)`` flags,
    with ``.x == (A, S)``, ``.iterations``, ``.converged``, ``.loss``,
    ``.status`` and ``.state``.
    """
    A_in, S_in = A, S
    if prox_A is None:
        prox_A = operators.prox_id
    if prox_S is None:
        prox_S = operators.prox_id
    prox_S = describe_prox(prox_S)
    sdt = _store_dtype(store_dtype)
    dev = _device_for(device, Y, A, S)
    A = promote_dtype(A, device=dev)
    S, Y = (promote_dtype(a, keep=sdt, device=dev) for a in (S, Y))
    dtype = A.dtype
    weighted = not _is_unweighted(W)
    strided_u = ((step_stride is not None and int(step_stride) > 1)
                 or bool(step_adapt))
    stride_cfg = ((0 if step_stride is None else int(step_stride),
                   bool(step_adapt)) if (weighted or strided_u)
                  else (0, False))
    sdt_name = _dtype_name(sdt)
    conv0, div0, loss0, steps0, it0 = (False, False), False, np.inf, None, 0
    if state is not None:
        if not (hasattr(state, "get")
                and state.get("kind") == "nmf_pgm_fused"):
            raise ValueError("state= must be a previous nmf_pgm_fused "
                             ".state dict")
        if bool(state["weighted"]) != weighted:
            raise ValueError("state= was produced under a different "
                             "weighting; the carried steps would be wrong")
        st_cfg = tuple(state.get("stride_config", stride_cfg))
        if (int(st_cfg[0]), bool(st_cfg[1])) != stride_cfg:
            raise ValueError(
                f"state= was produced under step_stride={st_cfg[0] or None},"
                f" step_adapt={bool(st_cfg[1])} but this call uses "
                f"step_stride={step_stride}, step_adapt={step_adapt}; "
                "resume with the same settings")
        if state.get("store_dtype") != sdt_name:
            raise ValueError(
                f"state= was produced under store_dtype="
                f"{state.get('store_dtype')} but this call uses {sdt_name}")
        if int(state.get("tile_n", tile_n)) != int(tile_n):
            raise ValueError(
                f"state= was produced under tile_n={state.get('tile_n')} "
                f"but this call uses {tile_n}: the carried Gram is "
                "tile-accumulated; resume with the same tile_n")
        it0 = int(state["it"])
        conv0 = tuple(bool(c) for c in np.asarray(state["converged"]))
        div0 = bool(np.asarray(state.get("diverged", False)))
        loss0 = float(state.get("loss", np.inf))
        steps0 = state.get("steps")

    exact = not (weighted or strided_u)
    stride = max(int(step_stride or 1), 1)
    safety = _SAFETY if (stride > 1 or step_adapt) else 1.0
    if exact and steps0 is not None:
        steps0 = (0.0, 0.0, steps0, 1, it0)
    store = sdt or torch.float32
    Y = Y.to(store).contiguous()
    W = _promote_W(W, Y).to(store).contiguous() if weighted else None
    A_f, S_f, iterations, conv_A, conv_S, loss, steps_f = _run_fused_pgm(
        A.to(torch.float32).contiguous(), S.to(store).contiguous(), Y, W,
        max_iter, prox_A, prox_S, float(e_rel), int(tile_n), stride=stride,
        adapt=bool(step_adapt), safety=safety, it0=it0, conv0=conv0,
        div0=div0, loss0=loss0, steps0=steps0)
    A_out, S_out = A_f.to(dtype), S_f.to(dtype)
    converged = (conv_A, conv_S)
    diverged = div0 or (iterations > 0 and not np.isfinite(loss))
    logger.info("Completed %d iterations", iterations)
    status = status_from(all(converged), diverged, logger)
    writeback((A_in, S_in), (A_out, S_out))
    resume_state = {
        "kind": "nmf_pgm_fused", "weighted": weighted,
        "stride_config": stride_cfg, "store_dtype": sdt_name,
        "tile_n": int(tile_n), "it": it0 + iterations,
        "converged": np.asarray(converged, bool), "diverged": diverged,
        "loss": loss, "steps": steps_f[2] if exact else steps_f,
    }
    return SolverResult(
        converged,
        x=(A_out, S_out), iterations=iterations, converged=converged,
        loss=loss, status=status, state=resume_state,
    )


def _bias_corrections(b1, b2, t):
    """The Adam scalars ``(b1_t, 1/(1 - b1_t^t), 1/(1 - b2^t))`` at the
    global step ``t`` (a Python int) as float32 host numbers: the powers in
    float64 of the float32 decays, rounded to float32, then ``1 - p`` and
    the reciprocal in float32. :func:`_bias_corrections_tensor` computes
    the same numbers on the device."""
    one = np.float32(1)
    b1_t, b2_t = np.float32(b1), np.float32(b2)
    p1 = np.float32(np.float64(b1_t) ** t)
    p2 = np.float32(np.float64(b2_t) ** t)
    return b1_t, one / (one - p1), one / (one - p2)


def _bias_decays(b1, b2, device):
    """The constants of :func:`_bias_corrections_tensor`: the float32
    decays as float64 ``(2,)``, 1 and ``b1_t`` as float32, on ``device``."""
    f32, f64 = torch.float32, torch.float64
    decays = torch.tensor([float(np.float32(b)) for b in (b1, b2)],
                          dtype=f64).to(device)
    return (decays, torch.ones((), dtype=f32, device=device),
            decays[:1].to(f32))


def _bias_corrections_tensor(decays, t):
    """:func:`_bias_corrections` on the device from a 0-d integer tensor
    ``t`` and :func:`_bias_decays`' constants: a (3,) float32 tensor
    ``[b1_t, bc1, bc2]``, K2's device-scalar entry's input, with the host
    form's arithmetic (float64 powers rounded to float32, a float32
    subtraction and division)."""
    decays, one, b1_t = decays
    p = torch.pow(decays, t.to(torch.float64)).to(torch.float32)
    return torch.cat([b1_t, torch.div(one, one - p)])


def _adaprox_iterate(A, S, MS, VS, MA, VA, rowsum, Y, W, scalars, bc1, bc2,
                     prox_A, prox_S, e_rel, b1, b2, eps, tile_n, tiny):
    """One fused proximal-Adam iteration: the ``step_adaprox`` steps, K2 and
    the A block's Adam update and prox, ``(A', S', MS', VS', MA', VA',
    rowsum', conv_A, conv_S, loss)``. ``scalars`` reach K2 (three host
    numbers, or the (3,) device tensor of :func:`_bias_corrections_tensor`)
    and ``bc1``, ``bc2`` the A block (host numbers, or 0-d tensors of the
    same float32 values). The loop body that the host loop
    (:func:`_run_fused_adaprox`) and the exported program
    (:func:`_fused_adaprox_program`) share."""
    C = A.shape[0]
    N = S.shape[1]
    one, b1_t = np.float32(1), np.float32(b1)
    alpha_A = torch.sum(A, dim=0) / C / 10.0
    alpha_S = rowsum / N / 10.0
    gA, S1, MS1, VS1, rowsum1, loss, dS_sq, nS_sq = fused_nmf_adaprox_step(
        A, S, MS, VS, Y, alpha_S, scalars, W=W, prox_S=prox_S, b2=b2,
        eps=eps, tile_n=tile_n)
    # the A block (C x K, tensor ops): the same Adam update and closed-form
    # prox, with the TPU runner's float32 scalars
    MA1 = float(one - b1_t) * gA + float(b1_t) * MA
    VA1 = (1.0 - b2) * gA ** 2 + b2 * VA
    PsiA = torch.sqrt(VA1 * bc2) + eps
    PsiA_safe = torch.maximum(PsiA, tiny)
    A1 = A - alpha_A[None, :] * (MA1 * bc1) / PsiA_safe
    A1 = prox_A(A1, alpha_A[None, :] / PsiA_safe)
    dA_sq = torch.sum((A1 - A) ** 2)
    nA_sq = torch.sum(A1 ** 2)
    conv_A = _fused_fp_conv(dA_sq, nA_sq, e_rel)
    conv_S = _fused_fp_conv(dS_sq, nS_sq, e_rel)
    loss = _poison_loss(loss, dA_sq, nA_sq, dS_sq, nS_sq)
    return A1, S1, MS1, VS1, MA1, VA1, rowsum1, conv_A, conv_S, loss


def _run_fused_adaprox(A, S, Y, W, MA, VA, MS, VS, max_iter, prox_A, prox_S,
                       e_rel, b1, b2, eps, tile_n, it0=0, conv_A0=False,
                       conv_S0=False, div0=False, loss0=np.inf,
                       rowsum0=None):
    """The fused proximal-Adam loop on float32 tensors. Counterpart of the
    ``run`` built by ``proxmin_tpu.nmf._make_fused_adaprox_runner``.

    Per iteration (:func:`_adaprox_iterate`): the scalars ``(b1_t,
    1/(1-b1^t), 1/(1-b2^t))`` in float32 on the host from the host counter
    (:func:`_bias_corrections`; they reach K2 by value, no sync); the
    ``step_adaprox`` steps on the device, ``alpha_A`` from A's column sums
    and ``alpha_S`` from the row sums K2 accumulated for the current S; one
    K2 launch; the A block's Adam update and prox as tensor ops; one host
    read of the stop flags. ``rowsum0`` carries the kernel's own row sums
    across a resume (a fresh ``S.sum(1)`` has another summation order, and
    its last-bit differences would compound). Returns ``(A, S, it, conv_A,
    conv_S, loss, MA, VA, MS, VS, rowsum)``.
    """
    dev = A.device
    K = A.shape[1]
    f32 = torch.float32
    rowsum = (torch.sum(S.to(f32), dim=1, keepdim=True) if rowsum0 is None
              else as_tensor(rowsum0, f32, dev).reshape(K, 1))
    conv_A = torch.tensor(bool(conv_A0), device=dev)
    conv_S = torch.tensor(bool(conv_S0), device=dev)
    loss = torch.tensor(float(loss0), dtype=f32, device=dev)
    # filled on the device: copying a host number there every iteration
    # would make the host wait for the stream
    tiny = torch.full((), torch.finfo(f32).tiny, dtype=f32, device=dev)
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
        scalars = _bias_corrections(b1, b2, it + it0 + 1)
        (A, S, MS, VS, MA, VA, rowsum, conv_A, conv_S,
         loss) = _adaprox_iterate(
            A, S, MS, VS, MA, VA, rowsum, Y, W, scalars, float(scalars[1]),
            float(scalars[2]), prox_A, prox_S, e_rel, b1, b2, eps, tile_n,
            tiny)
        it += 1
    return (A, S, it, bool(conv_A), bool(conv_S), float(loss), MA, VA, MS,
            VS, rowsum)


def _fused_adaprox_program(A, S, Y, W, MA, VA, MS, VS, rowsum0, max_iter,
                           it0, conv_A0, conv_S0, div0, loss0, prox_A,
                           prox_S, e_rel, b1, b2, eps, tile_n):
    """The fused proximal-Adam solve as one ``while_loop`` that
    ``torch.export`` captures: the counterpart of the ``run`` of
    ``proxmin_tpu.nmf._make_fused_adaprox_runner``, on
    :func:`_adaprox_iterate` as :func:`_run_fused_adaprox` runs it, with
    the bias corrections computed on the device from the counter
    (:func:`_bias_corrections_tensor`) and read by K2 from there. Every
    input is a tensor (``rowsum0`` (K, 1), ``it0`` the global clock's
    offset); returns ``(A, S, it, conv_A, conv_S, loss, MA, VA, MS, VS,
    rowsum)`` with ``it`` counted from 0."""
    from torch._higher_order_ops.while_loop import while_loop

    f32 = torch.float32
    tiny = torch.full((), torch.finfo(f32).tiny, dtype=f32, device=A.device)
    decays = _bias_decays(b1, b2, A.device)

    def cond(A, S, MS, VS, MA, VA, rowsum, it, conv_A, conv_S, loss, go):
        return torch.logical_and(go, it < max_iter)

    def body(A, S, MS, VS, MA, VA, rowsum, it, conv_A, conv_S, loss, go):
        scalars = _bias_corrections_tensor(decays, it + it0 + 1)
        out = _adaprox_iterate(A, S, MS, VS, MA, VA, rowsum, Y, W, scalars,
                               scalars[1], scalars[2], prox_A, prox_S, e_rel,
                               b1, b2, eps, tile_n, tiny)
        return (*out[:7], it + 1, *out[7:], _fused_go(*out[7:]))

    it = torch.zeros((), dtype=torch.int32, device=A.device)
    out = while_loop(cond, body, (A, S, MS, VS, MA, VA, rowsum0, it,
                                  conv_A0, conv_S0, loss0,
                                  _fused_go0(conv_A0, conv_S0, div0)))
    (A, S, MS, VS, MA, VA, rowsum, it, conv_A, conv_S, loss) = out[:11]
    return A, S, it, conv_A, conv_S, loss, MA, VA, MS, VS, rowsum


def _dtype_name(dt):
    return None if dt is None else str(dt).removeprefix("torch.")


def nmf_adaprox_fused(
    Y,
    A,
    S,
    W=None,
    prox_A=operators.prox_plus,
    prox_S=operators.prox_plus,
    e_rel=1e-3,
    max_iter=1000,
    b1=0.9,
    b2=0.999,
    eps=1e-8,
    tile_n=DEFAULT_TILE_N,
    moment_dtype=None,
    store_dtype=None,
    M=None,
    V=None,
    state=None,
    device=None,
):
    """AdaProx-NMF (``scheme='adam'``) with one fused K2 step per
    iteration.

    The same iteration as ``nmf(algorithm='adaprox', engine='torch',
    separable_prox='auto')`` with the default ``step_adaprox`` steps and a
    constant ``b1``, with the S-side work (residual, both gradients, both
    moment EMAs, the bias-corrected step, the closed-form separable prox,
    the next iteration's row sums and the convergence norms) done in one
    pass over the pixels by
    :func:`~proxmin_tpu_torch.ops.nmf_kernels.fused_nmf_adaprox_step`.
    Computes in float32. ``W`` (C x N, or a scalar or anything that
    broadcasts) weights the residual in the same pass.

    ``prox_S`` may be any separable prox (None: identity), applied with
    the per-element step ``alpha / Psi``. On CUDA tensors a library
    operator whose ``separable_when`` holds (or a
    :class:`~proxmin_tpu_torch.ops.nmf_kernels.ProxDescriptor` that says
    so) runs compiled in the kernel; any other prox runs in PyTorch on the
    whole (K, N) arrays between two kernel passes. The kernels take any C
    and K. ``prox_A`` acts on the tiny C x K factor outside
    the kernel and may be any separable prox. On CPU tensors the kernel's
    plain version runs instead.

    ``moment_dtype`` (``torch.bfloat16`` or ``"bfloat16"``) stores the S
    moments in bfloat16, cast inside the kernel; the A moments stay
    float32. ``store_dtype`` (``torch.bfloat16`` or ``"bfloat16"``)
    additionally stores S, Y and W in bfloat16 (with bfloat16 moments, 94
    instead of 132 MB per iteration at C=5, K=7, N=1e6): the residual
    multiplies A rounded to bfloat16, S' is stored rounded, and the row
    sums and the convergence norms are those of the stored S'. The
    fixed-point residual then floors at bfloat16 quantization, so keep
    ``e_rel`` loose; the returned A and S are float32. A full-width
    ``store_dtype`` is the default layout. NumPy inputs go to ``device``
    (default: the CUDA device).

    ``M=``/``V=`` warm-start the moments from a previous solve's ``.M`` /
    ``.V`` (per-block ``(A, S)`` tuples; the bias-correction clock
    restarts). ``state=`` continues a previous ``.state`` exactly: the
    moments, the global clock, the stop flags and the kernel's row sums.
    It accepts this engine's states and the torch engine's adaprox states
    of a default-step adam solve (the two are interchangeable); the
    returned ``.state`` also resumes on ``engine='torch'``. ``tile_n``,
    ``store_dtype`` and ``moment_dtype`` must match the state's.

    Returns a ``SolverResult`` unpacking as the ``(conv_A, conv_S)``
    flags, with ``.x == (A, S)``, ``.iterations``, ``.converged``,
    ``.loss``, ``.M``, ``.V``, ``.status`` and ``.state``.
    """
    A_in, S_in = A, S
    if prox_A is None:
        prox_A = operators.prox_id
    if prox_S is None:
        prox_S = operators.prox_id
    prox_S = describe_prox(prox_S, "adaprox")
    sdt = _store_dtype(store_dtype)
    dev = _device_for(device, Y, A, S)
    A = promote_dtype(A, device=dev)
    S, Y = (promote_dtype(a, keep=sdt, device=dev) for a in (S, Y))
    dtype = A.dtype
    C, K = A.shape
    N = S.shape[1]
    f32 = torch.float32
    store = sdt or f32
    Y = Y.to(store).contiguous()
    W = None if _is_unweighted(W) else _promote_W(W, Y).to(store).contiguous()
    mdt = as_torch_dtype(moment_dtype)
    if mdt is not None and mdt.itemsize >= 4:
        mdt = None
    fused_cfg = {"tile_n": int(tile_n), "store_dtype": _dtype_name(sdt),
                 "moment_dtype": _dtype_name(mdt)}
    it0, conv0, div0, loss0, rowsum0 = 0, (False, False), False, np.inf, None
    if state is not None:
        if M is not None or V is not None:
            raise ValueError("state= (exact resume) and M=/V= (moment warm "
                             "start) are mutually exclusive")
        if state.get("kind") is not None:
            raise ValueError(
                f"state= is a {state['kind']!r} resume state, not an adaprox "
                "one: adaprox states carry M/V moments (fused and torch "
                "engines interchangeably); resume this state with the "
                "solver/engine that produced it")
        if ("fused_config" in state
                and dict(state["fused_config"]) != fused_cfg):
            raise ValueError(
                f"state= was produced under the fused configuration "
                f"{state['fused_config']} but this call uses {fused_cfg}: "
                "the carried row sums and moments are tile/dtype-"
                "accumulated; resume with the same tile_n/store_dtype/"
                "moment_dtype")
        if len(tuple(state.get("stepper_state", ()))) != 0:
            raise ValueError(
                "state= carries stepper state (a strided/stateful-step "
                "solve); the fused adaprox engine computes exact steps "
                "every iteration: resume with engine='torch'")
        conv0 = tuple(bool(c) for c in
                      np.asarray(as_tensor(state.get("converged", conv0),
                                           torch.bool, "cpu")))
        div0 = bool(as_tensor(state.get("diverged", False), torch.bool,
                              "cpu"))
        loss0 = float(state.get("loss", np.inf))
        rowsum0 = state.get("rowsum")
        M, V = state["M"], state["V"]
        it0 = int(state["it"])
    if (M is None) != (V is None):
        raise ValueError("a warm start needs both M and V (a previous "
                         "solve's .M/.V)")
    if M is not None:
        (MA, MS), (VA, VS) = M, V
        MA, VA = (as_tensor(m, f32, dev).clone() for m in (MA, VA))
        MS, VS = (as_tensor(m, mdt or f32, dev).contiguous().clone()
                  for m in (MS, VS))
        if (MA.shape != (C, K) or VA.shape != (C, K) or MS.shape != (K, N)
                or VS.shape != (K, N)):
            raise ValueError("warm-start moments must be (C, K) for A and "
                             "(K, N) for S")
    else:
        MA = torch.zeros((C, K), dtype=f32, device=dev)
        VA = torch.zeros_like(MA)
        MS = torch.zeros((K, N), dtype=mdt or f32, device=dev)
        VS = torch.zeros_like(MS)

    (A_f, S_f, iterations, conv_A, conv_S, loss, MA_f, VA_f, MS_f, VS_f,
     rowsum_f) = _run_fused_adaprox(
        A.to(f32).contiguous(), S.to(store).contiguous(), Y, W, MA, VA, MS,
        VS, max_iter, prox_A, prox_S, float(e_rel), float(b1), float(b2),
        float(eps), int(tile_n), it0=it0, conv_A0=conv0[0],
        conv_S0=conv0[1], div0=div0, loss0=loss0, rowsum0=rowsum0)
    A_out, S_out = A_f.to(dtype), S_f.to(dtype)
    converged = (conv_A, conv_S)
    diverged = div0 or (iterations > 0 and not np.isfinite(loss))
    logger.info("Completed %d iterations", iterations)
    status = status_from(all(converged), diverged, logger)
    writeback((A_in, S_in), (A_out, S_out))
    # interchangeable with the torch engine's adaprox state: adam carries
    # no Vhat (zeros there) and the default steps are stateless
    resume_state = {
        "M": (MA_f, MS_f), "V": (VA_f, VS_f),
        "Vhat": (torch.zeros_like(MA_f), torch.zeros_like(MS_f)),
        "stepper_state": (), "it": it0 + iterations,
        "converged": np.asarray(converged, bool), "diverged": diverged,
        "rowsum": rowsum_f, "loss": loss, "fused_config": fused_cfg,
    }
    return SolverResult(
        converged,
        x=(A_out, S_out), iterations=iterations, converged=converged,
        loss=loss, M=(MA_f, MS_f), V=(VA_f, VS_f), status=status,
        state=resume_state,
    )


_ALGORITHMS = ("pgm", "adaprox", "bsdmm")


def _resolve_algorithm(algorithm):
    """``None``, ``"pgm"``, ``"adaprox"``, ``"bsdmm"`` or the port's solver
    functions of those names; anything else raises ``ValueError``."""
    if algorithm is None:
        return algorithms.pgm
    if any(algorithm is getattr(algorithms, n) for n in _ALGORITHMS):
        return algorithm
    name = algorithm.lower() if isinstance(algorithm, str) else None
    if name in _ALGORITHMS:
        return getattr(algorithms, name)
    raise ValueError(f"unknown algorithm {algorithm!r}; nmf supports 'pgm', "
                     "'adaprox' and 'bsdmm'")


def _block_gradient(Xs, j, Y, W):
    """Block j of :func:`grad_likelihood`, the same numbers without the
    other block's product (a host loop would run it for nothing: under
    ``jit`` the JAX package's compiler drops the unused half)."""
    A, S = Xs
    D = A @ S - Y
    if not _is_unweighted(W):
        D = W * D
    return reduced(D @ S.T if j == 0 else A.T @ D)


def _bsdmm_prox_f(Xj, step_j, Xs=None, j=None, *, Y, W, prox):
    """Block prox_f of the bsdmm route: a gradient step, then the block's
    constraint prox."""
    return prox[j](Xj - step_j * _block_gradient(Xs, j, Y, W), step_j)


def _bsdmm_step_default(Xs, j=None, *, W):
    """Block j of :func:`step_pgm`, without the other block's eigensolve
    or power iteration."""
    A, S = Xs
    if _is_unweighted(W):
        return step_A(A, S) if j == 0 else step_S(A, S)
    if j == 0:
        return 1.0 / _weighted_lipschitz_A(S, W)
    return 1.0 / _weighted_lipschitz_S(A, W)


def _bsdmm_step_custom(Xs, j=None, *, step):
    return step(*Xs)[j]


def _nmf_bsdmm(Y, A, S, W, prox, step, max_iter, e_rel, callback,
               step_stride, step_adapt, algorithm_args):
    """``nmf(algorithm='bsdmm')`` on promoted tensors: the two factors as
    bsdmm's blocks, each block's gradient step as its ``prox_f``."""
    weighted_default = step is None and not _is_unweighted(W)
    if step_adapt and not weighted_default:
        raise ValueError(
            "step_adapt for algorithm='bsdmm' is supported on the "
            "weighted default-step path (the expensive per-block "
            "Lipschitz bounds); use a fixed step_stride for custom "
            "steps or unweighted problems")
    prox = tuple(p if p is not None else operators.prox_id for p in prox)
    prox_f = partial(_bsdmm_prox_f, Y=Y, W=W, prox=prox)
    if step is None:
        step_f = partial(_bsdmm_step_default, W=W)
    else:
        step_f = partial(_bsdmm_step_custom, step=step)
    strided = (step_stride is not None and step_stride > 1) or step_adapt
    stride0 = int(step_stride) if step_stride is not None else 1
    if strided:
        if weighted_default:
            # warm-started per-block weighted bounds, each block's refresh
            # computing only its own
            step_f = WeightedBSDMMStepper(W, stride=stride0,
                                          adapt=step_adapt)
        else:
            algorithm_args = dict(algorithm_args, steps_f_stride=stride0)
    return algorithms.bsdmm([A, S], prox_f, step_f, max_iter=max_iter,
                            e_rel=e_rel, callback=callback,
                            **algorithm_args)


def _nmf_adaprox_cuda(Y, A, S, W, prox_A, prox_S, e_rel, max_iter, step,
                      callback, step_stride, step_adapt, device,
                      algorithm_args):
    """``nmf(algorithm='adaprox', engine='cuda')``: the gates of the JAX
    ``engine='pallas'`` adaprox route, then :func:`nmf_adaprox_fused`."""
    if step is not None or callback is not None:
        raise ValueError("engine='cuda' supports algorithm='pgm' or "
                         "algorithm='adaprox' with default steps and no "
                         "callback; use engine='torch'")
    if step_stride is not None or step_adapt:
        raise ValueError("step_stride/step_adapt do not apply to the fused "
                         "adaprox engine (its mean/10 steps are exact and "
                         "cheap every iteration)")
    aargs = dict(algorithm_args)
    scheme = aargs.pop("scheme", "adam")
    if scheme != "adam":
        raise ValueError(f"engine='cuda' adaprox supports scheme='adam' "
                         f"only (got {scheme!r}); use engine='torch'")
    sep = aargs.pop("separable_prox", "auto")
    if sep is False:
        raise ValueError(
            "separable_prox=False requests the prox sub-iteration loop, "
            "which the fused adaprox engine replaces with the closed form; "
            "use engine='torch' for sub-iteration semantics")
    if not _adaprox_separable_ok(prox_A, prox_S, sep):
        raise ValueError("the fused adaprox engine needs separable proxs "
                         "and separable_prox True or 'auto' (the in-kernel "
                         "scaled prox is the closed form); use "
                         "engine='torch' for sub-iteration proxs")
    fused_kw = {k: aargs.pop(k) for k in
                ("b1", "b2", "eps", "tile_n", "moment_dtype", "store_dtype",
                 "M", "V", "state") if k in aargs}
    if aargs:
        raise ValueError(f"unsupported fused-adaprox options: "
                         f"{sorted(aargs)}")
    if prox_S is not None:
        # separable_prox=True compiles any library chain, as in JAX
        prox_S = describe_prox(prox_S, "adaprox", sep)
    return nmf_adaprox_fused(Y, A, S, W=W, prox_A=prox_A, prox_S=prox_S,
                             e_rel=e_rel, max_iter=max_iter, device=device,
                             **fused_kw)


def _nmf_mesh(Y, A, S, W, prox_A, prox_S, algorithm, step, max_iter, e_rel,
              callback, engine, step_stride, step_adapt, mesh, model_axis,
              kind, algorithm_args):
    """``nmf(mesh=)``: the two explicit-collective routes of the JAX
    package, :func:`~proxmin_tpu_torch.parallel.nmf_pgm_sharded` and
    :func:`~proxmin_tpu_torch.parallel.nmf_adaprox_sharded`, with their
    refusals; every other call takes the auto-SPMD route, as in JAX: the
    problem is sharded with
    :func:`~proxmin_tpu_torch.parallel.shard_nmf_problem` and the ordinary
    driver runs on the ``DTensor`` shards (``engine='torch'``), DTensor
    inserting the collectives. NumPy inputs take the whole result back."""
    from .parallel import nmf_adaprox_sharded, nmf_pgm_sharded
    from .parallel.sharding import _classify_weight, shard_nmf_problem

    if engine == "cuda":
        # the fused kernels are single-device programs: under a mesh they
        # would need the whole pixel axis on one card
        raise ValueError(
            "engine='cuda' does not compose with mesh= (the fused "
            "kernels are single-device); use engine='torch' (pgm and "
            "adaprox get the explicit-collective sharded solves)")
    if engine not in ("torch", "auto"):
        raise ValueError(f"unknown engine {engine!r}; the port has 'torch' "
                         "and 'cuda'")
    W = None if _is_unweighted(W) else W
    st = algorithm_args.get("state")
    if (algorithm is algorithms.pgm and step is None and callback is None
            and (not algorithm_args or (set(algorithm_args) == {"state"}
                                        and kind == "nmf_pgm_sharded"))):
        return nmf_pgm_sharded(
            Y, A, S, W=W, mesh=mesh,
            prox_A=prox_A if prox_A is not None else operators.prox_id,
            prox_S=prox_S if prox_S is not None else operators.prox_id,
            e_rel=e_rel, max_iter=max_iter, model_axis=model_axis,
            step_stride=step_stride, step_adapt=step_adapt, state=st)
    if (algorithm is algorithms.adaprox and step is None
            and callback is None and step_stride is None and not step_adapt
            and algorithm_args.get("scheme", "adam") == "adam"
            and algorithm_args.get("separable_prox", "auto") is not False
            and set(algorithm_args) <= {"b1", "b2", "eps", "scheme",
                                        "separable_prox", "state"}
            and (st is None or kind == "nmf_adaprox_sharded")
            and _adaprox_separable_ok(
                prox_A, prox_S, algorithm_args.get("separable_prox",
                                                   "auto"))):
        return nmf_adaprox_sharded(
            Y, A, S, W=W, mesh=mesh, prox_A=prox_A, prox_S=prox_S,
            e_rel=e_rel, max_iter=max_iter, model_axis=model_axis,
            b1=algorithm_args.get("b1", 0.9),
            b2=algorithm_args.get("b2", 0.999),
            eps=algorithm_args.get("eps", 1e-8), state=st)
    if kind == "nmf_adaprox_sharded":
        raise ValueError(
            "state= is an nmf_adaprox_sharded resume state but this call "
            "does not route to the explicit sharded adaprox solve "
            "(algorithm='adaprox', scheme='adam', separable proxs, default "
            "steps, no callback required)")
    if kind == "nmf_pgm_sharded":
        raise ValueError(
            "state= is an nmf_pgm_sharded resume state but this call does "
            "not route to the explicit sharded solve (algorithm='pgm' with "
            "default steps, no callback, and no extra algorithm kwargs "
            "required)")
    # a lower-rank W broadcasts to Y's shape first, so that every rank
    # takes its slice of the broadcast view
    weighted, W2 = _classify_weight(W, np.shape(Y))
    Yd, Ad, Sd, Wd = shard_nmf_problem(
        mesh, Y, A, S, W2 if weighted else None, model_axis=model_axis)
    res = nmf(Yd, Ad, Sd, W=Wd if weighted else 1, prox_A=prox_A,
              prox_S=prox_S, algorithm=algorithm, step=step,
              max_iter=max_iter, e_rel=e_rel, callback=callback,
              engine="torch", step_stride=step_stride,
              step_adapt=step_adapt, **algorithm_args)
    writeback((A, S), res.x)
    return res


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
    model_axis=None,
    device=None,
    **algorithm_args,
):
    """Non-negative / constrained matrix factorization by PGM, AdaProx or
    bSDMM.

    Solves ``minimize 0.5 ||sqrt(W) (Y - A S)||^2`` under proximal
    constraints on A and S.

    Args:
        Y: target (C, N). A: initial (C, K). S: initial (K, N). NumPy
            inputs are updated in place; tensors stay on their device.
        W: weights (C, N), a scalar or anything that broadcasts to Y.
        prox_A, prox_S: per-factor constraints (None = identity).
        algorithm: None or ``"pgm"`` (default), ``"adaprox"`` or
            ``"bsdmm"`` (torch engine only; ``step_adapt`` then needs a
            weighted problem with the default steps).
        step: optional step callable ``step(*X, it=...)`` (torch engine).
        max_iter, e_rel: forwarded to the solver.
        callback: ``callback(A, S, it=it)`` before every iteration, with
            the factors as tensors; ``StopIteration`` ends the solve
            (torch engine; e.g. :class:`~proxmin_tpu_torch.utils.Traceback`).
        engine: ``"torch"`` (the generic driver on tensor ops),
            ``"cuda"`` (a fused kernel per iteration: :func:`nmf_pgm_fused`
            on K1, or :func:`nmf_adaprox_fused` on K2 for the adam scheme
            with separable proxs; on CPU tensors their plain versions) or
            ``"auto"``: the cuda engine where the H100 table measured it
            faster (``_unweighted_fused_wins``,
            ``_unweighted_strided_fused_wins``, ``_weighted_fused_wins``,
            ``_adaprox_fused_wins``) and the call is one it runs (PGM with
            the default steps, no callback, library proxes it applies per
            pixel, weighted only with a stride or a store; AdaProx with the
            adam scheme and separable proxes), or where
            ``tile_n``, a bfloat16 ``store_dtype`` or ``moment_dtype``
            asks for it; the torch engine otherwise. It routes by shape,
            not dtype: the cuda engine computes in float32. Inside a gray
            zone of the table the first solve of a shape probes both
            engines (:mod:`~proxmin_tpu_torch.calibrate`). The same table
            holds on the CPU, where the cuda engine runs the plain
            versions.
        step_stride: refresh the steps every this many iterations (the
            0.9 safety factor; weighted PGM warm-starts its power
            iteration between refreshes). ``step_adapt``: grow or halve the
            interval from the measured step drift, starting at
            ``step_stride`` (default 1). Not for the fused adaprox engine.
        mesh: a :func:`~proxmin_tpu_torch.parallel.make_mesh` mesh: PGM
            with the default steps (weighted, ``step_stride``,
            ``step_adapt``) runs as
            :func:`~proxmin_tpu_torch.parallel.nmf_pgm_sharded`, AdaProx
            with the adam scheme and separable proxes as
            :func:`~proxmin_tpu_torch.parallel.nmf_adaprox_sharded`
            (torch engine); ``model_axis`` also shards the channels.
        device: where NumPy inputs go (default: the device of a tensor
            input, else the CUDA device; without one, pass
            ``device="cpu"``); under a mesh, the mesh's device.
        algorithm_args: for pgm ``accelerated``, ``restart``,
            ``backtracking`` with ``f`` (e.g. ``partial(log_likelihood,
            Y=Y)``), ``trace``, ``state`` (torch engine) or ``tile_n``,
            ``store_dtype``, ``state`` (cuda engine); for
            adaprox the driver's options (``scheme``, ``b1``, ``b2``,
            ``eps``, ``separable_prox``, ``moment_dtype``, ``M``, ``V``,
            ``trace``, ``state``, ...) or the fused engine's (``b1``,
            ``b2``, ``eps``, ``tile_n``, ``moment_dtype``, ``store_dtype``,
            ``M``, ``V``, ``state``); for bsdmm the solver's options (``proxs_g``,
            ``steps_g``, ``Ls``, ``update_order``, ``trace``, ``state``).

    A ``state=`` from :func:`nmf_pgm_fused` pins ``engine="cuda"``. An
    adaprox state of either engine resumes on either engine; under
    ``engine="auto"`` on the engine that made it. A sharded solve's state
    resumes only under ``mesh=``.

    Returns:
        The solver's ``SolverResult``; ``result.x == (A, S)``.
    """
    algorithm = _resolve_algorithm(algorithm)
    is_adaprox = algorithm is algorithms.adaprox
    if (np.ndim(Y) != 2 or np.ndim(A) != 2 or np.ndim(S) != 2
            or np.shape(A)[0] != np.shape(Y)[0]
            or np.shape(A)[1] != np.shape(S)[0]
            or np.shape(S)[1] != np.shape(Y)[1]):
        raise ValueError(
            f"factorization shape mismatch: Y {tuple(np.shape(Y))}, "
            f"A {tuple(np.shape(A))}, S {tuple(np.shape(S))}: need Y (C, N), "
            "A (C, K), S (K, N) with Y = A @ S")
    if algorithm_args.get("state", True) is None:
        # state=None means "no resume", as if absent: it must not change
        # the route (e.g. off the explicit sharded path)
        del algorithm_args["state"]
    st = algorithm_args.get("state")
    kind = st.get("kind") if hasattr(st, "get") else None
    if kind in ("nmf_pgm_sharded", "nmf_adaprox_sharded") and mesh is None:
        raise ValueError(
            "state= is a sharded-solve resume state, which resumes the "
            "explicit-collective sharded solve only: pass the mesh= this "
            "solve runs on (single-device continuation is not what this "
            "state encodes)")
    if kind == "nmf_pgm_fused":
        if is_adaprox:
            raise ValueError("state= is an nmf_pgm_fused resume state but "
                             "algorithm='adaprox' was requested: a PGM "
                             "state does not resume another algorithm")
        if mesh is not None:
            raise ValueError(
                "state= is an nmf_pgm_fused resume state (single-device "
                "fused engine); it does not resume under mesh=: continue "
                "on one device with engine='cuda'")
        engine = "cuda"  # a fused PGM state resumes only the fused engine
    if mesh is not None:
        return _nmf_mesh(Y, A, S, W, prox_A, prox_S, algorithm, step,
                         max_iter, e_rel, callback, engine, step_stride,
                         step_adapt, mesh, model_axis, kind, algorithm_args)

    if any(isinstance(a, DTensor) for a in (Y, A, S, W)):
        # sharded inputs (auto-SPMD): the ordinary drivers, as under mesh=
        if engine == "cuda":
            raise ValueError(
                "engine='cuda' does not take DTensor inputs (the fused "
                "kernels are single-device); use engine='torch'")
        engine = "torch" if engine == "auto" else engine
    device = _device_for(device, Y, A, S)
    if engine == "auto":
        engine, algorithm_args = _route_auto(
            Y, A, S, W, prox_A, prox_S, algorithm, step, callback, e_rel,
            step_stride, step_adapt, device, algorithm_args)
    if engine not in ("torch", "cuda"):
        raise ValueError(f"unknown engine {engine!r}; the port has 'torch' "
                         "and 'cuda'")
    if is_adaprox and engine == "cuda":
        return _nmf_adaprox_cuda(Y, A, S, None if _is_unweighted(W) else W,
                                 prox_A, prox_S, e_rel, max_iter, step,
                                 callback, step_stride, step_adapt, device,
                                 algorithm_args)
    if engine == "cuda":
        if (algorithm is not algorithms.pgm or step is not None
                or callback is not None):
            raise ValueError("engine='cuda' supports algorithm='pgm' or "
                             "algorithm='adaprox' with default steps and "
                             "no callback; use engine='torch'")
        extra = set(algorithm_args) - {"tile_n", "store_dtype", "state"}
        if extra:
            raise ValueError(f"unsupported fused-PGM options: "
                             f"{sorted(extra)}")
        return nmf_pgm_fused(Y, A, S, W=None if _is_unweighted(W) else W,
                             prox_A=prox_A, prox_S=prox_S, e_rel=e_rel,
                             max_iter=max_iter, step_stride=step_stride,
                             step_adapt=step_adapt, device=device,
                             **algorithm_args)
    if "store_dtype" in algorithm_args:
        raise ValueError("store_dtype is an engine='cuda' option (the fused "
                         "kernel stores S, Y and W in it)")

    A_in, S_in = A, S
    Y, A, S = (promote_dtype(a, device=device) for a in (Y, A, S))
    weighted = not _is_unweighted(W)
    W = _promote_W(W, Y) if weighted else 1
    # the refresh interval starts at step_stride (default 1) and, with
    # step_adapt, follows the measured drift
    if algorithm is algorithms.bsdmm:
        res = _nmf_bsdmm(Y, A, S, W, (prox_A, prox_S), step, max_iter, e_rel,
                         callback, step_stride, step_adapt, algorithm_args)
        writeback((A_in, S_in), res.x)
        return res
    strided = (step_stride is not None and step_stride > 1) or step_adapt
    stride0 = int(step_stride) if step_stride is not None else 1
    if is_adaprox:
        if step is None:
            step = step_adaprox
        if strided:
            step = StridedStepper(step, 2, stride=stride0, adapt=step_adapt)
    elif strided:
        if step is None and weighted:
            # the power iterate warm-starts from one refresh to the next
            step = WeightedPGMStepper(W, stride=stride0, adapt=step_adapt)
        else:
            step = StridedStepper(
                partial(step_pgm, W=W) if step is None else step, 2,
                stride=stride0, adapt=step_adapt)
    elif step is None:
        step = partial(step_pgm, W=W)
    grad = partial(grad_likelihood, Y=Y, W=W)
    res = algorithm([A, S], grad, step, prox=[prox_A, prox_S],
                    max_iter=max_iter, e_rel=e_rel, callback=callback,
                    **algorithm_args)
    writeback((A_in, S_in), res.x)
    return res
