"""Sharded NMF over ``torch.distributed``: pixel-axis data parallelism (and
optional channel tensor parallelism) with explicit all-reduces.

Counterpart of :mod:`proxmin_tpu.parallel.sharding`'s explicit path. A
``DeviceMesh`` lays the process group's ranks out as a ``('data',)`` or
``('data', 'model')`` grid; :func:`shard_nmf_problem` hands every rank its
pixel slice of Y, S and W (and its channel slice of Y, W and A on
``model``) as ``DTensor`` shards, and the solvers run one process per rank
on those local shards with hand-placed collectives::

    D_l      = W_l * (A S_l - Y_l)                 local
    grad_A   = all_reduce_data(D_l S_l^T)          one (C, K) all-reduce
    grad_S_l = A^T D_l                             local (+ model all-reduce)
    ||S||^2  = lambda_max(all_reduce_data(S_l S_l^T))    K x K
    ||A||^2  = lambda_max(A^T A)                   local (A replicated)

Reductions over one axis at one point of the iteration travel in one
all-reduce (``grad_A`` with the Gram; the convergence norms with the loss),
so an exact unweighted iteration on a 1-D mesh makes two all-reduces of
``C K + K K`` and 3 elements. The JAX package runs its solve as one
``lax.while_loop`` on the devices; here every rank runs its own host loop,
and every branch that loop takes comes from all-reduced values that are the
same bits on every rank (the stop flags, the divergence test, the strided
refresh clock and the adaptive interval), so the ranks leave on the same
iteration and never wait on a collective that another rank skipped. The
loop reads the host once per iteration (the stop flags) and once more per
adaptive refresh (the step drift).
"""

import contextlib
import logging
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import operators
from ..solvers.common import (SolverResult, as_tensor, default_device,
                              promote_dtype, status_from)
from ..utils import grow_stride

logger = logging.getLogger("proxmin")

__all__ = [
    "make_mesh",
    "shard_nmf_problem",
    "make_nmf_pgm_step",
    "nmf_pgm_sharded",
    "nmf_adaprox_sharded",
    "prox_unity_sharded",
]

_STRIDE_SAFETY = 0.9   # strided-refresh shrink; growth budget = (1-s)/2
_COLD_ITERS, _WARM_ITERS = 48, 12   # weighted power passes per refresh


def make_mesh(shape=None, axis_names=None, devices=None, device=None):
    """Build a ``DeviceMesh`` over the process group's ranks.

    Defaults: every rank on a 1-D ``('data',)`` mesh. Pass ``shape=(d,
    m)`` (with ``axis_names=('data', 'model')``, the default for two axes)
    for 2-D DP x TP layouts. ``devices``: the ranks to use (default all, in
    order). The mesh lives on the card unless ``device="cpu"``; without a
    process group (nothing configured,
    :func:`~proxmin_tpu_torch.parallel.initialize_distributed`), this
    process makes a group of its own: one rank, ``nccl`` on the card,
    ``gloo`` on the CPU.
    """
    device = default_device(device)
    if not dist.is_initialized():
        kw = ({"device_id": torch.device("cuda", torch.cuda.current_device())}
              if device.type == "cuda" else {})
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1, **kw)
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    if shape is None:
        shape = (len(ranks),)
    if axis_names is None:
        axis_names = ("data",) if len(shape) == 1 else ("data", "model")
    n = math.prod(shape)
    if n > len(ranks):
        raise ValueError(f"mesh needs {n} ranks, have {len(ranks)}")
    return DeviceMesh(device.type, torch.tensor(ranks[:n]).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def _names(axis):
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _dim(mesh, name):
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"the mesh has no axis {name!r} (its axes: "
                         f"{names})")
    return names.index(name)


def _axis_size(mesh, axis):
    """Rank count along one mesh axis or a tuple of axes (tuples give
    multi-level sharding, e.g. ``("dcn", "data")``: pixel shards split
    across the first axis first, the second within)."""
    return math.prod(mesh.size(_dim(mesh, a)) for a in _names(axis))


def _shard_index(mesh, axis):
    """This rank's shard along ``axis`` (row-major over a tuple)."""
    coord = mesh.get_coordinate()
    idx = 0
    for a in _names(axis):
        d = _dim(mesh, a)
        idx = idx * mesh.size(d) + coord[d]
    return idx


# (id(mesh), axes) -> (mesh, group): the group over a tuple of mesh axes,
# made once (every rank makes every such group, in one order)
_FLAT_GROUPS = {}


def _group(mesh, axis):
    """The process group that reduces over ``axis`` (None: no reduction);
    a tuple of axes is one group over the product of their ranks."""
    names = _names(axis)
    if not names:
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    key = (id(mesh), names)
    if key not in _FLAT_GROUPS:
        dims = [_dim(mesh, a) for a in names]
        rest = [d for d in range(mesh.ndim) if d not in dims]
        rows = mesh.mesh.permute(rest + dims).reshape(
            -1, math.prod(mesh.size(d) for d in dims))
        mine, _ = dist.new_subgroups_by_enumeration(
            [r.tolist() for r in rows])
        _FLAT_GROUPS[key] = (mesh, mine)
    return _FLAT_GROUPS[key][1]


def _placements(mesh, spec):
    """The ``DTensor`` placements of a tensor laid out by ``spec`` (one
    mesh axis, a tuple of them or None per tensor dimension, as a
    ``PartitionSpec``)."""
    out = [Replicate()] * mesh.ndim
    for t, axis in enumerate(spec):
        dims = [_dim(mesh, a) for a in _names(axis)]
        if dims != sorted(dims):
            raise ValueError(f"the axes {axis} must be named in the "
                             f"mesh's order {mesh.mesh_dim_names}")
        for d in dims:
            out[d] = Shard(t)
    return tuple(out)


def _local_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local(x, mesh, spec, dtype=None):
    """This rank's shard of ``x`` as a plain tensor on the mesh's device:
    a ``DTensor``'s own local shard (redistributed first if it is laid out
    otherwise), or the slice of a whole host array or tensor (taken before
    the copy, so the whole never reaches the card). Half, integer and bool
    inputs promote to the default float dtype; ``dtype`` casts."""
    if isinstance(x, DTensor):
        placements = _placements(mesh, spec)
        if tuple(x.placements) != placements:
            x = x.redistribute(mesh, placements)
        out = x.to_local()
    else:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        for t, axis in enumerate(spec):
            if axis is None:
                continue
            n = _axis_size(mesh, axis)
            size = x.shape[t] // n
            lo = _shard_index(mesh, axis) * size
            x = x[(slice(None),) * t + (slice(lo, lo + size),)]
        if not isinstance(x, torch.Tensor):
            x = np.ascontiguousarray(x)
        out = promote_dtype(x, device=_local_device(mesh))
    if dtype is not None:
        out = out.to(dtype)
    return out.contiguous()


def _dtensor(local, mesh, spec, shape):
    """A rank's local shard as the ``DTensor`` of global ``shape``."""
    shape = torch.Size(shape)
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, _placements(mesh, spec),
                              run_check=False, shape=shape, stride=stride)


def _put(x, mesh, spec, dtype=None):
    """``x`` (host array, tensor or ``DTensor``) laid out by ``spec``."""
    local = _local(x, mesh, spec, dtype)
    return _dtensor(local, mesh, spec,
                    tuple(np.shape(x)) if not isinstance(x, DTensor)
                    else tuple(x.shape))


class _Layout(NamedTuple):
    """A mesh with the solve's axes and their process groups."""

    mesh: DeviceMesh
    data_axis: object
    model_axis: object
    data: object    # group over data_axis
    model: object   # group over model_axis, or None

    @classmethod
    def of(cls, mesh, data_axis, model_axis):
        return cls(mesh, data_axis, model_axis, _group(mesh, data_axis),
                   _group(mesh, model_axis))

    @property
    def y(self):
        return (self.model_axis, self.data_axis)

    @property
    def a(self):
        return (self.model_axis, None)

    @property
    def s(self):
        return (None, self.data_axis)

    @property
    def v(self):
        return (self.data_axis, None)


def shard_nmf_problem(mesh, Y, A, S, W=None, data_axis="data",
                      model_axis=None):
    """Place an NMF problem on a mesh: Y/S/W sharded along the pixel axis,
    A replicated (or channel-sharded over ``model_axis``).

    ``data_axis`` may be a tuple of mesh axes, named in the mesh's order,
    for multi-level sharding (e.g. ``("dcn", "data")``). Every rank takes
    its own slice of the host arrays (``DTensor`` inputs keep their
    shards). Returns ``(Y, A, S, W)`` as ``DTensor``s with ``Shard`` /
    ``Replicate`` placements; a W that is not 2-D comes back as it was.
    """
    n_data = _axis_size(mesh, data_axis)
    N = np.shape(Y)[1]
    if N % n_data != 0:
        raise ValueError(
            f"pixel axis N={N} must be divisible by the '{data_axis}' mesh "
            f"axis ({n_data} ranks); pad Y/S/W along the pixel axis "
            f"(e.g. with zero-weight pixels) to a multiple of {n_data}")
    if model_axis is not None:
        n_model = _axis_size(mesh, model_axis)
        C = np.shape(Y)[0]
        if C % n_model != 0:
            raise ValueError(
                f"channel axis C={C} must be divisible by the "
                f"'{model_axis}' mesh axis ({n_model} ranks)")
    y_spec = (model_axis, data_axis)
    Y = _put(Y, mesh, y_spec)
    A = _put(A, mesh, (model_axis, None))
    S = _put(S, mesh, (None, data_axis))
    if W is not None and getattr(W, "ndim", 0) == 2:
        W = _put(W, mesh, y_spec)
    return Y, A, S, W


def _classify_weight(W, y_shape):
    """Normalize a weight argument for the sharded whole-solves:
    ``(weighted, W2d)``.

    ``None`` and the scalar 1 (the reference's ``W == 1``) are unweighted.
    Any other scalar or lower-rank W is weighted: it broadcasts against Y
    as the single-card engines' ``_promote_W`` does, and comes back as a
    view that each rank slices before it copies. 2-D W passes through."""
    if W is None:
        return False, None
    if np.isscalar(W) or getattr(W, "ndim", None) == 0:
        if float(W) == 1.0:
            return False, None
    elif getattr(W, "ndim", None) == 2:
        return True, W
    if isinstance(W, torch.Tensor):
        return True, torch.broadcast_to(W, tuple(y_shape))
    return True, np.broadcast_to(np.asarray(W), tuple(y_shape))


def _weight_shard(W_native, W2, Y, mesh, data_axis, model_axis,
                  weighted):
    """The W operand of a sharded whole-solve. Unweighted: Y itself (the
    solvers never read it), not a Y-sized plane of ones. Weighted with a
    broadcast view: each rank's slice, made from the view."""
    if not weighted:
        return Y
    if W_native is not None:
        return W_native
    return _put(W2, mesh, (model_axis, data_axis), dtype=Y.dtype)


def prox_unity_sharded(X, step, axis=0, axis_name=None, mesh=None):
    """Sum-to-one projection when the normalization axis is sharded: the
    local sum is completed by an all-reduce over ``axis_name``.

    ``X`` is a rank's local shard, or a ``DTensor`` (its mesh then names
    the axes, and the result is a ``DTensor`` laid out as ``X``).
    ``axis_name``: a mesh axis (or a tuple of them) of ``mesh``, or a
    process group; None sums locally. Partial it into a solver's
    ``prox_S`` to normalize each source over the pixels."""
    out_of = None
    if isinstance(X, DTensor):
        out_of, mesh, X = X, X.device_mesh, X.to_local()
    s = torch.sum(X, dim=axis, keepdim=True)
    if axis_name is not None:
        group = (axis_name if isinstance(axis_name, dist.ProcessGroup)
                 else _group(mesh, axis_name))
        dist.all_reduce(s, group=group)
    out = X / s
    if out_of is not None:
        out = DTensor.from_local(out, out_of.device_mesh, out_of.placements,
                                 run_check=False, shape=out_of.shape,
                                 stride=out_of.stride())
    return out


# True while a per-rank program is captured (:mod:`proxmin_tpu_torch.export`):
# the reductions then go through torch's functional collectives, which
# ``torch.export`` traces, instead of the in-place ``dist.all_reduce``,
# which it cannot. The values are the same: one all-reduce of the same
# packed tensor over the same group.
_FUNCTIONAL = False


@contextlib.contextmanager
def functional_collectives():
    """Reduce through ``torch.distributed._functional_collectives`` inside
    the ``with`` block (a program capture); eager solves keep the in-place
    ``dist.all_reduce``."""
    global _FUNCTIONAL
    prev, _FUNCTIONAL = _FUNCTIONAL, True
    try:
        yield
    finally:
        _FUNCTIONAL = prev


def _all_reduce(t, group, op="sum"):
    """``t`` all-reduced over ``group``: in place eagerly, a new tensor
    while a program is captured."""
    if _FUNCTIONAL:
        from torch.distributed import _functional_collectives as funcol

        return funcol.all_reduce(t, op, group)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return t


def _sum_packed(group, *ts):
    """All-reduce (sum) the tensors ``ts`` over ``group`` in one call of
    their concatenation; None entries pass. No group: no reduction."""
    live = [t for t in ts if t is not None]
    if group is None or not live:
        return ts
    if len(live) == 1 and live[0].is_contiguous() and not _FUNCTIONAL:
        dist.all_reduce(live[0], group=group)
        return ts
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in live]), group)
    out, at = [], 0
    for t in ts:
        if t is None:
            out.append(None)
            continue
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return tuple(out)


def _pmax(v, group):
    if group is not None:
        v = _all_reduce(v, group, "max")
    return v


def _lambda_max_small(G, iters=32):
    """Power iteration on small PSD matrices, ``G`` (k, k) or a stack (b,
    k, k): ``iters`` passes from ``ones + 0.01 arange``, then the Rayleigh
    quotient of each."""
    k = G.shape[-1]
    v = (torch.ones(k, dtype=G.dtype, device=G.device)
         + 0.01 * torch.arange(k, dtype=G.dtype, device=G.device))
    v = (v / torch.linalg.norm(v)).expand(G.shape[:-1]).contiguous()
    tiny = torch.finfo(G.dtype).tiny
    for _ in range(iters):
        w = torch.matmul(G, v.unsqueeze(-1)).squeeze(-1)
        v = w / torch.clamp_min(torch.linalg.norm(w, dim=-1, keepdim=True),
                                tiny)
    Gv = torch.matmul(G, v.unsqueeze(-1)).squeeze(-1)
    return torch.sum(v * Gv, dim=-1) / torch.sum(v * v, dim=-1)


def _weighted_steps_v0(A, S):
    """Cold-start iterate (N_local, K) of the sharded batched power
    iteration: the rank's rows of the single-card cold start."""
    K = A.shape[1]
    dt = A.dtype
    v = (torch.ones((S.shape[1], K), dtype=dt, device=A.device)
         + 0.01 * torch.arange(K, dtype=dt, device=A.device))
    return v / torch.linalg.norm(v, dim=1, keepdim=True)


def _weighted_steps(A, S, W, lay, num_iters=_COLD_ITERS, v0=None,
                    return_v=False, with_data=None, extra=None):
    """Weighted Lipschitz steps assembled with collectives:
    ``1 / max_c lambda_max(S diag(W_c) S^T)`` (summed over data, max over
    model) and ``1 / max_n lambda_max(A^T diag(W_n) A)`` by the implicit
    batched power iteration over local pixels (max over data). Fully
    masked pixels give a 0 block, not NaN. ``v0``/``return_v``: the warm
    start carried between strided refreshes. ``with_data``: a tensor that
    rides the Gram's all-reduce over data. ``extra`` adds that many
    passes after the first ``num_iters``: an int in a host loop, a 0-d
    integer CPU tensor (a ``while_loop``) in a program. Returns ``(sA, sS, v,
    with_data)``, ``v`` the next warm start (None unless ``return_v``)."""
    H, with_data = _sum_packed(lay.data,
                               torch.einsum("kn,cn,ln->ckl", S, W, S),
                               with_data)
    LA = _pmax(torch.max(_lambda_max_small(H)), lay.model)

    def Hv_S(v):
        hv = (W * (A @ v.T)).T @ A
        return _sum_packed(lay.model, hv)[0]

    v = _weighted_steps_v0(A, S) if v0 is None else v0
    tiny = torch.finfo(A.dtype).tiny

    def normalize(w):
        ssq = torch.sum(w * w, dim=1, keepdim=True)
        return w * torch.rsqrt(torch.clamp_min(ssq, tiny))

    traced = isinstance(extra, torch.Tensor)
    for _ in range(int(num_iters) + (0 if traced else int(extra or 0))):
        v = normalize(Hv_S(v))
    if traced:
        from torch._higher_order_ops.while_loop import while_loop

        _, v = while_loop(lambda k, v: k < extra,
                          lambda k, v: (k + 1, normalize(Hv_S(v))),
                          (torch.zeros_like(extra), v))
    hv = Hv_S(v)
    rayleigh = torch.sum(v * hv, dim=1) / torch.clamp_min(
        torch.sum(v * v, dim=1), tiny)
    LS = _pmax(torch.max(rayleigh), lay.data)
    return 1.0 / LA, 1.0 / LS, normalize(hv) if return_v else None, with_data


def _unweighted_steps(A, S, lay, with_data=None, with_model=None):
    """Unweighted Lipschitz steps from the K x K Grams, one all-reduce
    each (``with_data``/``with_model`` ride along and come back
    reduced): ``(sA, sS, with_data, with_model)``."""
    # torch.t, not .T: a program's refresh loop would take S and S.T as
    # two aliased inputs, which torch's while_loop refuses
    SSt, with_data = _sum_packed(lay.data, S @ torch.t(S), with_data)
    AtA, with_model = _sum_packed(lay.model, torch.t(A) @ A, with_model)
    lam = _lambda_max_small(torch.stack([SSt, AtA]))
    return 1.0 / lam[0], 1.0 / lam[1], with_data, with_model


def _pgm_iteration(A, S, Y, W, lay, weighted, prox_A, prox_S, steps=None,
                   e2=0.0, stats=True):
    """One PGM iteration on the local shards: ``(A', S', conv_A, conv_S,
    finite, loss)`` with the flags and the loss all-reduced.
    ``steps`` (frozen strided steps) skips the step computation;
    ``stats=False`` reduces only the loss (flags None)."""
    R = A @ S - Y
    D = W * R if weighted else R
    gA = D @ S.T
    gS = A.T @ D
    if steps is not None:
        gA, = _sum_packed(lay.data, gA)
        gS, = _sum_packed(lay.model, gS)
    elif weighted:
        gS, = _sum_packed(lay.model, gS)
        sA, sS, _, gA = _weighted_steps(A, S, W, lay, with_data=gA)
        steps = (sA, sS)
    else:
        sA, sS, gA, gS = _unweighted_steps(A, S, lay, with_data=gA,
                                           with_model=gS)
        steps = (sA, sS)
    sA, sS = steps
    A1 = prox_A(A - sA * gA, sA)
    S1 = prox_S(S - sS * gS, sS)
    # sum(W R^2)/2 == sum(D R)/2 (= sum(R^2)/2 unweighted)
    loss = torch.sum(D * R) / 2
    if not stats:
        loss, = _sum_packed(lay.data, loss)
        loss, = _sum_packed(lay.model, loss)
        return A1, S1, None, None, None, loss
    return (A1, S1) + _stop_stats(A, A1, S, S1, loss, lay, e2)


def _stop_stats(A, A1, S, S1, loss, lay, e2):
    """The fixed-point flags, the finiteness of the iterates and the loss,
    reduced across every mesh axis: ``(conv_A, conv_S, finite, loss)``.
    On a mesh without a model axis A is replicated and its norms local."""
    dA = torch.sum((A1 - A) ** 2)
    nA = torch.sum(A1 ** 2)
    red = torch.stack([torch.sum((S1 - S) ** 2), torch.sum(S1 ** 2), loss])
    red, = _sum_packed(lay.data, red)
    if lay.model is not None:
        red = torch.cat([torch.stack([dA, nA]), red])
        red, = _sum_packed(lay.model, red)
        dA, nA, red = red[0], red[1], red[2:]
    dS, nS, loss = red[0], red[1], red[2]
    finite = torch.isfinite(torch.stack([dA, nA, dS, nS])).all()
    return dA <= e2 * nA, dS <= e2 * nS, finite, loss


def _poisoned(finite, loss):
    """``loss``, NaN where the post-update norms are not ``finite``: the
    stop rule then fires on the iteration the iterate diverges."""
    return torch.where(finite, loss, torch.full_like(loss, np.nan))


def _go_on(conv_A, conv_S, loss, started=None):
    """The stop rule of the JAX whole solve on 0-d tensors that every rank
    holds alike: go on unless both factors converged or the loss is not
    finite after an iteration (``started``, a 0-d bool: one has run, in
    this call or before a resume; None: one has). The host loop reads it
    (:class:`_Stop`), a program's ``while_loop`` carries it."""
    bad = torch.logical_not(torch.isfinite(loss))
    if started is not None:
        bad = torch.logical_and(bad, started)
    return torch.logical_not(torch.logical_or(
        torch.logical_and(conv_A, conv_S), bad))


class _Stop:
    """The host loop's clock and :func:`_go_on`'s last verdict: ``it <
    it_lim`` and the rule holds."""

    def __init__(self, it0, conv_A, conv_S, loss, max_iter):
        self.it0 = self.it = int(it0)
        self.it_lim = self.it0 + int(max_iter)
        self.conv = (bool(conv_A), bool(conv_S))
        self.going = bool(_go_on(
            torch.tensor(self.conv[0]), torch.tensor(self.conv[1]),
            torch.tensor(float(loss)), torch.tensor(self.it0 > 0)))

    def go(self):
        return self.going and self.it < self.it_lim

    def record(self, conv_A, conv_S, loss):
        """One host read: the iteration's flags and the rule on its
        (poisoned) loss."""
        cA, cS, going = torch.stack(
            [conv_A, conv_S, _go_on(conv_A, conv_S, loss)]).tolist()
        self.it += 1
        self.conv = (bool(cA), bool(cS))
        self.going = bool(going)


def _stride_refresh(A, S, W, lay, weighted, step_adapt, old_steps, stride,
                    v, it, it_h):
    """The strided refresh at iteration ``it``: the frozen steps
    (``_STRIDE_SAFETY`` times the Lipschitz steps; weighted, the power
    iterate warm-started from ``v``, with the cold passes on the first
    refresh) and, under ``step_adapt``, the interval grown from the drift
    against ``old_steps``. ``it`` and ``it_h`` (the clock as the power
    passes read it) are ints in the host loop; in a program ``it`` is on
    the device and ``it_h`` a CPU tensor. Returns ``(steps, stride, v)``."""
    if weighted:
        LA_s, LS_s, v, _ = _weighted_steps(
            A, S, W, lay, _WARM_ITERS, v0=v, return_v=True,
            extra=(it_h == 0) * (_COLD_ITERS - _WARM_ITERS))
    else:
        LA_s, LS_s, _, _ = _unweighted_steps(A, S, lay)
    steps = (_STRIDE_SAFETY * LA_s, _STRIDE_SAFETY * LS_s)
    if step_adapt:
        stride = grow_stride(stride, old_steps, steps,
                             (1.0 - _STRIDE_SAFETY) / 2, 100,
                             first=(it == 0))
    return steps, stride, v


def _pgm_solve(A, S, Y, W, lay, weighted, prox_A, prox_S, e_rel, max_iter,
               step_stride, step_adapt, resume):
    """The whole PGM solve on the local shards; ``resume`` is None or the
    carried ``(it0, conv_A, conv_S, loss[, sA, sS, stride, seg_end[,
    v]])``. Returns ``(A, S, stop, loss, strided carries)``."""
    strided = (step_stride is not None and step_stride > 1) or step_adapt
    e2 = e_rel ** 2
    dt = A.dtype
    if resume is None:
        stop = _Stop(0, False, False, np.inf, max_iter)
        loss = torch.full((), np.inf, dtype=dt, device=A.device)
    else:
        stop = _Stop(*resume[:4], max_iter)
        loss = torch.full((), float(resume[3]), dtype=dt, device=A.device)

    def run(A, S, loss, steps=None, seg_end=None):
        while stop.go() and (seg_end is None or stop.it < seg_end):
            A, S, cA, cS, fin, raw = _pgm_iteration(
                A, S, Y, W, lay, weighted, prox_A, prox_S, steps, e2)
            loss = _poisoned(fin, raw)
            stop.record(cA, cS, loss)
        return A, S, loss

    if not strided:
        A, S, loss = run(A, S, loss)
        return A, S, stop, loss, ()
    if resume is not None:
        sA, sS = (as_tensor(s, dt, A.device) for s in resume[4:6])
        stride_c, seg = int(resume[6]), int(resume[7])
        v = resume[8] if weighted else None
        # finish the interrupted segment with the carried frozen steps
        A, S, loss = run(A, S, loss, (sA, sS), seg)
    else:
        sA = sS = torch.zeros((), dtype=dt, device=A.device)
        stride_c = int(step_stride) if step_stride else 1
        seg = stop.it
        v = _weighted_steps_v0(A, S) if weighted else None
    while stop.go():
        it = stop.it
        # under step_adapt the drift is one host read
        steps, stride_c, v = _stride_refresh(A, S, W, lay, weighted,
                                             step_adapt, (sA, sS), stride_c,
                                             v, it, it)
        sA, sS = steps
        seg = it + (stride_c if step_adapt else int(step_stride))
        A, S, loss = run(A, S, loss, steps, seg)
    return A, S, stop, loss, (sA, sS, stride_c, seg, v)


def _pgm_program(A, S, Y, W, lay, weighted, prox_A, prox_S, e_rel,
                 max_iter, step_stride, step_adapt, carry):
    """:func:`_pgm_solve` as one ``while_loop`` on a rank's shards, the
    body of a per-rank program (captured under
    :func:`functional_collectives`). Every input is a tensor: ``max_iter``
    0-d int32, ``carry`` None (a fresh solve) or ``(it0, conv_A, conv_S,
    loss[, step_A, step_S, stride, seg_end[, v]])``. The loop takes the
    host loop's iterations (:func:`_pgm_iteration`, the same sums in the
    same order) and its stop rule (:func:`_go_on`) on the device, so the
    ranks leave it together; a strided refresh (:func:`_stride_refresh`)
    is a ``while_loop`` of zero or one trip on a clock kept on the host
    (CPU tensors), as in
    ``nmf._fused_weighted_program``. Returns ``(A, S, it, conv_A, conv_S,
    loss)`` and, when strided, ``(step_A, step_S, stride, seg_end[, v])``
    after them."""
    from torch._higher_order_ops.while_loop import while_loop

    strided = (step_stride is not None and step_stride > 1) or step_adapt
    e2 = e_rel ** 2
    dt, dev, host = A.dtype, A.device, torch.device("cpu")
    i32 = torch.int32
    if carry is None:
        it0 = torch.zeros((), dtype=i32, device=dev)
        conv_A0, conv_S0 = (torch.zeros((), dtype=torch.bool, device=dev)
                            for _ in range(2))
        loss0 = torch.full((), np.inf, dtype=dt, device=dev)
    else:
        it0, conv_A0, conv_S0, loss0 = carry[:4]
    go0 = _go_on(conv_A0, conv_S0, loss0, it0 > 0)
    end = it0 + max_iter

    def iterate(A, S, steps):
        A, S, cA, cS, fin, raw = _pgm_iteration(
            A, S, Y, W, lay, weighted, prox_A, prox_S, steps, e2)
        loss = _poisoned(fin, raw)
        return A, S, cA, cS, loss, _go_on(cA, cS, loss)

    if not strided:
        def body(A, S, it, cA, cS, loss, go):
            A, S, cA, cS, loss, go = iterate(A, S, None)
            return A, S, it + 1, cA, cS, loss, go

        return while_loop(lambda *c: torch.logical_and(c[-1], c[2] < end),
                          body, (A, S, it0, conv_A0, conv_S0, loss0,
                                 go0))[:6]

    if carry is None:
        # two tensors: a loop may not take one tensor as two inputs
        sA, sS = (torch.zeros((), dtype=dt, device=dev) for _ in range(2))
        stride_c = torch.full((), int(step_stride) if step_stride else 1,
                              dtype=i32, device=dev)
        seg = it0.clone()
        v = _weighted_steps_v0(A, S) if weighted else None
    else:
        sA, sS, stride_c, seg = carry[4:8]
        v = carry[8] if weighted else None
    it_h, seg_h = (t.to(host, torch.int64) for t in (it0, seg))

    def refresh(k, sA_o, sS_o, stride_c, seg, seg_h, *v, A, S, it, it_h):
        steps, stride_c, v_n = _stride_refresh(
            A, S, W, lay, weighted, step_adapt, (sA_o, sS_o), stride_c,
            v[0] if weighted else None, it, it_h)
        if step_adapt:
            # the host loop reads the drift here too
            seg_h = it_h + stride_c.to(host, torch.int64)
        else:
            stride_c = stride_c.clone()
            seg_h = it_h + int(step_stride)
        return (k + 1, *steps, stride_c, it + stride_c, seg_h,
                *((v_n,) if weighted else ()))

    def body(A, S, it, cA, cS, loss, sA, sS, stride_c, seg, it_h, seg_h, go,
             *v):
        due = (it_h >= seg_h).to(torch.int64)
        _, sA, sS, stride_c, seg, seg_h, *v = while_loop(
            lambda k, *r: k < due,
            lambda k, *r: refresh(k, *r, A=A, S=S, it=it, it_h=it_h),
            (torch.zeros_like(due), sA, sS, stride_c, seg, seg_h, *v))
        A, S, cA, cS, loss, go = iterate(A, S, (sA, sS))
        return (A, S, it + 1, cA, cS, loss, sA, sS, stride_c, seg,
                it_h + 1, seg_h, go, *v)

    out = while_loop(lambda *c: torch.logical_and(c[12], c[2] < end), body,
                     (A, S, it0, conv_A0, conv_S0, loss0, sA, sS, stride_c,
                      seg, it_h, seg_h, go0) + ((v,) if weighted else ()))
    return out[:10] + tuple(out[13:])


def make_nmf_pgm_step(mesh, prox_A=operators.prox_plus,
                      prox_S=operators.prox_plus, weighted=False,
                      data_axis="data", model_axis=None):
    """Build the explicitly-collective PGM-NMF training step.

    Returns ``step(A, S, Y, W=None) -> (A', S', loss)`` on sharded
    problems (``DTensor``s from :func:`shard_nmf_problem`, or host arrays,
    which each rank slices), with the collective layout of the module
    docstring; ``loss`` is the all-reduced ``sum(W R^2) / 2`` of the
    iterates it was given. ``prox_S`` runs on the local pixel shard: if it
    normalizes along the pixel axis use :func:`prox_unity_sharded`."""
    lay = _Layout.of(mesh, data_axis, model_axis)

    def step(A, S, Y, W=None):
        Al, Sl = _local(A, mesh, lay.a), _local(S, mesh, lay.s)
        dt = torch.promote_types(Al.dtype, Sl.dtype)
        Al, Sl, Yl = Al.to(dt), Sl.to(dt), _local(Y, mesh, lay.y, dt)
        Wl = (_local(W, mesh, lay.y, dt) if weighted and W is not None
              else torch.ones_like(Yl) if weighted else Yl)
        A1, S1, _, _, _, loss = _pgm_iteration(
            Al, Sl, Yl, Wl, lay, weighted, prox_A, prox_S, stats=False)
        return (_dtensor(A1, mesh, lay.a, np.shape(A)),
                _dtensor(S1, mesh, lay.s, np.shape(S)), loss)

    return step


def _operands(mesh, lay, Y, A, S, W, weighted, W2):
    """The sharded operands of a whole solve, ``(Y, A, S, W)`` as
    ``DTensor``s (W aliases Y when unweighted), from :func:`_classify_weight`'s
    ``(weighted, W2)``."""
    Yd, Ad, Sd, Wd = shard_nmf_problem(
        mesh, Y, A, S, W2 if (weighted and W2 is W) else None,
        data_axis=lay.data_axis, model_axis=lay.model_axis)
    Wd = _weight_shard(Wd, W2, Yd, mesh, lay.data_axis, lay.model_axis,
                       weighted)
    return Yd, Ad, Sd, Wd


def _locals(Yd, Ad, Sd, Wd):
    """The local shards, in the dtype of A and S."""
    dt = torch.promote_types(Ad.dtype, Sd.dtype)
    return (Yd.to_local().to(dt), Ad.to_local().to(dt),
            Sd.to_local().to(dt), Wd.to_local().to(dt))


def _writeback(originals, results):
    """Update float NumPy inputs in place with the whole result (an
    all-gather of each sharded result, once per solve; every rank writes
    its own copy)."""
    for orig, res in zip(originals, results):
        if (isinstance(orig, np.ndarray) and orig.dtype.kind == "f"
                and orig.flags.writeable
                and orig.dtype.itemsize >= res.element_size()):
            orig[...] = res.full_tensor().detach().cpu().numpy()


def _finish(kind_state, A, S, Af, Sf, stop, loss, it0):
    """The ``SolverResult`` of a whole solve, with the write-back."""
    converged = stop.conv
    iterations = stop.it - it0
    # a resumed solve carries its (possibly nan-poisoned) loss, so a
    # diverged-then-resumed no-op stays "diverged"
    diverged = not np.isfinite(loss) and (iterations > 0 or it0 > 0)
    status = status_from(all(converged), diverged, logger)
    _writeback((A, S), (Af, Sf))
    return SolverResult(converged, x=(Af, Sf), iterations=iterations,
                        converged=converged, loss=loss, status=status,
                        state=kind_state)


def _resume_scalars(state):
    """The carried clock and terminal scalars (absent on old states:
    "not stopped" and a finite loss)."""
    return (int(np.asarray(state["it"])),
            bool(np.asarray(state.get("conv_A", False))),
            bool(np.asarray(state.get("conv_S", False))),
            float(np.asarray(state.get("loss", 0.0))))


def nmf_pgm_sharded(
    Y, A, S, W=None, mesh=None,
    prox_A=operators.prox_plus, prox_S=operators.prox_plus,
    e_rel=1e-3, max_iter=1000,
    data_axis="data", model_axis=None,
    step_stride=None,
    step_adapt=False,
    state=None,
    device=None,
):
    """Full sharded PGM-NMF solve: every rank runs the host loop on its
    shards, and all-reduced stop flags end it on the same iteration on
    every rank.

    Semantics match :func:`proxmin_tpu_torch.nmf.nmf` with
    ``algorithm='pgm'`` (unweighted or weighted Gaussian model,
    per-factor fixed-point convergence at ``e_rel``), with the steps of
    the JAX whole solve (32 power passes on the K x K Grams, 48 on the
    weighted per-pixel blocks). ``step_stride`` recomputes the Lipschitz
    bounds only every this many iterations (0.9 safety factor, the
    weighted power iterate warm-started: 48 passes on the first refresh,
    12 after); ``step_adapt=True`` grows or halves the interval from the
    measured step drift (``utils.grow_stride``).

    ``state=`` is the exact warm restart: pass a previous call's ``.state``
    (same weighting and stride configuration; a JAX state through
    :func:`proxmin_tpu_torch.interop.state_from_numpy`) with its final
    iterates, and the continuation walks the uninterrupted trajectory:
    the iteration clock, and in strided mode the frozen steps, the refresh
    interval, the segment boundary and the sharded power iterate carry
    through. ``max_iter`` counts the additional iterations of this call.

    The mesh defaults to :func:`make_mesh` on ``device`` (the card unless
    ``device="cpu"``). Returns a ``SolverResult`` with ``.x == (A, S)``
    (``DTensor``s), ``.iterations``, ``.converged``, ``.loss``,
    ``.state``; float NumPy inputs are updated in place.
    """
    if mesh is None:
        mesh = make_mesh(device=device)
    lay = _Layout.of(mesh, data_axis, model_axis)
    strided = (step_stride is not None and step_stride > 1) or step_adapt
    stride_cfg = (0 if step_stride is None else int(step_stride),
                  bool(step_adapt))
    weighted, W2 = _classify_weight(W, np.shape(Y))
    if state is not None:
        if not (hasattr(state, "get")
                and state.get("kind") == "nmf_pgm_sharded"):
            raise ValueError(
                "state= must be a previous nmf_pgm_sharded .state dict "
                "(single-device solver states do not resume the "
                "explicit-collective path)")
        st_cfg = tuple(state.get("stride_config", stride_cfg))
        if (bool(state["strided"]) != strided
                or (int(st_cfg[0]), bool(st_cfg[1])) != stride_cfg):
            raise ValueError(
                "state= was produced under a different stride "
                "configuration (step_stride={}, step_adapt={} vs this "
                "call's step_stride={}, step_adapt={}); resume with "
                "the same settings: the carried segment boundaries "
                "and refresh schedule are only exact under them".format(
                    st_cfg[0] or None, bool(st_cfg[1]),
                    step_stride, step_adapt))
        if bool(state["weighted"]) != weighted:
            raise ValueError(
                "state= was produced under a different weighting (the "
                "carried step scalars and power iterate would be wrong)")
    Yd, Ad, Sd, Wd = _operands(mesh, lay, Y, A, S, W, weighted, W2)
    Yl, Al, Sl, Wl = _locals(Yd, Ad, Sd, Wd)
    resume = None
    if state is not None:
        resume = _resume_scalars(state)
        if strided:
            resume += (state["step_A"], state["step_S"],
                       int(np.asarray(state["stride"])),
                       int(np.asarray(state["seg_end"])))
            if weighted:
                resume += (_local(state["v"], mesh, lay.v, Al.dtype),)
    Af, Sf, stop, loss_t, carry = _pgm_solve(
        Al, Sl, Yl, Wl, lay, weighted, prox_A or operators.prox_id,
        prox_S or operators.prox_id, e_rel, max_iter, step_stride,
        step_adapt, resume)
    loss = float(loss_t)
    Ag = _dtensor(Af, mesh, lay.a, Ad.shape)
    Sg = _dtensor(Sf, mesh, lay.s, Sd.shape)
    resume_state = {
        "kind": "nmf_pgm_sharded", "strided": strided,
        "weighted": weighted, "it": stop.it,
        "stride_config": stride_cfg,
        "conv_A": stop.conv[0], "conv_S": stop.conv[1], "loss": loss,
    }
    if strided:
        sA, sS, stride_c, seg, v = carry
        resume_state.update(step_A=sA, step_S=sS, stride=stride_c,
                            seg_end=seg)
        if weighted:
            resume_state["v"] = _dtensor(v, mesh, lay.v,
                                         (Sd.shape[1], Ad.shape[1]))
    return _finish(resume_state, A, S, Ag, Sg, stop, loss, stop.it0)


def _adam_scalars(b1, b2, t, dt):
    """``(1 - b1, b1, 1 - b2, b2, 1 / (1 - b1^t), 1 / (1 - b2^t))`` as
    host numbers of ``dt``'s precision. float32 takes the port's
    convention (:func:`proxmin_tpu_torch.nmf._bias_corrections`: float64
    powers of the float32 decays, rounded), so a float32 solve's
    corrections equal the single-card fused engine's; float64 computes in
    float64."""
    if dt == torch.float32:
        from ..nmf import _bias_corrections

        b1_t, bc1, bc2 = _bias_corrections(b1, b2, t)
        one, b2_t = np.float32(1), np.float32(b2)
    else:
        one, b1_t, b2_t = np.float64(1), np.float64(b1), np.float64(b2)
        bc1 = one / (one - b1_t ** np.float64(t))
        bc2 = one / (one - b2_t ** np.float64(t))
    return tuple(float(x) for x in (one - b1_t, b1_t, one - b2_t, b2_t,
                                    bc1, bc2))


def _adaprox_iteration(A, S, MA, VA, MS, VS, Y, W, lay, weighted, prox_A,
                       prox_S, counts, scalars, eps, e2):
    """One proximal-Adam iteration on the local shards (``scheme='adam'``
    with the closed-form separable prox): ``(A', S', MA', VA', MS', VS',
    conv_A, conv_S, finite, loss)``."""
    C, N = counts
    m1, b1, m2, b2, bc1, bc2 = scalars
    tiny = float(np.finfo(np.float32).tiny)
    R = A @ S - Y
    D = W * R if weighted else R
    # step_adaprox (the reference's row and column means), mesh-reduced,
    # each riding its axis's gradient all-reduce
    rowsum, gA = _sum_packed(lay.data, torch.sum(S, dim=1, keepdim=True),
                             D @ S.T)
    colsum, gS = _sum_packed(lay.model, torch.sum(A, dim=0), A.T @ D)
    alpha_A = colsum / C / 10.0
    alpha_S = rowsum / N / 10.0

    def adam_block(x, g, M, V, alpha, prox):
        M1 = m1 * g + b1 * M
        V1 = m2 * g ** 2 + b2 * V
        Phi = M1 * bc1
        Psi = torch.sqrt(V1 * bc2) + eps
        Psi_safe = torch.clamp_min(Psi, tiny)
        x1 = x - alpha * Phi / Psi_safe
        return prox(x1, alpha / Psi_safe), M1, V1

    A1, MA1, VA1 = adam_block(A, gA, MA, VA, alpha_A[None, :], prox_A)
    S1, MS1, VS1 = adam_block(S, gS, MS, VS, alpha_S, prox_S)
    loss = torch.sum(D * R) / 2
    return (A1, S1, MA1, VA1, MS1, VS1) + _stop_stats(A, A1, S, S1, loss,
                                                      lay, e2)


def nmf_adaprox_sharded(
    Y, A, S, W=None, mesh=None,
    prox_A=operators.prox_plus, prox_S=operators.prox_plus,
    e_rel=1e-3, max_iter=1000,
    data_axis="data", model_axis=None,
    b1=0.9, b2=0.999, eps=1e-8,
    state=None,
    device=None,
):
    """Full sharded proximal-Adam NMF solve with explicit collectives (the
    AdaProx sibling of :func:`nmf_pgm_sharded`).

    The configuration of the single-card fused engine: ``scheme='adam'``
    with separable proxes applied in closed form; the moments live sharded
    like their blocks and never cross the network. Collectives per
    iteration: ``alpha_S``'s row sums with ``grad_A`` over data,
    ``alpha_A``'s column sums with ``grad_S`` over model (2-D meshes), the
    convergence norms and the loss over both. ``state=`` is the exact warm
    restart: moments, the global Adam bias-correction clock and the
    terminal flags carry through bit for bit.

    Returns a ``SolverResult`` with ``.x == (A, S)`` (``DTensor``s),
    ``.iterations``, ``.converged``, ``.loss``, ``.state``.
    """
    if mesh is None:
        mesh = make_mesh(device=device)
    lay = _Layout.of(mesh, data_axis, model_axis)
    weighted, W2 = _classify_weight(W, np.shape(Y))
    if state is not None:
        if not (hasattr(state, "get")
                and state.get("kind") == "nmf_adaprox_sharded"):
            raise ValueError(
                "state= must be a previous nmf_adaprox_sharded .state "
                "dict (single-device adaprox states do not resume the "
                "explicit-collective path)")
        if bool(state["weighted"]) != weighted:
            raise ValueError(
                "state= was produced under a different weighting")
    Yd, Ad, Sd, Wd = _operands(mesh, lay, Y, A, S, W, weighted, W2)
    Yl, Al, Sl, Wl = _locals(Yd, Ad, Sd, Wd)
    dt = Al.dtype
    prox_A = prox_A or operators.prox_id
    prox_S = prox_S or operators.prox_id
    if state is None:
        stop = _Stop(0, False, False, np.inf, max_iter)
        loss = torch.full((), np.inf, dtype=dt, device=Al.device)
        MA, VA = torch.zeros_like(Al), torch.zeros_like(Al)
        MS, VS = torch.zeros_like(Sl), torch.zeros_like(Sl)
    else:
        scal = _resume_scalars(state)
        stop = _Stop(*scal, max_iter)
        loss = torch.full((), scal[3], dtype=dt, device=Al.device)
        MA, VA = (_local(state[k], mesh, lay.a, dt) for k in ("MA", "VA"))
        MS, VS = (_local(state[k], mesh, lay.s, dt) for k in ("MS", "VS"))
    counts = (float(Ad.shape[0]), float(Sd.shape[1]))
    e2 = e_rel ** 2
    while stop.go():
        # the global Adam clock (resume-safe)
        scalars = _adam_scalars(b1, b2, stop.it + 1, dt)
        Al, Sl, MA, VA, MS, VS, cA, cS, fin, raw = _adaprox_iteration(
            Al, Sl, MA, VA, MS, VS, Yl, Wl, lay, weighted, prox_A, prox_S,
            counts, scalars, eps, e2)
        loss = _poisoned(fin, raw)
        stop.record(cA, cS, loss)
    loss = float(loss)
    shapes = {"a": Ad.shape, "s": Sd.shape}
    resume_state = {
        "kind": "nmf_adaprox_sharded", "weighted": weighted, "it": stop.it,
        "conv_A": stop.conv[0], "conv_S": stop.conv[1], "loss": loss,
        "MA": _dtensor(MA, mesh, lay.a, shapes["a"]),
        "VA": _dtensor(VA, mesh, lay.a, shapes["a"]),
        "MS": _dtensor(MS, mesh, lay.s, shapes["s"]),
        "VS": _dtensor(VS, mesh, lay.s, shapes["s"]),
    }
    return _finish(resume_state, A, S, _dtensor(Al, mesh, lay.a, Ad.shape),
                   _dtensor(Sl, mesh, lay.s, Sd.shape), stop, loss,
                   stop.it0)
