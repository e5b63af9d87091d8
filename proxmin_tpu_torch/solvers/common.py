"""Shared infrastructure for the port's solver drivers: reference-shaped
results, dtype promotion at the solver boundary, the NumPy in-place
contract, prox normalization, the gradient of a smooth function by
autograd and the structure check of a resumed stepper state. Counterparts
of the same names in :mod:`proxmin_tpu.solvers.common`."""

import functools

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from .. import operators
from ..utils import _as_tuple, replicated_like

__all__ = [
    "BoolResult",
    "SolverResult",
    "status_from",
    "tupleize",
    "default_device",
    "promote_dtype",
    "writeback",
    "normalize_prox",
    "normalize_per_block",
    "as_tensor",
    "map_leaves",
    "as_torch_dtype",
    "separable_blocks",
    "grad_from_f",
    "tree_structure",
    "check_stepper_state",
    "under_vmap",
    "any_lane",
    "select_lanes",
    "run_lanes",
    "host_values",
    "replicated_like",
    "reduced",
    "local_of",
]


class BoolResult(int):
    """A bool-valued result that also carries named attributes (``bool``
    cannot be subclassed, so this subclasses ``int``)."""

    def __new__(cls, value, **attrs):
        obj = super().__new__(cls, bool(value))
        for k, v in attrs.items():
            object.__setattr__(obj, k, v)
        return obj

    def __repr__(self):
        return f"BoolResult({bool(self)}, {self.__dict__})"


class SolverResult(tuple):
    """A tuple that unpacks like the reference return value
    (``converged, G, S = pgm(...)``) and carries named attributes
    (``.x``, ``.iterations``, ``.state``, ...)."""

    def __new__(cls, fields, **attrs):
        obj = super().__new__(cls, fields)
        for k, v in attrs.items():
            object.__setattr__(obj, k, v)
        return obj

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({inner})"


def status_from(converged, diverged, logger=None):
    """``"diverged" | "converged" | "max_iter"`` plus the matching warning
    (divergence outranks non-convergence)."""
    if logger is not None:
        if diverged:
            logger.warning("Solution diverged (non-finite iterate)")
        elif not converged:
            logger.warning("Solution did not converge")
    return ("diverged" if diverged
            else "converged" if converged else "max_iter")


def default_device(device=None):
    """Where NumPy inputs go: ``device`` when given, else the card. With
    no CUDA device and no ``device``, raises ``RuntimeError``: a solve
    never moves to the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "NumPy inputs go to the CUDA device by default and there is "
            "none; pass device=\"cpu\" (or CPU tensors) to run on the CPU")
    return torch.device("cuda")


def promote_dtype(a, keep=None, device=None):
    """``a`` as a tensor: tensors stay where they are (moved only when
    ``device`` is given), NumPy arrays and scalars land on
    :func:`default_device` (``device``, else the card). Half/integer/bool
    inputs -> the default float dtype; float32/float64 pass through.
    ``keep``: a reduced storage dtype an already-matching tensor may stay
    in."""
    if isinstance(a, torch.Tensor):
        a = a if device is None else a.to(device)
    else:
        a = np.asarray(a)
        if not a.flags.writeable:  # e.g. a view of a JAX array
            a = a.copy()
        a = torch.as_tensor(a, device=default_device(device))
    if keep is not None and a.dtype == keep:
        return a
    if not a.is_floating_point() or torch.finfo(a.dtype).bits < 32:
        a = a.to(torch.get_default_dtype())
    return a


def tupleize(X, device=None):
    """``X`` (array or sequence of arrays) -> ``(tensors, originals,
    was_single)``; the tensors are promoted copies, never aliases of the
    caller's data. NumPy blocks go to ``device`` (default: the card)."""
    was_single = type(X) not in (list, tuple)
    X_seq = _as_tuple(X)
    X_dev = tuple(promote_dtype(
        x, device=None if isinstance(x, torch.Tensor) else device).clone()
        for x in X_seq)
    return X_dev, tuple(X_seq), was_single


def writeback(originals, results):
    """Update float NumPy inputs in place (the reference's "X will be
    updated" contract). Only writable same-or-wider float arrays are
    written: narrowing or writing floats into integers would truncate
    silently, and a read-only view (e.g. of a JAX array) cannot take it.
    A ``DTensor`` result is gathered once, and only for such an input."""
    for orig, res in zip(originals, results):
        if (isinstance(orig, np.ndarray) and orig.dtype.kind == "f"
                and orig.flags.writeable
                and orig.dtype.itemsize >= res.element_size()):
            if isinstance(res, DTensor):
                res = res.full_tensor()
            orig[...] = res.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Sharded iterates (auto-SPMD). The drivers run unchanged on ``DTensor``
# blocks: DTensor propagates every block's placements through their
# operations and inserts the collectives (a pixel-sharded matmul's
# contraction, a sum over the pixel axis). What the drivers read on the
# host, and the tensors they make themselves, go through the three helpers
# below: a host read takes a value that is the same on every rank (a
# pending reduction is all-reduced first, never a sharded operand
# gathered), so every rank takes the same branch.

def host_values(t):
    """``t.tolist()``: one blocking read. A ``DTensor`` is read through its
    replicated value; the drivers read only stop flags and scalars, whose
    pending sums are all-reduced here (a few elements)."""
    return local_of(t).tolist()


def reduced(t):
    """``t`` with its pending sums all-reduced: a ``DTensor`` comes back
    replicated over the mesh axes it is ``Partial`` on (its shards stay
    shards), a plain tensor as it is. A step heuristic's sum over the pixel
    axis goes through here before it meets a sharded block, so DTensor
    reduces the K sums instead of gathering the block."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                           else p for p in t.placements])
    return t


def local_of(t):
    """A replicated value as a plain tensor (a ``DTensor``'s pending sum is
    all-reduced first), for arithmetic that mixes it with the driver's own
    tensors; a plain tensor passes."""
    if isinstance(t, DTensor):
        if any(not p.is_replicate() for p in t.placements):
            t = t.redistribute(t.device_mesh,
                               [Replicate()] * t.device_mesh.ndim)
        return t.to_local()
    return t


def normalize_prox(prox, n_blocks):
    """Broadcast a single prox over blocks and map ``None`` -> identity."""
    prox = _as_tuple(prox)
    if len(prox) == 1:
        prox = prox * n_blocks
    if len(prox) != n_blocks:
        raise AssertionError(
            f"got {len(prox)} prox operators for {n_blocks} variable "
            "blocks (pass one per block, or a single prox to broadcast)"
        )
    return tuple(p if p is not None else operators.prox_id for p in prox)


def normalize_per_block(val, n_blocks):
    """Broadcast a scalar per-block parameter (e.g. ``e_rel``) to a
    tuple."""
    if np.isscalar(val):
        return (float(val),) * n_blocks
    val = tuple(float(v) for v in val)
    if len(val) != n_blocks:
        raise ValueError(f"got {len(val)} values for {n_blocks} blocks")
    return val


def as_tensor(a, dtype=None, device=None):
    """``a`` (tensor, NumPy array or scalar) as a tensor of ``dtype`` (by
    default its own) on ``device`` (a tensor by default stays where it is,
    NumPy goes to :func:`default_device`). ``ml_dtypes`` bfloat16 arrays,
    as JAX hands them out, which torch cannot take, go through float32
    (exact for every bfloat16 value) and arrive as ``torch.bfloat16``."""
    if not isinstance(a, torch.Tensor):
        device = default_device(device)
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
            dtype = dtype or torch.bfloat16
        elif not a.flags.writeable:  # e.g. a view of a JAX array
            a = a.copy()
        a = torch.as_tensor(a)
    return a.to(device=device, dtype=dtype)


def map_leaves(fn, tree):
    """``fn`` over the leaves of nested tuples or lists (a solver's Z/U:
    a tensor, a tuple of them per constraint, or a tuple of those per
    block); the nesting comes back as tuples."""
    if isinstance(tree, (list, tuple)):
        return tuple(map_leaves(fn, t) for t in tree)
    return fn(tree)


def as_torch_dtype(dtype):
    """``torch.bfloat16``, a name such as ``"bfloat16"``, or a NumPy-style
    dtype object (``jnp.bfloat16``) -> the torch floating dtype; None stays
    None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"expected a floating dtype, got {dtype!r}")
    return dt


def separable_blocks(prox_in, has_prox, separable_prox):
    """Resolve ``adaprox``'s ``separable_prox`` flag into a per-block
    tuple.

    ``True`` asserts every constrained block's prox admits the closed-form
    scaled prox (the caller's responsibility); ``"auto"`` consults the
    operator's ``separable_when(bound_kwargs)`` predicate (see
    ``operators.py``), unwrapping one level of ``functools.partial``;
    ``False``/None disables. Any other value raises ``ValueError`` (a typo
    like ``"Auto"`` silently disabling it would be invisible)."""
    n = len(prox_in)
    if separable_prox is True:
        return tuple(has_prox)
    if separable_prox is False or separable_prox is None:
        return (False,) * n
    if separable_prox != "auto":
        raise ValueError(
            f"separable_prox must be True, False or 'auto', "
            f"got {separable_prox!r}")

    def check(pj):
        if pj is None:
            return False
        kw = {}
        if isinstance(pj, functools.partial):
            kw = dict(pj.keywords)
            pj = pj.func
        pred = getattr(pj, "separable_when", None)
        return bool(pred(kw)) if pred is not None else False

    return tuple(check(pj) for pj in prox_in)


def grad_from_f(f, n_blocks):
    """The multi-block gradient ``grad(*X) -> (dX_0, ..., dX_{n-1})`` of the
    smooth function ``f(*X) -> scalar tensor`` by ``torch.autograd``: the
    solvers' ``grad=None`` mode.

    Each call differentiates detached views of the blocks, so the iterates
    never come to require a gradient and no graph outlives the call. A
    block that ``f`` does not use gets a zero gradient. The JAX package
    memoizes the derived function by ``(id(f), n_blocks)`` for its compiled
    driver cache; a host loop has no such cache, so every call builds a new
    (cheap) closure. Inside a ``torch.func`` transform (a solve under
    ``vmap``), where ``requires_grad_`` is refused, it takes
    ``torch.func.grad`` instead."""
    def grad(*X):
        if len(X) != n_blocks:
            raise ValueError(f"got {len(X)} blocks for a gradient of "
                             f"{n_blocks}")
        if torch._C._are_functorch_transforms_active():
            return torch.func.grad(f, argnums=tuple(range(n_blocks)))(*X)
        Xd = tuple(x.detach().requires_grad_(True) for x in X)
        with torch.enable_grad():
            val = f(*Xd)
        return torch.autograd.grad(val, Xd, allow_unused=True,
                                   materialize_grads=True)

    return grad


def tree_structure(tree):
    """The nesting of ``tree`` with every leaf replaced by ``"*"``: tuples
    and lists (told apart) and dicts (by key) are containers, None stays
    None, everything else is a leaf."""
    if isinstance(tree, (tuple, list)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return (kind, *(tree_structure(t) for t in tree))
    if isinstance(tree, dict):
        return ("dict", *((k, tree_structure(tree[k])) for k in sorted(tree)))
    return None if tree is None else "*"


def check_stepper_state(carried, fresh):
    """Raise ``ValueError`` unless a resumed ``stepper_state`` has the
    structure of the state this solve's stepper starts from (a state of
    another step configuration would be misread, not resumed)."""
    if tree_structure(carried) != tree_structure(fresh):
        raise ValueError(
            "state= was produced under a different step configuration "
            "(stepper state structure mismatch); resume with the same "
            "step arguments")


# ---------------------------------------------------------------------------
# The lanes controller: a solve under ``torch.func.vmap``.
#
# A host loop ends by reading its stop flags, and ``vmap`` refuses the
# ``bool()`` of a batched tensor. Under ``vmap`` the loops therefore read
# every lane's flags at once through functorch's own unwrapping
# (``torch._C._functorch``, a private interface: the card tests pin it on the
# chip machine's torch) and run while any lane is active, freezing the
# finished lanes with ``torch.where`` as ``lax.while_loop`` does under
# ``jax.vmap``. Every lane's iterate, iteration count and flags are then
# those of its own solve.

def under_vmap():
    """True inside a ``torch.func.vmap`` (at any level of the transform
    stack)."""
    stack = torch._C._functorch.get_interpreter_stack()
    vmap = torch._C._functorch.TransformType.Vmap
    return bool(stack) and any(i.key() == vmap for i in stack)


def any_lane(flag):
    """Whether ``flag`` holds in any lane: one blocking read of all the
    lanes' values, under ``vmap`` or outside it."""
    F = torch._C._functorch
    while F.is_batchedtensor(flag) or F.is_gradtrackingtensor(flag):
        flag = F.get_unwrapped(flag)
    return bool(flag.any())


def select_lanes(active, new, old):
    """``new`` where ``active`` holds, else ``old``, over nested tuples,
    lists and dicts of tensors; a leaf that is not a tensor (a host clock,
    the same in every active lane) takes ``new``."""
    if isinstance(new, (tuple, list)):
        return type(new)(select_lanes(active, n, o) for n, o in zip(new, old))
    if isinstance(new, dict):
        return {k: select_lanes(active, v, old[k]) for k, v in new.items()}
    if isinstance(new, torch.Tensor) and isinstance(old, torch.Tensor):
        return torch.where(active, new, old)
    return new


def run_lanes(st, step, stopped, max_iter, device):
    """The lanes controller over a solver body: ``step(st, it, active)``
    updates the dict ``st`` in place by one iteration (``it`` is the host
    clock, every active lane's own; ``active`` the lanes still running, a
    0-d bool per lane, so that an inner loop of the body, backtracking's
    halvings or AdaProx's prox sub-iterations, runs no round for a frozen
    one), ``stopped(st)`` is a lane's 0-d stop flag. Runs while any lane is
    active, at most ``max_iter`` iterations, one blocking read per
    iteration; a finished lane keeps its state. Returns the iteration
    counts, a 0-d int32 tensor per lane."""
    it = torch.zeros((), dtype=torch.int32, device=device)
    active = None
    for k in range(int(max_iter)):
        old = dict(st)
        step(st, k, torch.ones((), dtype=torch.bool, device=device)
             if active is None else active)
        if active is None:
            it = it + 1
        else:
            for key, value in st.items():
                st[key] = select_lanes(active, value, old[key])
            it = it + active.to(torch.int32)
        # a frozen lane's state is a stopped one, so it stays inactive
        active = torch.logical_not(stopped(st))
        if not any_lane(active):
            break
    return it
