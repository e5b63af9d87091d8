"""Checkpoint / resume for solver state, through one file.

Counterpart of :mod:`proxmin_tpu.checkpoint`: every solver returns its
resumable state as ``.state``, a nest of dicts and tuples whose leaves are
tensors, NumPy arrays, host numbers, bools, strings and None, and accepts
it back as ``state=`` together with the iterates ``.x``.
:func:`save_checkpoint` writes any such nest to a file and
:func:`load_checkpoint` gives it back with its exact structure (tuples stay
tuples, ``()`` stays ``()``, strings, None, bools and host integers stay
what they were, NumPy leaves come back as NumPy arrays of their dtype,
bfloat16 tensors keep their dtype and bits), which is what the drivers'
resume checks compare. A killed solve continues from the file bit for bit::

    res = nmf(Y, A0, S0, max_iter=100, engine="cuda")
    save_checkpoint("solve", x=res.x, solver_state=res.state)
    ...
    ck = load_checkpoint("solve")
    res = nmf(Y, *ck["x"], max_iter=100, engine="cuda",
              state=ck["solver_state"])

The file layout: ``torch.save`` of nothing but tensors and plain Python
containers and scalars, so ``torch.load`` reads it under its
``weights_only=True`` default, which unpickles no arbitrary class. Tensors
are written from the CPU, so a file written on the card loads on a machine
without one. The leaves that this loader would refuse or lose are tagged
and restored: NumPy arrays and NumPy scalars (stored as tensors with their
dtype's name) and ``torch.dtype`` objects (by name).

The JAX package's orbax store and its multi-process save have no
counterpart here. A ``.pkl`` checkpoint of the JAX package holds a pickled
JAX tree definition and cannot be read without ``jax``: a JAX solve is
continued through :func:`proxmin_tpu_torch.interop.state_from_numpy`.
"""

import numpy as np
import torch

from .solvers.common import default_device

__all__ = ["save_checkpoint", "load_checkpoint"]

_FORMAT = "proxmin_tpu_torch.checkpoint/1"
# the key that marks a tagged leaf; a dict of the saved tree may not use it
_TAG = "__proxmin_leaf__"


def _host_tensor(t):
    """``t`` on the CPU, detached, with storage of its own size: a view
    would drag its whole base into the file."""
    t = t.detach().cpu()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone()
    return t


def _encode(node):
    if isinstance(node, torch.Tensor):
        return _host_tensor(node)
    if isinstance(node, (np.ndarray, np.generic)):
        a = np.asarray(node)
        if a.dtype.kind not in "biuf":
            raise TypeError(f"cannot checkpoint a NumPy leaf of dtype "
                            f"{a.dtype}")
        kind = "ndarray" if isinstance(node, np.ndarray) else "npscalar"
        return {_TAG: kind, "dtype": a.dtype.name,
                "data": torch.from_numpy(np.array(a, order="C"))}
    if isinstance(node, torch.dtype):
        return {_TAG: "dtype", "name": str(node).removeprefix("torch.")}
    if isinstance(node, dict):
        if _TAG in node:
            raise ValueError(f"a checkpointed dict may not use the key "
                             f"{_TAG!r}")
        return {k: _encode(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_encode(v) for v in node)
    if isinstance(node, list):
        return [_encode(v) for v in node]
    if node is None:
        return None
    for base in (bool, int, float, str):
        # a subclass (a result's int-valued flag) is stored as its base
        if isinstance(node, base):
            return base(node)
    raise TypeError(f"cannot checkpoint a leaf of type {type(node).__name__}")


def _decode(node, device):
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, dict):
        tag = node.get(_TAG)
        if tag == "ndarray":
            return node["data"].numpy().astype(node["dtype"], copy=False)
        if tag == "npscalar":
            return node["data"].numpy().astype(node["dtype"])[()]
        if tag == "dtype":
            return getattr(torch, node["name"])
        return {k: _decode(v, device) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_decode(v, device) for v in node)
    if isinstance(node, list):
        return [_decode(v, device) for v in node]
    return node


def _with_suffix(path):
    path = str(path)
    return path if path.endswith(".pt") else path + ".pt"


def save_checkpoint(path, tree=None, **named):
    """Write a nest of solver state to ``path`` (``.pt`` appended if
    missing) and return the path written.

    Pass one ``tree`` (it comes back under the key ``"__tree__"``), keyword
    entries, or both; they form one dict. Tensors are copied to the CPU for
    the write, which waits for the card's stream."""
    state = dict(named)
    if tree is not None:
        state["__tree__"] = tree
    path = _with_suffix(path)
    torch.save({"format": _FORMAT, "tree": _encode(state)}, path)
    return path


def load_checkpoint(path, device=None):
    """Read a file written by :func:`save_checkpoint` and return its dict
    with the exact structure that was saved. Tensor leaves go to ``device``
    (default: the CUDA device; without one, pass ``device="cpu"``); NumPy
    leaves and host values stay on the host."""
    device = default_device(device)
    payload = torch.load(_with_suffix(path), map_location="cpu",
                         weights_only=True)
    if not (isinstance(payload, dict) and payload.get("format") == _FORMAT):
        raise ValueError(f"{path} is not a proxmin_tpu_torch checkpoint")
    return _decode(payload["tree"], device)
