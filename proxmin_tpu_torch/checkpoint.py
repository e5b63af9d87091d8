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

A sharded solve (:mod:`proxmin_tpu_torch.parallel`, whose ``.x`` and
sharded carries are ``DTensor`` objects) is saved by every rank together, the
counterpart of the JAX package's orbax store: ``path`` is then a directory
in which ``torch.distributed.checkpoint`` writes each rank's shards, and
rank 0 the rest of the tree (the structure, host values and replicated
tensors) as ``structure.pt``. :func:`load_checkpoint` of such a directory,
called by every rank with the ``mesh`` of the continuation, gives each
``DTensor`` back laid out as it was saved.

A ``.pkl`` checkpoint of the JAX package holds a pickled JAX tree
definition and cannot be read without ``jax``: a JAX solve is continued
through :func:`proxmin_tpu_torch.interop.state_from_numpy`.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

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


def _encode(node, sharded=None):
    """The tree as the file holds it; with ``sharded`` (a dict), each
    ``DTensor`` leaf goes into it and a tag that describes it takes its
    place."""
    if isinstance(node, DTensor):
        if sharded is None:
            raise TypeError("a DTensor leaf is saved by save_checkpoint "
                            "into a directory (sharded=True)")
        key = f"leaf_{len(sharded)}"
        sharded[key] = node
        mesh = node.device_mesh
        return {_TAG: "dtensor", "key": key, "shape": list(node.shape),
                "dtype": str(node.dtype).removeprefix("torch."),
                "placements": [[p.dim] if isinstance(p, Shard) else []
                               for p in node.placements],
                "mesh_shape": list(mesh.shape),
                "mesh_dim_names": list(mesh.mesh_dim_names or ())}
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
        return {k: _encode(v, sharded) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_encode(v, sharded) for v in node)
    if isinstance(node, list):
        return [_encode(v, sharded) for v in node]
    if node is None:
        return None
    for base in (bool, int, float, str):
        # a subclass (a result's int-valued flag) is stored as its base
        if isinstance(node, base):
            return base(node)
    raise TypeError(f"cannot checkpoint a leaf of type {type(node).__name__}")


def _decode(node, device, sharded=None):
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, dict):
        tag = node.get(_TAG)
        if tag == "dtensor":
            return sharded[node["key"]]
        if tag == "ndarray":
            return node["data"].numpy().astype(node["dtype"], copy=False)
        if tag == "npscalar":
            return node["data"].numpy().astype(node["dtype"])[()]
        if tag == "dtype":
            return getattr(torch, node["name"])
        return {k: _decode(v, device, sharded) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_decode(v, device, sharded) for v in node)
    if isinstance(node, list):
        return [_decode(v, device, sharded) for v in node]
    return node


def _has_dtensor(node):
    if isinstance(node, DTensor):
        return True
    if isinstance(node, dict):
        return any(_has_dtensor(v) for v in node.values())
    if isinstance(node, (tuple, list)):
        return any(_has_dtensor(v) for v in node)
    return False


def _dtensor_tags(node):
    """Every ``dtensor`` tag of an encoded tree."""
    if isinstance(node, dict):
        if node.get(_TAG) == "dtensor":
            return [node]
        return [t for v in node.values() for t in _dtensor_tags(v)]
    if isinstance(node, (tuple, list)):
        return [t for v in node for t in _dtensor_tags(v)]
    return []


_STRUCTURE = "structure.pt"


def _save_sharded(path, state):
    """Every rank: its shards through ``torch.distributed.checkpoint``;
    rank 0: the rest of the tree. Returns when the directory is complete
    on every rank."""
    import torch.distributed.checkpoint as dcp

    sharded = {}
    tree = _encode(state, sharded)
    path = os.path.abspath(str(path))
    dcp.save(sharded, checkpoint_id=path)
    if dist.get_rank() == 0:
        torch.save({"format": _FORMAT, "tree": tree},
                   os.path.join(path, _STRUCTURE))
    # a fast rank must not load before rank 0's structure is written
    dist.barrier()
    return path


def _load_sharded(path, device, mesh):
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import zeros

    payload = torch.load(os.path.join(path, _STRUCTURE), map_location="cpu",
                         weights_only=True)
    if payload.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a proxmin_tpu_torch checkpoint")
    tags = _dtensor_tags(payload["tree"])
    if mesh is None:
        raise ValueError(f"{path} holds a sharded solve: pass the mesh= "
                         "that it continues on")
    if device is None:
        from .parallel.sharding import _local_device

        device = _local_device(mesh)
    sharded = {}
    for t in tags:
        if (list(mesh.shape) != t["mesh_shape"] or
                list(mesh.mesh_dim_names or ()) != t["mesh_dim_names"]):
            raise ValueError(
                f"{path} was saved on a mesh {t['mesh_dim_names']} of shape "
                f"{t['mesh_shape']}; this mesh is {mesh.mesh_dim_names} of "
                f"shape {list(mesh.shape)}")
        placements = [Shard(p[0]) if p else Replicate()
                      for p in t["placements"]]
        sharded[t["key"]] = zeros(*t["shape"], dtype=getattr(torch,
                                                             t["dtype"]),
                                  device_mesh=mesh, placements=placements)
    dcp.load(sharded, checkpoint_id=path)
    return _decode(payload["tree"], device, sharded)


def _with_suffix(path):
    path = str(path)
    return path if path.endswith(".pt") else path + ".pt"


def save_checkpoint(path, tree=None, **named):
    """Write a nest of solver state to ``path`` (``.pt`` appended if
    missing) and return the path written.

    Pass one ``tree`` (it comes back under the key ``"__tree__"``), keyword
    entries, or both; they form one dict. Tensors are copied to the CPU for
    the write, which waits for the card's stream. A tree with ``DTensor``
    leaves (a sharded solve) is saved into the directory ``path`` by every
    rank together."""
    state = dict(named)
    if tree is not None:
        state["__tree__"] = tree
    if _has_dtensor(state):
        return _save_sharded(path, state)
    path = _with_suffix(path)
    torch.save({"format": _FORMAT, "tree": _encode(state)}, path)
    return path


def load_checkpoint(path, device=None, mesh=None):
    """Read a file written by :func:`save_checkpoint` and return its dict
    with the exact structure that was saved. Tensor leaves go to ``device``
    (default: the CUDA device; without one, pass ``device="cpu"``); NumPy
    leaves and host values stay on the host.

    A sharded checkpoint (a directory) is loaded by every rank together:
    its ``DTensor`` leaves come back on ``mesh`` (of the saved shape and
    axis names) with their saved placements, every rank reading its own
    shards, and its other tensors on ``device`` (default: the mesh's)."""
    if os.path.isfile(os.path.join(str(path), _STRUCTURE)):
        return _load_sharded(str(path), device, mesh)
    device = default_device(device)
    payload = torch.load(_with_suffix(path), map_location="cpu",
                         weights_only=True)
    if not (isinstance(payload, dict) and payload.get("format") == _FORMAT):
        raise ValueError(f"{path} is not a proxmin_tpu_torch checkpoint")
    return _decode(payload["tree"], device)
