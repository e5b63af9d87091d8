"""Multi-process bring-up over ``torch.distributed``.

Counterpart of :mod:`proxmin_tpu.parallel.distributed`. PyTorch runs one
process per card: every process joins one process group, and
:func:`~proxmin_tpu_torch.parallel.make_mesh` lays the group's ranks out as
a ``DeviceMesh``. :func:`initialize_distributed` makes that bring-up
idempotent, so library code and user scripts can call it unconditionally.
"""

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "DistributedInfo"]

# torchrun's variables: a process started by it is configured without
# arguments
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


class DistributedInfo(NamedTuple):
    """Summary of the process's place in the global runtime."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int


def _info():
    if not dist.is_initialized():
        return DistributedInfo(0, 1, 1, 1)
    world = dist.get_world_size()
    # one card (or one CPU device) per process
    return DistributedInfo(dist.get_rank(), world, 1, world)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None,
                           backend=None):
    """Join the process group (idempotent).

    Pass ``coordinator_address`` (``"host:port"`` of rank 0, which becomes
    ``tcp://host:port``, or a whole ``init_method`` URL such as
    ``file:///path/store``), ``num_processes`` and this process's
    ``process_id``; or start the processes with ``torchrun``, whose
    ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` variables configure the group
    with no arguments. ``local_device_ids[0]`` is the card this process
    uses (default: ``LOCAL_RANK``, else 0).

    The backend is ``nccl`` when the process holds a card and ``gloo`` on
    the CPU; ``backend=`` chooses another (``"gloo"`` with CUDA tensors
    reduces through the host). Asking for ``nccl`` without a card raises.

    Safe to call when the group is up already, and a no-op when nothing is
    configured (no arguments and no launcher variables): a single process,
    whose mesh :func:`~proxmin_tpu_torch.parallel.make_mesh` makes on its
    own. A configured bring-up that fails raises: swallowing it would
    degrade a multi-card job to per-process solves with no error anywhere.

    Returns:
        :class:`DistributedInfo` with the process index/count and device
        counts.
    """
    if dist.is_initialized():
        return _info()
    from_env = all(v in os.environ for v in _LAUNCHER_ENV)
    if coordinator_address is None and not from_env:
        return _info()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device and "
                               "there is none; pass backend=\"gloo\" to "
                               "run on the CPU")
        if local_device_ids is not None:
            card = int(list(local_device_ids)[0])
        else:
            card = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(card)
    if coordinator_address is None:
        kwargs = {"init_method": "env://"}
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        url = str(coordinator_address)
        kwargs = {"init_method": url if "://" in url else "tcp://" + url,
                  "world_size": int(num_processes),
                  "rank": int(process_id)}
    if backend == "nccl":
        # bound to its card: collectives and barriers need not guess it
        kwargs["device_id"] = torch.device("cuda", card)
    try:
        dist.init_process_group(backend, **kwargs)
    except (ValueError, RuntimeError):
        # a raced initialization that another call won is the one benign
        # case; every other failure of a configured bring-up re-raises
        if not dist.is_initialized():
            raise
    return _info()
