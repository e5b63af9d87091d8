"""Multi-process bring-up over ``torch.distributed``.

Counterpart of :mod:`proxmin_tpu.parallel.distributed`. PyTorch runs one
process per card: every process joins one process group, and
:func:`~proxmin_tpu_torch.parallel.make_mesh` lays the group's ranks out as
a ``DeviceMesh``. :func:`initialize_distributed` makes that bring-up
idempotent, so library code and user scripts can call it unconditionally.
:func:`run_ranks` starts a group of its own on this host, one process per
rank, and runs a function on every rank.
"""

import glob
import os
import pickle
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "DistributedInfo", "run_ranks"]

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


def run_ranks(fn, n, args=(), backend="gloo", timeout=600):
    """Run ``fn(rank, n, work, *args)`` on every rank of a new ``n``-rank
    process group and return rank 0's return value.

    The ranks join through a file store in a temporary directory ``work``,
    which they share and which is removed afterwards, so no port is opened.
    With ``backend="nccl"`` rank r runs on card r; on ``gloo`` each rank
    process keeps one thread. ``fn`` and ``args`` must pickle: every rank is
    a process of its own (``torch.multiprocessing.spawn``), except that a
    one-rank group runs in this process when it holds no group yet. A rank
    that fails raises here and stops the others; ranks still running after
    ``timeout`` seconds are stopped and raise ``TimeoutError``."""
    import torch.multiprocessing as mp

    n = int(n)
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    with tempfile.TemporaryDirectory(prefix="proxmin_ranks_") as work:
        if n == 1 and not dist.is_initialized():
            return _in_group(0, fn, 1, work, args, backend)
        ctx = mp.spawn(_spawned_rank, args=(fn, n, work, args, backend),
                       nprocs=n, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    for proc in ctx.processes:
                        proc.kill()
                    raise TimeoutError(f"run_ranks: the {n} ranks ran past "
                                       f"{timeout} s")
        except mp.ProcessRaisedException as exc:
            # the others fail in a collective after it: name the first
            failed = sorted(glob.glob(os.path.join(work, "failed-*.txt")))
            if not failed:
                raise
            with open(failed[0]) as fh:
                raise RuntimeError(
                    f"run_ranks: rank {failed[0].rsplit('-', 1)[1][:-4]} "
                    f"of {n} failed:\n{fh.read()}") from exc
        with open(os.path.join(work, "result.pkl"), "rb") as fh:
            return pickle.load(fh)


def _in_group(rank, fn, n, work, args, backend):
    """``fn`` on rank ``rank`` of the group of :func:`run_ranks`, which it
    joins and leaves."""
    initialize_distributed(f"file://{work}/store", n, rank,
                           local_device_ids=[rank], backend=backend)
    try:
        try:
            out = fn(rank, n, work, *args)
        except BaseException:
            with open(os.path.join(work, f"failed-{rank}.txt"), "w") as fh:
                fh.write(traceback.format_exc())
            raise
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def _spawned_rank(rank, fn, n, work, args, backend):
    if backend == "gloo":
        torch.set_num_threads(1)
    out = _in_group(rank, fn, n, work, args, backend)
    if rank == 0:
        with open(os.path.join(work, "result.pkl"), "wb") as fh:
            pickle.dump(out, fh)
