"""Multi-card execution over ``torch.distributed``: mesh construction,
problem sharding, and the explicitly-collective NMF solves.

Counterpart of :mod:`proxmin_tpu.parallel`. The scale axis of this problem
is the pixel axis N of the data matrix Y (C x N): it shards across the
``data`` axis of a ``DeviceMesh``, one process per card. The small A factor
(C x K) replicates, or shards its channel axis over an optional ``model``
axis; the per-factor gradient reductions are all-reduces of C x K and
K x K values. ``hlo_collectives`` reads XLA's HLO and has no counterpart:
the port's tests count the ``torch.distributed.all_reduce`` calls instead.
"""

from .sharding import (  # noqa: F401
    make_mesh,
    shard_nmf_problem,
    make_nmf_pgm_step,
    nmf_adaprox_sharded,
    nmf_pgm_sharded,
    prox_unity_sharded,
)
from .distributed import (  # noqa: F401
    DistributedInfo,
    initialize_distributed,
)

__all__ = [
    "make_mesh",
    "shard_nmf_problem",
    "make_nmf_pgm_step",
    "nmf_adaprox_sharded",
    "nmf_pgm_sharded",
    "prox_unity_sharded",
    "initialize_distributed",
    "DistributedInfo",
]
