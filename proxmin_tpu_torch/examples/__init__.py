"""The eleven examples of ``examples/``, on the port.

Each JAX script ``examples/<name>.py`` has its twin here, a module of the
same name run as ``python -m proxmin_tpu_torch.examples.<name> [args]``
with the script's positional arguments and defaults. Each runs on the CUDA
device unless ``--cpu`` is given, and raises without a card and without
``--cpu``: it never carries on on the CPU by itself. Each has a ``main``
that returns the numbers it prints as a dict, keeps the JAX script's checks
as assertions and prints the lines the script prints. ``--plot`` imports
matplotlib only when it is given.

==========================  ====================================  ==========================
module                      what it runs on the port              where it runs
==========================  ====================================  ==========================
``parabola``                ``pgm`` (plain, FISTA, backtracking),  one card or the CPU
                            ``adaprox`` (six schemes), ``admm``,
                            ``sdmm`` on a 2-vector; no kernel
``tv_denoise``              ``admm`` with a ``FunctionOperator``   one card or the CPU
                            (``norm_sq=4.0``); no kernel
``image_tv``                ``sdmm`` with two                      one card or the CPU
                            ``FunctionOperator`` s; no kernel
``unmixing``                ``nmf`` PGM (the torch engine) and     one card or the CPU
                            AdaProx with prox sub-iterations;
                            no kernel
``astro_unmixing``          weighted ``nmf``: PGM strided and      one card or the CPU
                            adaptive, AdaProx; the torch engine,
                            its ``prox_S`` over the whole S (JAX's
                            ``engine="xla"``); no kernel
``batched_solves``          ``torch.func.vmap`` over               one card or the CPU
                            ``functional.make_pgm_solver`` (the
                            lanes controller); no kernel
``learn_regularizer``       ``torch.autograd`` through             one card or the CPU
                            ``make_differentiable_pgm_solver``'s
                            implicit gradient; no kernel
``fused_adam_unmixing``     ``nmf(engine="cuda")`` with bfloat16   one card (K2); on the CPU
                            moments and the M/V warm start: K2     K2's plain version
                            (``csrc/nmf_adaprox_step.cu``)
``sharded_unmixing``        ``parallel``: the auto-SPMD route      one NCCL rank per card;
                            (``shard_nmf_problem`` + ``nmf`` on    ``--cpu``: ``--ranks R``
                            ``DTensor`` s), ``nmf_pgm_sharded``,   gloo ranks (default 2)
                            and one device; no kernel
``preemptible_resume``      weighted adaptive ``nmf(mesh=)`` in    as ``sharded_unmixing``
                            slices through sharded checkpoints;
                            no kernel
``pod_serving``             ``export_nmf_pgm_sharded`` fresh and   as ``sharded_unmixing``
                            ``resume=True`` per rank, served by
                            ``load_exported``; no kernel
==========================  ====================================  ==========================

"No kernel" means that the engines the example takes route to no
hand-written kernel: the torch engine (cuBLAS products and elementwise
operations), the ADMM family and the sharded paths. ``chip_smoke.py``'s
phase 19 runs all eleven on the card at their default arguments and reads
every kernel wrapper's count in each: K2 300 times in
``fused_adam_unmixing``'s 300 ``engine="cuda"`` iterations, no kernel in
the other ten (NVIDIA H100 80GB HBM3, 700 W).

What differs from the JAX scripts: ``engine="pallas"`` is ``engine="cuda"``;
``jax.jit(jax.vmap(...))`` is ``torch.func.vmap`` (eager, no compile);
``jax.grad`` is ``torch.autograd``; the virtual 8-device mesh is a process
group, one NCCL rank per card on the card and gloo ranks on the CPU, which
the sharded scripts start themselves (``parallel.distributed.run_ranks``);
``pod_serving`` serves its programs through ``load_exported``, so the
serving process imports the port (its per-rank layout and its process
groups), where JAX's imports JAX alone.
"""

import contextlib
import io

import torch

__all__ = ["NAMES", "example_device", "positional", "ranks_option",
           "sharded_main"]

NAMES = ("parabola", "tv_denoise", "image_tv", "unmixing", "astro_unmixing",
         "batched_solves", "learn_regularizer", "fused_adam_unmixing",
         "sharded_unmixing", "preemptible_resume", "pod_serving")


def example_device(cpu=False):
    """The device an example runs on: the CPU with ``cpu``, else the
    current CUDA device; without one it raises."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "this example runs on the CUDA device and there is none; pass "
            "--cpu to run it on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def positional(argv):
    """The arguments that are neither ``--`` options nor the value of
    ``--ranks``."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--ranks":
            skip = True
        elif not a.startswith("--"):
            out.append(a)
    return out


def ranks_option(argv):
    """The value of ``--ranks R`` as an int, or None."""
    return int(argv[argv.index("--ranks") + 1]) if "--ranks" in argv else None


def sharded_main(rank_main, args=(), cpu=False, ranks=None):
    """The ``main`` of a sharded example: ``rank_main(args, device, work)``
    on every rank of a new process group
    (``parallel.distributed.run_ranks``), ``ranks`` gloo ranks with
    ``cpu`` (default 2), else one NCCL rank per card; a one-rank group
    runs in this process. Prints what rank 0 printed and
    returns the dict rank 0's ``rank_main`` returned. A rank that fails
    raises. Without a card and without ``cpu`` it raises before starting
    any rank."""
    from ..parallel.distributed import run_ranks

    example_device(cpu)
    if ranks is None:
        ranks = 2 if cpu else torch.cuda.device_count()
    out, text = run_ranks(_example_rank, ranks, (rank_main, list(args), cpu),
                          backend="gloo" if cpu else "nccl", timeout=1200)
    print(text, end="")
    return out


def _example_rank(rank, n, work, rank_main, args, cpu):
    """One rank of :func:`sharded_main`: ``rank_main``'s dict and what it
    printed."""
    with contextlib.redirect_stdout(io.StringIO()) as text:
        out = rank_main(args, example_device(cpu), work)
    return out, text.getvalue()
