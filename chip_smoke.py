#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It drives the port's main paths on the flagship problem (C=5 channels,
K=7 components, N=1e6 pixels, float32, data made from seed 101 as in
bench.py, W in [0.5, 1.5) for the weighted problem): PGM-NMF (exact,
weighted and strided, with the bfloat16 store) and AdaProx-NMF through
``proxmin_tpu_torch.nmf.nmf``, the ``proxmin_tpu_torch.ops`` entry point
the way its users drive it (the prox kernels inside
``AlternatingProjections`` as ``nmf``'s S constraint, ``fused_nmf_grad`` as
``pgm``'s gradient), and the stream-merge experiment's loops on K5; then
the ADMM family: ``admm`` and ``sdmm`` on the total-variation denoising
problem of
benchmarks/admm_scale.py (seed 11, 1024 x 1024 and 4096 x 4096 pixels,
float32), with K4's soft threshold as ``sdmm``'s ``prox_g``, and
``nmf(algorithm="bsdmm")`` on the flagship; then the drivers' options
(callbacks, traces, backtracking, autodiff gradients, Barzilai-Borwein
steps) and checkpoint/resume of six solves through a file; then the
functional factories: batched patch NMF under ``torch.func.vmap`` and
implicit gradients; then whole solves exported with ``torch.export`` and
served from a fresh process; then the wide, sharded, routing and very-wide
paths; and last the eleven examples of ``proxmin_tpu_torch.examples``. It
exits non-zero when any phase fails.
Phases:

1. probe: CUDA/driver/compiler versions, the card and its power limit;
2. build K1, K2 (with K5), K3 and K4 from proxmin_tpu_torch/csrc/ with
   nvcc, all at once, print ptxas's registers and spills for every kernel
   instance, and fail if an instance of the ring kernels (K1, K2, K3)
   spills;
3. K1 against its plain PyTorch version at the flagship shape, with W, at
   a ragged shape and in the C <= 16 instance, in float32 and with the
   bfloat16 store, plus its times beside the plain version's;
4. K2 against its plain version at the flagship with float32 and with
   bfloat16 moments, with W, at a ragged shape and with the identity prox,
   plus its times beside the plain version's; K2 with the bfloat16 store
   (S, Y, W) at the flagship, with W and ragged, with both moment types,
   timed beside the float32 store; K5 (packed_step, smv and mv)
   against its plain version and against K2 on the same inputs, its times
   beside K2's, and the stream-merge loops (K2 and K5, 200 iterations
   each, launch-counted, packed equal to base bit for bit);
5. K3 (fused_nmf_grad) against its plain version at the flagship, with W,
   at a ragged shape and in the C <= 16 instance, plus its times beside the
   plain version's;
6. K4 (prox_plus/soft/hard/unity_pallas) against their plain versions on
   an S-shaped (7, 1e6) tensor in float32 and float64 and at odd shapes,
   with relative and absolute thresholds from a step on the card (no host
   sync), NaN, unity along both axes, plus their times, the CUDA kernels
   of one call by the profiler (one in every case) and each
   wrapper's host microseconds per call;
7. PGM: nmf(engine="cuda") and nmf(engine="torch") for 200 iterations:
   iterates agree, the loss decreases, every iteration launched K1 once,
   and a resumed run reproduces the straight run bit for bit; then the
   weighted (stride 10, and adaptive) and the unweighted adaptive solves on
   both engines the same way, the bfloat16 store against float32, and a
   weighted adaptive solve resumed in four pieces and at a refresh
   boundary;
8. AdaProx: nmf(algorithm="adaprox", engine="cuda") against
   engine="torch" with separable_prox="auto" at 50, 100 and 200
   iterations, with the same checks for K2, bfloat16 moments against
   float32 ones, the bfloat16 store (unweighted and weighted, both moment
   types) against the float32 store's loss with bit-exact resumes, and the
   default nmf(algorithm="adaprox") (torch engine, prox sub-iterations) for
   10 iterations;
9. the ops paths for 200 iterations, each against its plain-operator twin:
   sum-to-one abundances, L1- and L0-sparse sources (K4 inside
   AlternatingProjections as prox_S), and pgm with K3's gradient; each
   launched its kernels once per iteration;
10. marginal ms/iter of every engine and path (the weighted and strided
   ones too), and GB/s against the naive bytes; the adaptive refresh
   against the exact steps, the AdaProx bfloat16 store against the float32
   store and each packed loop against its base loop in turns;
11. the ADMM family: the batched-Lanczos weighted bound against the Gram
   route (with its launch count); TV ``admm`` (horizontal differences) and
   ``sdmm`` (both directions) at both sizes: finite results, ``sdmm`` lowers
   the RMSE against the truth, a resumed ``admm`` equals the straight one
   bit for bit, launches and blocking host reads per iteration, marginal
   ms/iter beside the naive bytes; the same ``sdmm`` with K4 soft as
   ``prox_g`` in turns with the plain operator (bit for bit equal, K4
   launched twice per iteration); ``nmf(algorithm="bsdmm")`` unweighted
   (against a Gauss-Seidel PGM loop written out by hand), with a sum-to-one
   constraint on S through ``bsdmm`` itself, and weighted with
   ``step_stride=10`` fixed and adaptive: the loss decreases, resumed
   sweeps equal straight ones bit for bit (across a refresh boundary too),
   launches and reads per sweep, marginal ms/sweep in turns with PGM;
12. the solvers' options and the checkpoint, at the flagship:
   ``nmf(engine="torch", callback=NullCallback())`` in turns with no
   callback (ms/iter, launches and blocking reads per iteration, which must
   not change), ``StopIteration`` at iteration 37, ``Traceback`` for 10
   iterations (ms/iter, the GB/s of its device-to-host copies, its last
   entry equal to ``.x`` bit for bit); ``pgm(trace=True)`` (the history's
   shape, its last row against the residual of the last two iterates, reads
   unchanged); backtracking from constant steps with A's 8 times the
   Lipschitz one, plain and FISTA (``T`` halves, the loss ends finite and
   below the start's, where the run without it diverges; launches and reads
   per iteration), and with both steps too long (printed); ``grad=None`` against the explicit gradient (50
   iterations, normwise, ms/iter in turns); Barzilai-Borwein steps of both
   types (the loss falls, 50 + 50 resumed equals 100 straight bit for bit);
   and for six solves (PGM cuda exact; weighted adaptive with the bfloat16
   store; AdaProx cuda with bfloat16 store and moments; FISTA with
   backtracking on the torch engine; ``sdmm`` TV 1024 x 1024 with K4 soft;
   bsdmm-NMF weighted adaptive): run 100 iterations, ``save_checkpoint`` to
   a file, drop every tensor, ``load_checkpoint`` onto the card, run 100
   more, equal to 200 straight ones bit for bit (the adaptive ones also
   split on a refresh boundary), with each file's size and its save and
   load seconds;
13. the functional factories (``proxmin_tpu_torch.functional``): each
   factory against its driver bit for bit after 200 iterations, with its
   kernels, launches and blocking reads per iteration and its marginal
   ms/iter in turns with the driver (``make_pgm_solver`` with K3's gradient
   at the flagship, ``make_admm_solver`` and ``make_sdmm_solver`` on the TV
   denoise at 1024 x 1024 with K4 soft as ``prox_g``, ``make_bsdmm_solver``
   with a sum-to-one S at the flagship); ``make_nmf_solver`` under
   ``torch.func.vmap`` on the flagship image cut into 250 patches of 4000
   pixels, unweighted and weighted: lanes 0 and 249 against their own
   solves after 200 iterations and to e_rel=1e-3, every lane's loss
   falling, the batch's ms/iter beside 10 seeded patches solved one by one
   (scaled to 250), in turns; and the implicit gradients of
   ``make_differentiable_pgm_solver`` (NNLS in S with a ridge, theta = Y, at
   the flagship) and ``make_differentiable_admm_solver`` (the TV penalty
   through ``prox_g`` at 1024 x 1024) against central differences, in
   float64; and the same 250 patches as lanes of their float64 S-step with
   A0 fixed under ``torch.func.vmap``: ``make_pgm_solver(backtracking=True)``
   from a step that splits the lanes' halving counts, ``make_adaprox_solver``
   with a sum-to-one S (the prox sub-iterations), and
   ``vmap(torch.func.grad)`` through ``make_differentiable_pgm_solver``'s
   NNLS on the first 50 patches, each with 10 (2 for the gradients) seeded
   lanes against their own solves (equal iteration counts), its blocking
   reads held to one per iteration plus one per inner round, and its
   rounds, launches and ms/iter beside the lanes one by one;
14. whole solves exported with ``torch.export``
   (``proxmin_tpu_torch.export``), K1-K4 running as registered ops: the
   fused PGM programs (exact, weighted stride 10, weighted adaptive, the
   bfloat16 store) and AdaProx programs (float32 and bfloat16 moments) at
   the flagship, exported, saved, loaded and served for 200 iterations by
   a fresh process that imports torch and ``proxmin_tpu_torch.ops`` only,
   each equal to its driver bit for bit; a weighted stride-10 chain of 10
   iterations and a ``resume=True`` program for 15 equal to the straight
   25; the TV ``admm`` and ``sdmm`` programs with K4 soft as ``prox_g`` at
   1024 x 1024 (250 iterations) and a ``pgm`` program with K3 as its
   gradient, each equal to its driver; for every program its export and
   load seconds and file MB, its marginal ms/iter in turns with its
   driver, its CUDA launches and blocking reads per iteration beside the
   driver's, and each registered op's host microseconds per call beside
   its wrapper's; and the bsdmm programs whose steps carry across sweeps
   (``EX_BSDMM``: the weighted ``nmf(algorithm="bsdmm", W=...)`` on the
   WeightedBSDMMStepper at stride 10, fixed and adaptive, the unweighted
   ``steps_f_stride=3`` and a ``steps_g_update="relative"`` sum-to-one S),
   each equal to its driver bit for bit after 25 sweeps, with its ms/sweep
   in turns with the driver;
15. the full-width path (``wide_phase``): C=128, K=32, N=1e6 and the
   prox modes on K1-K3's wide body (see its docstring);
16. the sharded path (``proxmin_tpu_torch.parallel``) on a one-rank NCCL
   group at the flagship: ``nmf(mesh=make_mesh())`` for exact PGM,
   weighted PGM at stride 10 and adaptive, and AdaProx, each against the
   single-card ``nmf(engine="torch")`` with equal iterations; a 1 x 1
   ``('data', 'model')`` mesh with ``model_axis``; resumes in two pieces
   (one through a sharded checkpoint) bit for bit; the exact solve on two
   gloo ranks on the same card against the one-rank result; each path's
   marginal ms/iter in turns with the torch engine, its all-reduce calls
   and elements per iteration and its device-to-host copies per iteration;
   the auto-SPMD routes (``auto_spmd_phase``: ``nmf(mesh=)`` with bsdmm
   weighted, AdaProx AMSGrad and PGM accelerated, the driver on DTensor
   shards, against the single-card driver; ``admm`` on the TV denoise with
   x sharded over columns against its plain solve), with their marginal
   ms/iter in turns and DTensor's collectives per iteration; the per-rank
   programs of ``export_nmf_pgm_sharded`` (weighted, stride 10,
   ``resume=True``: from a fresh start, from the live state and chained,
   against the straight solve) and ``export_nmf_adaprox_sharded`` (Adam)
   bit for bit against their live solves, with their ms/iter; and on the
   two gloo ranks ``nmf(mesh=, algorithm="bsdmm")`` against one rank and
   each rank's exact PGM program against its live solve;
17. ``nmf(engine="auto")`` (``routing_phase``): every path of the engine
   sweep (``ROUTE_PATHS``: PGM exact, stride 10, weighted stride 10,
   weighted adaptive, weighted with the bfloat16 store; AdaProx with
   float32 and bfloat16 moments) at the flagship and at full width
   (C=128, K=32, N=1e6, the simplex on S): auto's choice against the H100
   routing table, auto's solve equal to the chosen engine's bit for bit,
   the K1/K2 launches it made (some wherever it chose cuda), both engines'
   marginal ms/iter in turns; a gray-zone shape probed by the first auto
   solve and served from the calibration cache on the second; and at the
   table's boundaries 8 seeds of
   benchmarks/engine_equivalence.py's problem through both engines to
   e_rel 1e-4, held to its ACCEPTANCE bound;
18. the very-wide path (``very_wide_phase``): hyperspectral unmixing at
   AVIRIS-NG's width, C=425, K=32, N=1e6, a K > 32 check at
   (128, 64, 250 000), a K > 64 one at (128, 96, 4097) and a K > 128 one
   at (64, 160, 4097) on K1-K3's very-wide bodies, ``nmf(engine="auto")``
   on the four against the routing table's very-wide rows, and K5 beyond C,
   K <= 8 at (16, 12, 1e6) (see its docstring);
19. the eleven examples of ``proxmin_tpu_torch.examples``
   (``examples_phase``) at their default arguments, each in a process of
   its own, four at once, the sharded three on a one-rank NCCL group in
   that process: each exits 0 and prints its success lines, with its wall
   seconds and the kernels it launched; ``fused_adam_unmixing`` must
   launch K2 once an iteration of its two ``engine="cuda"`` segments, and
   K2 is held against its plain version at that example's own operands
   (N = 20 000, bfloat16 moments, the warm start from the returned M and
   V; ``example_k2_check``).

The last two lines are the card (``nvidia-smi`` name and power limit)
after a JSON object describing the kernels (each with its time, its plain
version's, the least time the card could take for its bytes or operations,
and a PyTorch library call's where one computes the same function), and
then the result object ``{"ok": true, "device": {...}}``. With no CUDA
device it fails at once.

``python3 chip_smoke.py --profile`` instead traces 50 iterations of each
PGM path, each AdaProx cuda path and each ADMM-family path with
``torch.profiler`` and prints the device's busy time, busy share, kernel
launches and device-to-host copies (the blocking reads) per iteration, and
on the PGM cuda paths K1's kernel and finalize time per iteration (traces
under ``build/profile/``).
"""

import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch

C, K, N = 5, 7, 1_000_000
SEED = 101
ITERS = 200
# K1, K2 vs their plain versions: max |kernel - plain| / max |plain| per
# output.
# Both are float32; they sum the pixel-axis reductions in other orders.
# |S' - S|^2 cancels (S' - S is small against S), so it gets more room.
STEP_RTOL = 2e-4
DS_RTOL = 1e-3
# The two engines after 200 iterations, normwise per factor: float32 sums
# in other orders (cuBLAS split-K vs the kernel's tree), compounded.
ENGINE_RTOL = 1e-3
# AdaProx separates the engines faster than PGM: where the S gradient is
# near zero (elements at the non-negativity bound), Phi/Psi = M/sqrt(V) is
# a ratio of two tiny EMAs, so last-bit differences in gS flip its sign and
# move such elements by a whole step alpha. On an H100 80GB HBM3 (700 W)
# the engines agree to 2.1e-4 at 100 iterations and 2.5e-3 at 200, so
# ENGINE_RTOL is checked at ADAPROX_AT iterations and the 200-iteration
# state at this looser bound.
ADAPROX_AT = 100
ADAPROX_RTOL_200 = 1e-2
# AdaProx: bfloat16 against float32 moments after 200 iterations, on S:
# the EMA roundings compound (test_pallas_ops.py holds the JAX engines to
# the same).
BF16_ATOL = 0.05
# K2's bfloat16 moment stores against the plain version's: one bfloat16 ulp
# (a one-ulp float32 difference may flip one rounding), plus this absolute
# slack where the EMA cancels to near zero (the float32 tests' atol).
BF16_STORE_ATOL = 1e-5
# AdaProx with K2's bfloat16 store (S, Y, W) against the float32 store: the
# JAX suite's rule l16 < max(3 l32, l32 + 1) (test_pallas_ops.py, there at
# 40 iterations of a noise-free problem) is held at this many iterations.
# By 200 the float32 store has fitted much of the data's noise (K = 7 > C =
# 5, so the factors can fit it; the noise alone weighs about 1e3), while the
# bfloat16 store's Adam steps, once smaller than half a bfloat16 ulp of S,
# round away: its loss levels off near the noise's. The JAX engine does the
# same (tests/test_torch_nmf_adaprox.py); at 200 iterations the bfloat16
# store's loss is held below its own at this horizon.
BF16_RULE_AT = 100
# iteration counts for the marginal ms/iter (50 and 250 until the script
# gained phase 18, then 30 and 150 until the very-wide tier's instances
# lengthened the build: cut to keep the whole run inside its time limit)
LO, HI = 30, 120
# Phases 13, 14, 16 and 17 take their in-turn marginals (the two paths
# timed alternately, twice each) between TURN_LO and TURN_HI iterations,
# one run per count (turn_ms): the turns give each path two estimates (cut
# from LO, HI and two runs per count to keep the run inside its time limit
# as phase 16 grew). Their launch, read and collective counts per
# iteration are taken between COUNT_LO and COUNT_HI iterations.
TURN_LO, TURN_HI = 5, 25
COUNT_LO, COUNT_HI = 5, 25
# K4 against its plain version: plus, soft and hard bitwise (one comparison
# or a few separately rounded operations per element, the same in both);
# unity elementwise relative, since its sums are taken in another order.
UNITY_RTOL = {torch.float32: 1e-6, torch.float64: 1e-14}
ODD_SHAPES = ((1, 7), (5, 129), (13, 1000), (8, 128))
# After the sum-to-one path every column of S sums to 1 (float32).
UNITY_SUM_ATOL = 1e-5
# The sparse paths' thresholds, relative (in units of the S step).
L1_THRESH = 0.5
L0_THRESH = 0.5
# The sum-to-one path is discontinuous where a column of S has few positive
# entries: the rescaling divides by their sum, so a last-bit difference in
# the column sums (the kernel sums in another order than torch.sum) that
# moves an element across 0 moves its column by a visible amount. Its
# agreement is held normwise (ENGINE_RTOL); its largest elementwise
# difference only to this bound. On the CPU, reversing the order of the
# float32 column sums alone moves S by 2.0e-3 elementwise and 1.4e-5
# normwise after 200 iterations at N=1e5.
UNITY_PATH_MAXABS = 1e-2
# About 50 ms at the H100's clocks: longer than the host takes to enqueue
# 20 calls of any timed function here.
QUEUE_AHEAD_CYCLES = 100_000_000
DEVICE = torch.device("cuda", 0)
# The card's peaks for the bound (NVIDIA H100 SXM data sheet, at 700 W):
# HBM bytes/s, and float32 operations/s outside the tensor cores (no kernel
# here uses them).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# bench.py's weighted flagship refreshes its steps every 10 iterations.
STRIDE = 10
# The C <= 16 instances of K1 and K3 (two blocks per SM) are checked at
# C=16, K=8 on this many pixels.
N_WIDE = 200_000
# The fused kernels (the ring bodies, the wide and the very-wide body):
# ptxas must report no spill stores for any of their instances.
RING_KERNELS = ("pgm_step_kernel", "adaprox_step_kernel", "nmf_grad_kernel",
                "pgm_chain_kernel", "pgm_wide_kernel", "adaprox_wide_kernel",
                "nmf_grad_wide_kernel", "pgm_vwide_kernel",
                "adaprox_vwide_kernel", "nmf_grad_vwide_kernel",
                "pgm_kwide_kernel", "adaprox_kwide_kernel",
                "nmf_grad_kwide_kernel")


# The TV denoising problem of benchmarks/admm_scale.py: its seed, penalty
# and prox step; each size with the iteration counts of its marginal.
TV_SEED, TV_LAM, TV_STEP_F = 11, 0.4, 0.5
TV_SIZES = ((1024, 200, 1000), (4096, 50, 150))
# Beyond C K K = 2**20 the weighted A bound runs batched Lanczos, checked
# against the Gram route at two (C, K, N): with C within the 256 candidates
# every member is bisected and the bound is exact up to the bisection's last
# ulps (the 16 pixels bound the rank below the 34 steps); with more members
# than candidates the smallest candidate's Gershgorin bound may stand in, a
# safe overestimate, held to this factor.
LANCZOS_CASES = ((256, 65, 16), (20000, 8, 64))
LANCZOS_RTOL = 1e-4
LANCZOS_OVER = 1.5
# The solvers' options (phase 12). Backtracking starts from a step of A this
# many times the Lipschitz one and runs this many iterations; a callback stops
# a solve at STOP_AT; Traceback records this many iterations; trace= and the
# Barzilai-Borwein steps run TRACE_ITERS and BB_ITERS iterations.
BT_FACTOR, BT_ITERS = 8, 100
STOP_AT = 37
TRACEBACK_ITERS = 10
TRACE_ITERS = 30
BB_ITERS = 100
# pgm(trace=True)'s last row against the residual recomputed from the last
# two iterates: the same reductions of the same tensors.
TRACE_RTOL = 1e-5
# grad=None (autograd of log_likelihood) against grad_likelihood after
# GRAD_NONE_ITERS iterations, normwise per factor: the same products, with
# the factor 2 / 2 of the square's derivative (exact) in another place.
GRAD_NONE_ITERS, GRAD_NONE_RTOL = 50, 1e-5
GRAD_NONE_LO, GRAD_NONE_HI = 20, 70
# The functional factories (phase 13). The flagship image cut into
# FN_PATCHES patches of FN_PATCH_N pixels for the batched NMF; its
# individual solves are timed on FN_SAMPLE seeded patches and scaled to all;
# marginals between FN_LO and FN_HI iterations; the batched run to e_rel
# FN_E_REL stops at FN_MAX_ITER at the latest.
FN_PATCHES, FN_PATCH_N, FN_SAMPLE = 250, 4000, 10
FN_LO, FN_HI = 10, 30
FN_E_REL, FN_MAX_ITER = 1e-3, 500
# the TV denoise of the factories and of the TV implicit gradient
FN_TV_H = 1024
# The implicit gradients in float64: non-negative least squares in S with
# A0 fixed and a ridge IFT_MU (the map contracts), theta = Y, against a
# central difference of step IFT_EPS along a seeded unit direction; and the
# 1024 x 1024 TV denoise with its penalty learned through prox_g, against a
# central difference of step IFT_TV_EPS. The adjoint needs more iterations
# than the forward pass: at the factories' default cap (vjp_iters=10,000)
# it stops short (1.3e-5 off at N = 4000 on the CPU, 5e-9 with the cap
# lifted), so both run to IFT_MAX_ITER. The NNLS solution is only piecewise
# smooth in Y: where the difference's two solves straddle a change of the
# active set, it averages two slopes while the implicit gradient takes the
# one at Y. Along a random direction at N = 1e6 the two differed by
# 2.39e-3, unchanged by e_rel 1e-11 or 1e-13 and by the adjoint's cap (an
# H100 80GB HBM3 at 700 W): a few of the 7e6 components crossed. A pixel's
# solution depends on its own column of Y only, so the direction is zero
# on the pixels whose active set lies within IFT_MARGIN of changing (a
# component of S* in (0, IFT_MARGIN), or a zero one whose gradient is
# below it): their solutions stay put, and the others move by about the
# direction's 4.5e-7 per element, far inside the margin. On the CPU at
# N = 4000 and at 128 x 128 the differences agree to 2.7e-9 and 3.4e-8.
# The solves run to e_rel 1e-11 (1e-13 until the run needed the time: the
# difference above did not change between the two).
IFT_MU, IFT_E_REL, IFT_EPS, IFT_RTOL = 1e-2, 1e-11, 1e-3, 1e-4
IFT_MARGIN = 1e-3
IFT_TV_E_REL, IFT_TV_EPS, IFT_TV_RTOL = 1e-10, 1e-4, 1e-4
IFT_MAX_ITER = 100_000
# The lanes' inner loops and the implicit gradients under torch.func (phase
# 13, after the batched NMF): the FN_PATCHES patches as lanes of their S-step
# with A0 fixed, f = 0.5 ||Y_p - A0 S||^2, in float64. A batched product
# sums in another order than a lane's own; in float32 that can decide a
# halving, a sub-iteration or a stop near its threshold, and the checks
# want each sampled lane's iteration count equal to its own solve's.
# (a) Backtracking with prox_plus from a step 2^FN_BT_HALVINGS times the
# middle of the lanes' first-test thresholds (bisected FN_BT_BISECT times in
# log step), so that the lanes above the middle need FN_BT_HALVINGS
# halvings and the others one more; (b) AdaProx (Adam) with a sum-to-one S
# (prox_unity_plus over K), whose prox runs the sub-iterations (at most
# FN_ADA_SUB a call), from step FN_ADA_STEP; both to e_rel FN_E_REL, at most
# FN_LANES_MAX_ITER iterations. (c) torch.func.vmap(torch.func.grad) of
# <w_p, S*_p> through the NNLS with the ridge IFT_MU, theta = Y_p, to
# FN_IFT_E_REL forward and adjoint, on the first FN_IFT_PATCHES patches,
# against FN_IFT_SAMPLE seeded lanes' own torch.autograd.grad. The cut:
# with all 250 patches and e_rel 1e-9 the batch took 15 095 rounds of
# 3.05 ms (46 s, an H100 80GB HBM3 at 700 W), each own lane 6 s. Two runs
# that stop one iteration apart differ by about one step, e_rel of the
# iterate: FN_IFT_RTOL.
FN_BT_HALVINGS, FN_BT_BISECT = 3, 100
FN_ADA_STEP, FN_ADA_SUB = 1e-2, 100
FN_LANES_MAX_ITER = 1000
FN_IFT_PATCHES, FN_IFT_E_REL, FN_IFT_SAMPLE, FN_IFT_RTOL = 50, 1e-7, 2, 1e-6

# The full-width path (phase 15): the widest configuration of the JAX
# package's engine sweep, C=128 channels and K=32 components
# (benchmarks/engine_scaling.py:170), at the flagship's pixel count, with
# abundances on the simplex, solved as fully constrained unmixing (prox_A
# non-negativity, prox_S the simplex over K); beside it the sweep's
# (64, 16, 250_000) (engine_scaling.py:169). Solves run WIDE_ITERS
# iterations and resume after WIDE_SPLIT; marginals between WIDE_LO and
# WIDE_HI iterations.
WIDE = (128, 32, 1_000_000)
WIDE_SWEEP = (64, 16, 250_000)
WIDE_ITERS, WIDE_SPLIT = 30, 10
WIDE_LO, WIDE_HI = 5, 25
# The noise on Y and AdaProx's relative L1 threshold on S.
WIDE_NOISE, WIDE_L1 = 0.01, 1e-3
# The compiled simplex chain against the same prox as a closure on the
# split path: both compute x / sum_k max(x, 0) per column, the kernel
# summing over k in order and torch.sum in its own order, so S' differs in
# the last float32 bits of each column's sum (relative, max abs over max).
CHAIN_SPLIT_RTOL = 1e-5
# General chains at the flagship's C and K: the simplex on S (PGM, K1's
# narrow instance) and the relative L1 threshold (AdaProx, K2's wide body).
CHAIN_ITERS = 20


# The routing path (phase 17): nmf(engine="auto") on each path of the
# engine sweep (tools/engine_sweep.py), at the flagship and at full width,
# against both engines. path -> (algorithm, weighted, the torch engine's
# options, the cuda engine's; auto gets the cuda engine's, which are what a
# user of the path asks for). The weighted bfloat16 store is an opt-in of
# the cuda engine: the torch engine runs the same solve in float32. PGM
# takes the simplex on S from C = ROUTE_SIMPLEX_FROM_C on, as phase 15.
ROUTE_PATHS = {
    "pgm-exact": ("pgm", False, {}, {}),
    "pgm-stride10": ("pgm", False, {"step_stride": 10}, {"step_stride": 10}),
    "pgm-w-stride10": ("pgm", True, {"step_stride": 10},
                       {"step_stride": 10}),
    "pgm-w-adapt": ("pgm", True, {"step_stride": 10, "step_adapt": True},
                    {"step_stride": 10, "step_adapt": True}),
    "pgm-w-bf16store": ("pgm", True, {"step_stride": 10},
                        {"step_stride": 10, "store_dtype": "bfloat16"}),
    "adaprox-f32": ("adaprox", False, {"separable_prox": "auto"},
                    {"separable_prox": "auto"}),
    "adaprox-bf16m": ("adaprox", False,
                      {"separable_prox": "auto",
                       "moment_dtype": torch.bfloat16},
                      {"separable_prox": "auto",
                       "moment_dtype": torch.bfloat16}),
}
ROUTE_SIMPLEX_FROM_C = 64
ROUTE_ITERS = 20              # auto's solve against the chosen engine's
# Phase 18 routes its very-wide problems through auto for this many
# iterations: auto takes the engine the table's rows for them name.
ROUTE_VWIDE_ITERS = 3
# The engine-equivalence check (benchmarks/engine_equivalence.py, copied:
# its make_problem with random starts and noise 0.02, the unity_A proxes
# for PGM and the plain ones for AdaProx, e_rel 1e-4, and its ACCEPTANCE
# bound, :56-70) at each boundary of the routing table, EQUIV_SEEDS seeds
# from 1000 through both engines.
EQUIV_SEEDS = 8
EQUIV_E_REL = 1e-4
EQUIV_MAX_ITER = 12_000
EQUIV_ACCEPTANCE = {
    "conv_rate_tol": 0.10,
    "iter_ratio": 1.30,
    "loss_spread_margin": 1.0,
    "loss_frac_floor": 0.01,
}


# The very-wide path (phase 18): hyperspectral unmixing at the width of an
# imaging spectrometer, AVIRIS-NG's 425 channels (380-2510 nm at 5 nm),
# with K = 32 endmembers at the flagship's pixel count, made and solved as
# phase 15's unmixing (make_unmixing, seed 101: the abundances on the
# simplex; prox_A non-negativity, prox_S the simplex); beside it a K > 32
# check at (128, 64, 250_000) on the instance of 64 components (not a user
# configuration), a small K > 64 check at (128, 96, 4097) on the instance
# of 128, a small K > 128 one at (64, 160, 4097) on the body of blocks of
# 32, and K5 beyond C, K <= 8. Solves run VWIDE_ITERS
# iterations and resume after VWIDE_SPLIT; marginals between VWIDE_LO and
# VWIDE_HI iterations.
VWIDE = (425, 32, 1_000_000)
VWIDE_K64 = (128, 64, 250_000)
VWIDE_K96 = (128, 96, 4097)
VWIDE_K160 = (64, 160, 4097)
VWIDE_PACKED = (16, 12, 1_000_000)
VWIDE_LABELS = (("AVIRIS-NG", VWIDE), ("K > 32", VWIDE_K64),
                ("K > 64", VWIDE_K96), ("K > 128", VWIDE_K160))
VWIDE_ITERS, VWIDE_SPLIT = 30, 10
VWIDE_LO, VWIDE_HI = 5, 15


# the script's start, for the phases' elapsed seconds
T0 = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_problem(C, K, N, weighted, seed=SEED, planted=False):
    """bench.py's flagship problem on the card: Y = A_true S_true + noise,
    random A0, S0 (and W in [0.5, 1.5)). ``planted`` starts instead near
    the truth, each entry of A_true and S_true times a draw from [0.7,
    1.3), as benchmarks/engine_equivalence.py's planted problems do (Y and
    W unchanged)."""
    rng = np.random.default_rng(seed)
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true
         + 0.02 * rng.standard_normal((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32) if weighted else None
    if planted:
        A0 = (A_true * rng.uniform(0.7, 1.3, (C, K))).astype(np.float32)
        S0 = (S_true * rng.uniform(0.7, 1.3, (K, N))).astype(np.float32)
    return tuple(None if a is None else torch.from_numpy(a).to(DEVICE)
                 for a in (Y, A0, S0, W))


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def norm_err(got, ref):
    """Normwise (Frobenius) relative difference."""
    return float(torch.linalg.norm(got - ref)
                 / torch.linalg.norm(ref).clamp_min(1e-30))


def as_blocks(x):
    """A solve's iterate as a tuple of blocks."""
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound_of(moved_bytes, ops):
    """The least time in ms the card could take: the larger of the bytes
    over its memory rate and the float32 operations over its peak rate,
    and which of the two it is."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pgm_ops(C_, K_, N_):
    """K1's and K3's float32 operations: the residual, gS and gA products
    and the Gram, per pixel column."""
    return 2 * N_ * (3 * C_ * K_ + K_ * (K_ + 1) // 2)


def adaprox_ops(C_, K_, N_):
    """K2's and K5's float32 operations per step."""
    return N_ * K_ * (6 * C_ + 20)


def wloss(A, S, Y, W=None):
    """The (weighted) NMF loss in float64 on the card."""
    R = (A.double() @ S.double() - Y.double())
    return float(0.5 * torch.sum((1.0 if W is None else W.double()) * R * R))


def cuda_ms(fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    a warm-up, with CUDA events. The stream is first held in a sleep kernel
    long enough for the host to enqueue every call, so that a call whose
    kernels are shorter than its host work is timed by its device time
    alone, not by the gaps between launches."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


KERNEL_NAMES = ("pgm_step_kernel", "pgm_step_finalize", "adaprox_step_kernel",
                "adaprox_step_finalize", "nmf_grad_kernel",
                "nmf_grad_finalize", "prox_elementwise_kernel",
                "unity_cols_kernel", "unity_rows_kernel", "pgm_chain_kernel",
                "pgm_wide_kernel",
                "adaprox_wide_kernel", "nmf_grad_wide_kernel",
                "pgm_vwide_kernel", "adaprox_vwide_kernel",
                "nmf_grad_vwide_kernel", "pgm_kwide_kernel",
                "adaprox_kwide_kernel", "nmf_grad_kwide_kernel")
MANGLED_TYPES = (("f", "float"), ("d", "double"),
                 ("13__nv_bfloat16", "bfloat16"))
PROX_OPS = ("plus", "soft", "hard")


def kernel_name(mangled):
    """``base<args>`` from a mangled kernel instance name: int template
    arguments and the float, double and bfloat16 types."""
    for base in KERNEL_NAMES:
        if f"{len(base)}{base}E" in mangled:  # not a template
            return base
        key = f"{len(base)}{base}I"
        i = mangled.find(key)
        if i < 0:
            continue
        rest, args = mangled[i + len(key):], []
        while rest and rest[0] != "E":
            m = re.match(r"L[ib](\d+)E", rest)
            if m:
                args.append(m.group(1))
                rest = rest[m.end():]
                continue
            # a substitution (S_, S0_, ...) repeats a type named before
            m = re.match(r"S\d*_", rest)
            if m:
                types_ = [a for a in args if not a.isdigit()]
                args.append(types_[-1] if types_ else "?")
                rest = rest[m.end():]
                continue
            code = next((c for c in MANGLED_TYPES if rest.startswith(c[0])),
                        None)
            if code is None:
                break
            args.append(code[1])
            rest = rest[len(code[0]):]
        if base == "prox_elementwise_kernel" and args:
            args[0] = PROX_OPS[int(args[0])]
        return f"{base}<{','.join(args)}>"
    return mangled


def ptxas_summary(log_text):
    """One line per compiled kernel instance: its name with the template
    arguments, registers and spill stores, from ``nvcc -Xptxas -v``."""
    return [f"{name}: {regs} registers, {spill} bytes spill stores"
            for name, regs, spill in ptxas_instances(log_text)]


def ptxas_instances(log_text):
    """``(name, registers, spill store bytes)`` per compiled kernel
    instance, from ``nvcc -Xptxas -v``."""
    out, name = [], None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = kernel_name(m.group(1))
            spill = None
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def compare_step(k1, label, C_, K_, N_, weighted):
    Y, A0, S0, W = make_problem(C_, K_, N_, weighted)
    sS = 1.0 / torch.linalg.eigvalsh(A0.T @ A0)[-1]
    got = k1.fused_nmf_pgm_step(A0, S0, Y, sS, W=W)
    again = k1.fused_nmf_pgm_step(A0, S0, Y, sS, W=W)
    ref = k1.fused_nmf_pgm_step_reference(A0, S0, Y, sS, W=W)
    torch.cuda.synchronize()
    names = ("gA", "S_new", "SSt", "loss", "dS_sq", "nS_sq")
    errs = {n: rel_err(g, r) for n, g, r in zip(names, got, ref)}
    for n, e in errs.items():
        tol = DS_RTOL if n == "dS_sq" else STEP_RTOL
        check(e <= tol, f"K1 {label} {n}: rel err {e:.3e} > {tol:g}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K1 {label}: two launches differ")
    check(bool(torch.isfinite(got[1]).all()), f"K1 {label}: non-finite S'")
    max_abs = float((got[1] - ref[1]).abs().max())
    log(f"K1 vs plain [{label}, C={C_} K={K_} N={N_}]: max rel err "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (tol {STEP_RTOL:g}, dS_sq {DS_RTOL:g}); S_new max abs err "
        f"{max_abs:.3e}; two launches bitwise equal")
    return (Y, A0, S0, sS), max_abs


def compare_step_bf16(k1, label, C_, K_, N_, weighted):
    """K1 with the bfloat16 store against its plain version: S' within one
    bfloat16 ulp (+ BF16_STORE_ATOL), gA and the loss within STEP_RTOL; the
    Gram and the norms are those of the stored (rounded) S'. Returns the
    operands and S''s max abs error."""
    Y, A0, S0, W = make_problem(C_, K_, N_, weighted)
    bf = torch.bfloat16
    Sb, Yb = S0.to(bf), Y.to(bf)
    Wb = None if W is None else W.to(bf)
    sS = 1.0 / torch.linalg.eigvalsh(A0.T @ A0)[-1]
    got = k1.fused_nmf_pgm_step(A0, Sb, Yb, sS, W=Wb)
    again = k1.fused_nmf_pgm_step(A0, Sb, Yb, sS, W=Wb)
    ref = k1.fused_nmf_pgm_step_reference(A0, Sb, Yb, sS, W=Wb)
    torch.cuda.synchronize()
    check(got[1].dtype == bf, f"K1 bf16 {label}: S' is {got[1].dtype}")
    ok, ulps, diff = bf16_within(got[1], ref[1])
    check(ok, f"K1 bf16 {label} S_new: {ulps:g} bfloat16 ulps, {diff:.3e} "
          f"abs, beyond 1 ulp + {BF16_STORE_ATOL:g}")
    Sn, S32 = got[1].float(), Sb.float()
    dS = Sn - S32
    own = (Sn @ Sn.T, torch.sum(dS * dS), torch.sum(Sn * Sn))
    errs = {"gA": rel_err(got[0], ref[0]), "loss": rel_err(got[3], ref[3]),
            "SSt": rel_err(got[2], own[0]), "dS_sq": rel_err(got[4], own[1]),
            "nS_sq": rel_err(got[5], own[2])}
    for n, e in errs.items():
        tol = DS_RTOL if n == "dS_sq" else STEP_RTOL
        check(e <= tol, f"K1 bf16 {label} {n}: rel err {e:.3e} > {tol:g}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K1 bf16 {label}: two launches differ")
    log(f"K1 bf16 store vs plain [{label}, C={C_} K={K_} N={N_}]: S_new "
        f"{ulps:.3g} bfloat16 ulps max ({diff:.3e} abs); max rel err "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (Gram and norms against the stored S'; tol {STEP_RTOL:g}, "
        f"dS_sq {DS_RTOL:g}); two launches bitwise equal")
    return (A0, Sb, Yb, sS, Wb), diff


def bf16_within(got, ref):
    """bfloat16 moment stores against the plain version's: each element
    within one bfloat16 ulp of ref, plus the float32 tests' atol 1e-5 for
    elements where the EMA cancels to near zero (there the float32 values
    already differ by more than an ulp of the result). Returns (ok, largest
    distance in ulps, largest absolute difference)."""
    g, r = got.float(), ref.float()
    _, e = torch.frexp(r)
    ulp = torch.ldexp(torch.ones_like(r), e - 8).clamp_min(2.0 ** -133)
    diff = (g - r).abs()
    ok = bool((diff <= ulp + BF16_STORE_ATOL).all())
    return ok, float((diff / ulp).max()), float(diff.max())


def adaprox_inputs(C_, K_, N_, weighted, mdt, t=3, b1=0.9, b2=0.999):
    """A K2 call's operands: the flagship data, moments as after a few
    iterations, the step from S's row means and the scalars of
    iteration t."""
    Y, A0, S0, W = make_problem(C_, K_, N_, weighted)
    rng = np.random.default_rng(SEED + 1)
    dev = S0.device
    M = torch.from_numpy((0.1 * rng.standard_normal((K_, N_)))
                         .astype(np.float32)).to(dev).to(mdt)
    V = torch.from_numpy((0.01 * rng.random((K_, N_)))
                         .astype(np.float32)).to(dev).to(mdt)
    alpha = torch.sum(S0, dim=1, keepdim=True) / N_ / 10
    one, t_ = np.float32(1), np.float32(t)
    scalars = (np.float32(b1), one / (one - np.float32(b1) ** t_),
               one / (one - np.float32(b2) ** t_))
    return A0, S0, M, V, Y, alpha, scalars, W


def compare_adaprox_step(k2, label, C_, K_, N_, weighted=False,
                         mdt=torch.float32, prox_S=None):
    A, S, M, V, Y, alpha, sc, W = adaprox_inputs(C_, K_, N_, weighted, mdt)
    args = (A, S, M, V, Y, alpha, sc)
    return args, hold_adaprox_step(k2, label, args, dict(W=W, prox_S=prox_S))


def hold_adaprox_step(k2, label, args, kw):
    """K2 on ``args``, ``kw`` against its plain version on the same
    tensors: every output within STEP_RTOL (dS_sq DS_RTOL), bfloat16
    moments within one bfloat16 ulp (+ BF16_STORE_ATOL), two launches
    bitwise equal, S' finite. Returns S''s max abs error."""
    C_, K_ = args[0].shape
    N_ = args[1].shape[1]
    mdt = args[2].dtype
    got = k2.fused_nmf_adaprox_step(*args, **kw)
    again = k2.fused_nmf_adaprox_step(*args, **kw)
    ref = k2.fused_nmf_adaprox_step_reference(*args, **{
        k: v for k, v in kw.items() if k != "tile_n"})
    torch.cuda.synchronize()
    names = ("gA", "S_new", "M_new", "V_new", "rowsum", "loss", "dS_sq",
             "nS_sq")
    errs = {}
    for n, g, r in zip(names, got, ref):
        if mdt == torch.bfloat16 and n in ("M_new", "V_new"):
            # a one-ulp float32 difference may flip one bfloat16 rounding
            check(g.dtype == torch.bfloat16, f"K2 {label} {n} dtype")
            ok, ulps, diff = bf16_within(g, r)
            errs[n] = diff
            check(ok, f"K2 {label} {n}: {ulps:g} bfloat16 ulps, "
                  f"{diff:.3e} abs, beyond 1 ulp + {BF16_STORE_ATOL:g}")
            continue
        errs[n] = e = rel_err(g, r)
        tol = DS_RTOL if n == "dS_sq" else STEP_RTOL
        check(e <= tol, f"K2 {label} {n}: rel err {e:.3e} > {tol:g}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K2 {label}: two launches differ")
    check(bool(torch.isfinite(got[1]).all()), f"K2 {label}: non-finite S'")
    max_abs = float((got[1] - ref[1]).abs().max())
    log(f"K2 vs plain [{label}, C={C_} K={K_} N={N_}]: max rel err "
        + ", ".join(f"{n} {e:.2e}" + (" abs" if mdt == torch.bfloat16
                                      and n in ("M_new", "V_new") else "")
                    for n, e in errs.items())
        + f" (tol {STEP_RTOL:g}, dS_sq {DS_RTOL:g}, bfloat16 moments 1 ulp "
        f"+ {BF16_STORE_ATOL:g});"
        f" S_new max abs err {max_abs:.3e}; two launches bitwise equal")
    return max_abs


def compare_adaprox_bf16(k2, label, C_, K_, N_, weighted=False,
                         mdt=torch.float32):
    """K2 with the bfloat16 store (S, Y and W in bfloat16) against its plain
    version: S' within one bfloat16 ulp (+ BF16_STORE_ATOL), the moments
    as in compare_adaprox_step, gA and the loss within STEP_RTOL, and the
    row sums and the norms against the stored S'. Returns the unweighted
    call's operands and S''s max abs error."""
    A, S, M, V, Y, alpha, sc, W = adaprox_inputs(C_, K_, N_, weighted, mdt)
    bf = torch.bfloat16
    S, Y = S.to(bf), Y.to(bf)
    W = None if W is None else W.to(bf)
    got = k2.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc, W=W)
    again = k2.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc, W=W)
    ref = k2.fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha, sc, W=W)
    torch.cuda.synchronize()
    check(got[1].dtype == bf, f"K2 bf16 store {label}: S' is {got[1].dtype}")
    ok, ulps, diff = bf16_within(got[1], ref[1])
    check(ok, f"K2 bf16 store {label} S_new: {ulps:g} bfloat16 ulps, "
          f"{diff:.3e} abs, beyond 1 ulp + {BF16_STORE_ATOL:g}")
    errs = {}
    for n, i in (("M_new", 2), ("V_new", 3)):
        if mdt == bf:
            ok_m, u_m, errs[n] = bf16_within(got[i], ref[i])
            check(ok_m, f"K2 bf16 store {label} {n}: {u_m:g} bfloat16 ulps")
        else:
            errs[n] = rel_err(got[i], ref[i])
            check(errs[n] <= STEP_RTOL, f"K2 bf16 store {label} {n}: rel err "
                  f"{errs[n]:.3e}")
    Sn = got[1].float()
    dS = Sn - S.float()
    own = {"gA": (got[0], ref[0]), "loss": (got[5], ref[5]),
           "rowsum": (got[4], Sn.sum(1, keepdim=True)),
           "dS_sq": (got[6], torch.sum(dS * dS)),
           "nS_sq": (got[7], torch.sum(Sn * Sn))}
    for n, (g, r) in own.items():
        errs[n] = e = rel_err(g, r)
        tol = DS_RTOL if n == "dS_sq" else STEP_RTOL
        check(e <= tol, f"K2 bf16 store {label} {n}: rel err {e:.3e} > "
              f"{tol:g}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K2 bf16 store {label}: two launches differ")
    check(bool(torch.isfinite(Sn).all()), f"K2 bf16 store {label}: "
          "non-finite S'")
    log(f"K2 bf16 store vs plain [{label}, C={C_} K={K_} N={N_}]: S_new "
        f"{ulps:.3g} bfloat16 ulps max ({diff:.3e} abs); "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (moments: bfloat16 abs within 1 ulp, or rel; row sums and "
        f"norms against the stored S'; tol {STEP_RTOL:g}, dS_sq "
        f"{DS_RTOL:g}); two launches bitwise equal")
    return (A, S, M, V, Y, alpha, sc), diff


def compare_packed(sm, k2, layout, C_, K_, N_):
    """K5 in the ``smv`` (float32 [S; M; V]) or ``mv`` (bfloat16 [M; V])
    layout against its plain version, and against K2 on the same inputs
    unpacked (bit for bit: the same body). Returns the call's arguments
    and S''s max abs error against the plain version."""
    mdt = torch.float32 if layout == "smv" else torch.bfloat16
    A, S, M, V, Y, alpha, sc, _ = adaprox_inputs(C_, K_, N_, False, mdt)
    if layout == "smv":
        args, kw = (A, torch.cat([S, M, V]), Y, alpha, sc), {}
    else:
        args, kw = (A, S, Y, alpha, sc), {"MV": torch.cat([M, V])}
    got = sm.packed_step(*args, **kw)
    again = sm.packed_step(*args, **kw)
    ref = sm.packed_step_reference(*args, **kw)
    base = k2.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc)
    torch.cuda.synchronize()

    def unpacked(out):
        if layout == "smv":
            gA, SMV, rowsum, stats = out
            S1, M1, V1 = SMV[:K_], SMV[K_:2 * K_], SMV[2 * K_:]
        else:
            gA, S1, MV, rowsum, stats = out
            M1, V1 = MV[:K_], MV[K_:]
        return gA, S1, M1, V1, rowsum, stats[0], stats[1], stats[2]

    g, r = unpacked(got), unpacked(ref)
    names = ("gA", "S_new", "M_new", "V_new", "rowsum", "loss", "dS_sq",
             "nS_sq")
    check(all(torch.equal(a, b) for a, b in zip(g, base)),
          f"K5 {layout}: differs from K2 on the same inputs")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K5 {layout}: two launches differ")
    errs = {}
    for n, a, b in zip(names, g, r):
        if mdt == torch.bfloat16 and n in ("M_new", "V_new"):
            ok, ulps, errs[n] = bf16_within(a, b)
            check(ok, f"K5 {layout} {n}: {ulps:g} bfloat16 ulps, beyond 1 "
                  f"ulp + {BF16_STORE_ATOL:g}")
            continue
        errs[n] = e = rel_err(a, b)
        tol = DS_RTOL if n == "dS_sq" else STEP_RTOL
        check(e <= tol, f"K5 {layout} {n}: rel err {e:.3e} > {tol:g}")
    max_abs = float((g[1] - r[1]).abs().max())
    log(f"K5 vs plain [{layout}, C={C_} K={K_} N={N_}]: max rel err "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (bfloat16 moments: abs, 1 ulp + {BF16_STORE_ATOL:g}); S_new "
        f"max abs err {max_abs:.3e}; bit for bit equal to K2 on the same "
        "inputs; two launches bitwise equal")
    return args, kw, (A, S, M, V, Y, alpha, sc), max_abs


def compare_grad(tops, label, C_, K_, N_, weighted):
    """K3 against its plain version; returns its operands and gS's max abs
    error."""
    Y, A0, S0, W = make_problem(C_, K_, N_, weighted)
    got = tops.fused_nmf_grad(A0, S0, Y, W=W)
    again = tops.fused_nmf_grad(A0, S0, Y, W=W)
    ref = tops.fused_nmf_grad_reference(A0, S0, Y, W=W)
    torch.cuda.synchronize()
    names = ("gA", "gS", "SSt", "loss")
    errs = {n: rel_err(g, r) for n, g, r in zip(names, got, ref)}
    for n, e in errs.items():
        check(e <= STEP_RTOL, f"K3 {label} {n}: rel err {e:.3e} > "
              f"{STEP_RTOL:g}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K3 {label}: two launches differ")
    check(bool(torch.isfinite(got[1]).all()) and got[3].shape == (),
          f"K3 {label}: non-finite gS or a loss that is not 0-d")
    max_abs = float((got[1] - ref[1]).abs().max())
    log(f"K3 vs plain [{label}, C={C_} K={K_} N={N_}]: max rel err "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (tol {STEP_RTOL:g}); gS max abs err {max_abs:.3e}; two "
        "launches bitwise equal")
    return (A0, S0, Y, W), max_abs


#: K4's cases: (label, op, keyword arguments); unity gets a positive input.
PROX_CASES = (
    ("plus", "plus", {}),
    ("soft relative", "soft", {"thresh": 0.5}),
    ("soft absolute", "soft", {"thresh": 0.3, "type": "absolute"}),
    ("hard relative", "hard", {"thresh": 0.5}),
    ("hard absolute", "hard", {"thresh": 0.3, "type": "absolute"}),
    ("unity axis 0", "unity", {"axis": 0}),
    ("unity axis 1", "unity", {"axis": 1}),
)


def prox_pair(tops, op):
    """K4 op's wrapper and its plain version."""
    return (getattr(tops, f"prox_{op}_pallas"),
            getattr(tops, f"prox_{op}_reference"))


def same_with_nan(a, b):
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))


def compare_prox(tops, label, X, step):
    """Every K4 case on X (and |X| + 0.1 for unity) against the plain
    version: plus, soft and hard bitwise, unity within UNITY_RTOL; two
    launches bitwise equal. Returns {case: max abs err}."""
    P = X.abs() + 0.1
    errs = {}
    for case, op, kw in PROX_CASES:
        kernel, plain = prox_pair(tops, op)
        Z = P if op == "unity" else X
        got, again = kernel(Z, step, **kw), kernel(Z, step, **kw)
        ref = plain(Z, step, **kw)
        torch.cuda.synchronize()
        check(got.dtype == Z.dtype and got.shape == Z.shape
              and got.data_ptr() != Z.data_ptr(),
              f"K4 {case} [{label}]: dtype, shape or aliasing")
        check(torch.equal(got, again), f"K4 {case} [{label}]: two launches "
              "differ")
        errs[case] = float((got - ref).abs().max())
        if op == "unity":
            e = float(((got - ref).abs() / ref.abs()).max())
            check(e <= UNITY_RTOL[Z.dtype], f"K4 {case} [{label}]: rel err "
                  f"{e:.3e} > {UNITY_RTOL[Z.dtype]:g}")
        else:
            check(torch.equal(got, ref), f"K4 {case} [{label}]: not bitwise "
                  f"equal to the plain version (max abs {errs[case]:.3e})")
    return errs


def check_prox_nan(tops, X, step):
    """A NaN in X stays NaN through plus, soft and hard and makes its
    column (axis 0) or row (axis 1) NaN through unity, as in the plain
    versions."""
    Xn = X.clone()
    Xn[3, 12345] = float("nan")
    Xn[0, 7] = float("nan")
    P = Xn.abs() + 0.1
    for case, op, kw in PROX_CASES:
        kernel, plain = prox_pair(tops, op)
        Z = P if op == "unity" else Xn
        got, ref = kernel(Z, step, **kw), plain(Z, step, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isnan(got[3, 12345])) and bool(torch.isnan(
            got[0, 7])), f"K4 {case}: NaN did not propagate")
        if op == "unity":
            bad = (got[:, 12345] if kw["axis"] == 0 else got[3])
            check(bool(torch.isnan(bad).all())
                  and torch.equal(torch.isnan(got), torch.isnan(ref)),
                  f"K4 {case}: NaN pattern differs from the plain version")
        else:
            check(same_with_nan(got, ref), f"K4 {case}: NaN input differs "
                  "from the plain version")


def library_prox(op, Z, step, kw):
    """One PyTorch call that computes K4 op's function, where there is one:
    ``clamp_min`` for plus, ``softshrink`` for soft with the threshold as a
    host number; none for hard (``hardshrink`` keeps |x| > t, K4 keeps
    |x| >= t) or unity. Timed as a yardstick only; the port never calls
    it."""
    if op == "plus":
        return lambda: torch.clamp_min(Z, 0)
    if op == "soft" and kw.get("type", "relative") == "relative":
        t = float(step) * kw["thresh"]
        return lambda: torch.nn.functional.softshrink(Z, t)
    return None


TRACE_MARGIN_S = 0.05


def kernels_of(fn, trace, attempts=3):
    """The CUDA kernels that one call of ``fn`` runs, by name, from a
    ``torch.profiler`` trace written to ``trace``: the kernel events between
    two marker kernels (``torch.cuda._sleep``'s ``spin_kernel``) launched
    before and after the call. The profiler drops device events that its
    clock conversion places outside the capture window, which can take a
    kernel launched just after the trace starts or ending just before it
    stops; so the markers are launched TRACE_MARGIN_S after the start and
    finish that long before the stop. A trace without exactly two markers
    is taken again."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_MARGIN_S)
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
        prof.export_chrome_trace(str(trace))
        events = sorted((e for e in json.loads(trace.read_text())[
            "traceEvents"] if e.get("cat") == "kernel"),
            key=lambda e: e["ts"])
        names = [e["name"] for e in events]
        marks = [i for i, n in enumerate(names) if "spin_kernel" in n]
        if len(marks) == 2:
            return names[marks[0] + 1:marks[1]]
    raise RuntimeError(f"chip_smoke: no trace of {attempts} held exactly two "
                       f"markers around the call: {names}")


def launches_of(fn):
    """How many CUDA kernels one call of ``fn`` launches, counted on the
    host's side of a ``torch.profiler`` trace: the runtime's launch calls
    inside a ``record_function`` span around the call. Host events carry
    host timestamps, so a call of thousands of kernels is counted whole
    (the device events that ``kernels_of`` reads were seen to lose their
    first marker in a trace of 14,504 kernels)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        with record_function("chip_smoke_call"):
            fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "launches.json")
        prof.export_chrome_trace(trace)
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("name") == "chip_smoke_call"
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise RuntimeError(f"chip_smoke: {len(spans)} spans of the call in "
                           "the trace")
    t0, t1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    return sum(e.get("cat") == "cuda_runtime"
               and e["name"].startswith(("cudaLaunch", "cuLaunch"))
               and t0 <= e["ts"] <= t1 for e in events)


def host_us(fn, calls=1000, batch=100):
    """Host microseconds per call of ``fn``: ``calls`` calls in batches,
    each enqueued behind a sleep kernel that holds the stream, so the host
    never waits on the card while it is timed."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / calls * 1e6


def reset_counts(kernels):
    for k in kernels:
        k.launches = 0
        if hasattr(k, "device_scalar_launches"):
            k.device_scalar_launches = 0


def sync_sites(fn):
    """Where ``fn``'s synchronizing CUDA calls come from: a count per
    innermost frame of the port or of this script (a sync on another
    thread, the autograd engine's device thread, belongs to the call). The
    garbage collector is held off during the call, and a sync that the
    sync debug mode reports on this thread outside the call (at its own
    switching on, seen once in a run of 579) counts under ``"outside the
    call"``."""
    import collections
    import gc
    import threading
    import traceback
    import warnings

    sites = collections.Counter()
    caller = threading.get_ident()

    def show(message, *args, **kwargs):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        inside = threading.get_ident() != caller or any(
            f.name == "sync_sites" and f.line == "fn()" for f in stack)
        frames = [f for f in stack if "proxmin_tpu_torch" in f.filename
                  or f.filename.endswith("chip_smoke.py")]
        f = frames[-1] if frames else None
        key = (f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
               if f else "?")
        sites[key if inside else "outside the call"] += 1

    gc.collect()
    torch.cuda.synchronize()
    gc.disable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        gc.enable()
    torch.cuda.synchronize()
    return dict(sites)


def reads_in(fn):
    """Blocking reads that the call ``fn()`` makes (``sync_sites``), and
    where they come from."""
    sites = sync_sites(fn)
    return sum(n for k, n in sites.items() if k != "outside the call"), sites


def blocking_reads(fn):
    """How many synchronizing CUDA calls (blocking host reads) ``fn``
    makes, counted by ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def dtoh_copies(fn):
    """How many device-to-host copies ``fn`` makes, counted in a
    ``torch.profiler`` trace of the card (each blocking read is one; the
    sync debug mode may miss some)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "memcpy" in e.key.lower() and "dtoh" in e.key.lower())


def timed(fn, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(n)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def marginal_ms(fn, lo, hi, reps=2):
    """Marginal host-clock ms per iteration of ``fn(n)`` between ``lo`` and
    ``hi`` iterations, each the least of ``reps`` runs."""
    t_lo = min(timed(fn, lo) for _ in range(reps))
    t_hi = min(timed(fn, hi) for _ in range(reps))
    return (t_hi - t_lo) / (hi - lo) * 1e3


def turn_ms(fn, lo=TURN_LO, hi=TURN_HI):
    """One in-turn marginal ms/iter of ``fn``: one run per count."""
    return marginal_ms(fn, lo, hi, reps=1)


def per_iteration(solve, k4_fn=None, n=10):
    """CUDA kernels (all, and K4 soft's by its wrapper's count where
    ``k4_fn`` is given) and blocking host reads per iteration of
    ``solve(n)``: the difference between a run of ``2 n`` iterations and one
    of ``n``, so what a call does once drops out. Returns them with the
    reads of the ``n``-iteration call."""
    k_lo = launches_of(lambda: solve(n))
    before = k4_fn.launches if k4_fn else 0
    k_hi = launches_of(lambda: solve(2 * n))
    k4 = k4_fn.launches - before if k4_fn else 0
    r_lo = blocking_reads(lambda: solve(n))
    r_hi = blocking_reads(lambda: solve(2 * n))
    return (k_hi - k_lo) / n, k4 / (2 * n), (r_hi - r_lo) / n, r_lo


def tv_problem(H):
    """The two-rectangle image of benchmarks/admm_scale.py and its noisy
    observation (sigma 0.3), H x H float32 on the card."""
    rng = np.random.default_rng(TV_SEED)
    truth = np.zeros((H, H), np.float32)
    truth[H // 8: H // 2, H // 6: H // 2] = 1.0
    truth[5 * H // 8: 7 * H // 8, H // 3: 5 * H // 6] = -0.6
    y = truth + 0.3 * rng.standard_normal((H, H)).astype(np.float32)
    return torch.from_numpy(truth).to(DEVICE), torch.from_numpy(y).to(DEVICE)


def tv_operators(linop, H):
    """Forward differences along each axis as matrix-free operators, with
    their known ``lambda_max(L^T L) = 4``."""
    def dh(x):
        return x[:, 1:] - x[:, :-1]

    def dh_T(v):
        return torch.cat([-v[:, :1], v[:, :-1] - v[:, 1:], v[:, -1:]], dim=1)

    def dv(x):
        return x[1:, :] - x[:-1, :]

    def dv_T(v):
        return torch.cat([-v[:1, :], v[:-1, :] - v[1:, :], v[-1:, :]], dim=0)

    return (linop.FunctionOperator(dh, dh_T, (H, H), norm_sq=4.0),
            linop.FunctionOperator(dv, dv_T, (H, H), norm_sq=4.0))


def tv_solvers(algorithms, linop, top, tops, H):
    """``(truth, y, admm, sdmm, sdmm_k4)`` for the H x H TV problem: each
    solver as ``solve(n, x=None, state=None, **kw)`` at ``e_rel = e_abs =
    0`` unless ``kw`` says otherwise."""
    truth, y = tv_problem(H)
    Dh, Dv = tv_operators(linop, H)
    x0 = torch.zeros_like(y)

    def prox_quad(x, step):
        return (x + step * y) / (1.0 + step)

    def admm(n, x=None, state=None, **kw):
        kw = {"e_rel": 0, "e_abs": 0, **kw}
        return algorithms.admm(x0 if x is None else x, prox_quad, TV_STEP_F,
                               prox_g=partial(top.prox_soft, thresh=TV_LAM),
                               L=Dh, max_iter=n, state=state, **kw)

    def sdmm_with(prox_l1):
        def sdmm(n, x=None, state=None, **kw):
            kw = {"e_rel": 0, "e_abs": 0, **kw}
            return algorithms.sdmm(x0 if x is None else x, prox_quad,
                                   TV_STEP_F, proxs_g=[prox_l1] * 2,
                                   Ls=[Dh, Dv], max_iter=n, state=state,
                                   **kw)
        return sdmm

    return (truth, y, admm,
            sdmm_with(partial(top.prox_soft, thresh=TV_LAM)),
            sdmm_with(partial(tops.prox_soft_pallas, thresh=TV_LAM)))


def bsdmm_solvers(algorithms, tnmf, top, Y, A0, S0, Ww):
    """The flagship's bsdmm paths, each as ``solve(n, x=None, state=None,
    **kw)``: unweighted through ``nmf``; with a sum-to-one constraint on S
    as ``proxs_g`` through ``bsdmm`` itself, with the block gradient step
    and the block step written out as a user would; weighted with
    ``step_stride=10``, fixed and adaptive."""
    def through_nmf(**fixed):
        def solve(n, x=None, state=None, **kw):
            A, S = (A0, S0) if x is None else x
            return tnmf.nmf(Y, A, S, algorithm="bsdmm", e_rel=0, max_iter=n,
                            state=state, **fixed, **kw)
        return solve

    def block_prox_f(Xj, step, Xs=None, j=None):
        A, S = Xs
        D = A @ S - Y
        grad = D @ S.T if j == 0 else A.T @ D
        return top.prox_plus(Xj - step * grad, step)

    def block_step(Xs, j=None):
        return tnmf.step_A(*Xs) if j == 0 else tnmf.step_S(*Xs)

    def constrained(n, x=None, state=None, **kw):
        return algorithms.bsdmm(
            list((A0, S0) if x is None else x), block_prox_f, block_step,
            proxs_g=[None, [partial(top.prox_unity, axis=0)]], e_rel=0,
            max_iter=n, state=state, **kw)

    return {
        "unweighted": through_nmf(),
        "sum-to-one S as proxs_g": constrained,
        "weighted stride 10": through_nmf(W=Ww, step_stride=STRIDE),
        "weighted adaptive": through_nmf(W=Ww, step_stride=STRIDE,
                                         step_adapt=True),
    }


PROFILE_ITERS = 50


def profile_paths(tnmf, algorithms, linop, top, tops, card):
    """``--profile``: each PGM, AdaProx cuda and ADMM-family path's device
    busy time, busy share, kernel launches and device-to-host copies (the
    blocking reads) per iteration, from a ``torch.profiler`` trace of
    PROFILE_ITERS iterations resumed after the first LO (past the cold
    start, as the marginal is): kernel, memcpy and memset events summed
    from the exported trace (``key_averages()`` counts a kernel's time on
    its op row too). The busy share is the busy time over the path's
    unprofiled marginal ms/iter, since the profiler slows the host. The
    traces go to build/profile/ of the checkout."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    Y, A0, S0, W = make_problem(C, K, N, True)
    out_dir = Path(__file__).resolve().parent / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    nmf_paths = (
        ("pgm engine=cuda", dict(engine="cuda")),
        ("pgm engine=torch", dict(engine="torch")),
        ("weighted torch stride 10", dict(W=W, step_stride=STRIDE)),
        ("weighted torch adaptive", dict(W=W, step_stride=STRIDE,
                                         step_adapt=True)),
        ("weighted cuda stride 10", dict(W=W, step_stride=STRIDE,
                                         engine="cuda")),
        ("weighted cuda adaptive", dict(W=W, step_stride=STRIDE,
                                        step_adapt=True, engine="cuda")),
        ("weighted cuda adaptive bf16 store", dict(
            W=W, step_stride=STRIDE, step_adapt=True, engine="cuda",
            store_dtype=torch.bfloat16)),
        ("unweighted torch adaptive", dict(step_adapt=True)),
        ("unweighted cuda adaptive", dict(step_adapt=True, engine="cuda")),
        ("adaprox cuda f32 moments", dict(algorithm="adaprox",
                                          engine="cuda")),
        ("adaprox cuda bf16 moments", dict(
            algorithm="adaprox", engine="cuda", moment_dtype=torch.bfloat16)),
        ("adaprox cuda bf16 store bf16 moments", dict(
            algorithm="adaprox", engine="cuda", moment_dtype=torch.bfloat16,
            store_dtype=torch.bfloat16)),
    )

    def nmf_solve(kw):
        def solve(n, x=None, state=None):
            A, S = (A0, S0) if x is None else x
            return tnmf.nmf(Y, A, S, e_rel=0, max_iter=n, state=state, **kw)
        return solve

    # (label, solve(n, x, state), iteration counts of the marginal)
    paths = [(label, nmf_solve(kw), LO, HI) for label, kw in nmf_paths]
    for H, lo, hi in TV_SIZES:
        _, _, admm, sdmm, sdmm_k4 = tv_solvers(algorithms, linop, top, tops,
                                               H)
        paths += [(f"admm TV {H}x{H}", admm, lo, hi),
                  (f"sdmm TV {H}x{H}", sdmm, lo, hi),
                  (f"sdmm TV {H}x{H} K4 soft as prox_g", sdmm_k4, lo, hi)]
    paths += [(f"bsdmm nmf {label}", solve, LO, HI) for label, solve in
              bsdmm_solvers(algorithms, tnmf, top, Y, A0, S0, W).items()]

    for label, solve, lo, hi in paths:
        timed(solve, 5)
        ms = marginal_ms(solve, lo, hi)
        warm = solve(lo)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve(PROFILE_ITERS, warm.x, warm.state)
            torch.cuda.synchronize()
        trace = out_dir / (re.sub(r"\W+", "_", label) + ".json")
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
        device = [e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        busy = sum(e["dur"] for e in device) / PROFILE_ITERS
        by_name = {}
        for e in device:
            by_name[e["name"]] = by_name.get(e["name"], 0) + e["dur"]
        top_items = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        k1_us = {part: sum(d for n, d in by_name.items() if part in n)
                 / PROFILE_ITERS
                 for part in ("pgm_step_kernel", "pgm_step_finalize")}
        kernels = sum(e["cat"] == "kernel" for e in device) / PROFILE_ITERS
        copies = (len(device) / PROFILE_ITERS) - kernels
        reads = sum(e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]
                    for e in device) / PROFILE_ITERS
        log(f"profile [{label}]: device busy {busy:.1f} us/iter, busy share "
            f"{busy / (ms * 1e3):.2f} of {ms:.4f} ms/iter marginal, kernel "
            f"launches {kernels:.1f}/iter, memcpy+memset {copies:.1f}/iter, "
            f"of them device-to-host copies {reads:.2f}/iter; "
            "top: " + "; ".join(f"{n[:60]} {d / PROFILE_ITERS:.1f} us/iter"
                                for n, d in top_items)
            + f"; on {card}")
        if k1_us["pgm_step_kernel"]:
            log(f"profile [{label}]: K1 pgm_step_kernel "
                f"{k1_us['pgm_step_kernel']:.1f} us/iter, pgm_step_finalize "
                f"{k1_us['pgm_step_finalize']:.1f} us/iter; on {card}")


def admm_family_phase(mods, problem, loss_pgm, card, every_kernel, soft_fn):
    """Phase 11: the ADMM family on the card (see the module docstring).
    ``mods`` are the port's modules ``(algorithms, linop, tnmf, top,
    tops)``, ``problem`` the flagship ``(Y, A0, S0, Ww)``, ``loss_pgm``
    the loss of nmf(engine="torch") after ITERS iterations, ``soft_fn`` K4's
    soft wrapper. Returns K4 soft's launches on the 1024 x 1024 sdmm path
    (ITERS iterations)."""
    algorithms, linop, tnmf, top, tops = mods
    Y, A0, S0, Ww = problem
    # the weighted A bound past C K K = 2**20: batched Lanczos against the
    # Gram route, and the launches of one call
    for Cl, Kl, Nl in LANCZOS_CASES:
        rng = np.random.default_rng(SEED + 3)
        S_l = torch.from_numpy(rng.random((Kl, Nl)).astype(np.float32)
                               ).to(DEVICE)
        W_l = torch.from_numpy((0.5 + rng.random((Cl, Nl))).astype(
            np.float32)).to(DEVICE)
        check(Cl * Kl * Kl > 2 ** 20, "a Lanczos case is below the switch")
        lz = float(tnmf._weighted_lipschitz_A(S_l, W_l))
        gram = float(torch.max(torch.linalg.eigvalsh(
            torch.einsum("kn,cn,ln->ckl", S_l, W_l, S_l))[:, -1]))
        over = LANCZOS_OVER if Cl > 256 else 1 + LANCZOS_RTOL
        check(gram * (1 - LANCZOS_RTOL) <= lz <= gram * over,
              f"batched Lanczos bound {lz:.6e} against the Gram route "
              f"{gram:.6e} [C={Cl} K={Kl} N={Nl}]: outside [1 - "
              f"{LANCZOS_RTOL:g}, {over:g}]")
        lz_kernels = launches_of(
            lambda: tnmf._weighted_lipschitz_A(S_l, W_l))
        lz_reads = blocking_reads(
            lambda: tnmf._weighted_lipschitz_A(S_l, W_l))
        lz_ms = cuda_ms(lambda: tnmf._weighted_lipschitz_A(S_l, W_l), reps=5)
        log(f"weighted A bound by batched Lanczos [C={Cl} K={Kl} N={Nl}, "
            f"{min(Kl, 32) + 2} steps, {min(Cl, 256)} members bisected]: "
            f"{lz:.6e} against the Gram route {gram:.6e}, ratio "
            f"{lz / gram:.6f} (held to [1 - {LANCZOS_RTOL:g}, {over:g}]); "
            f"{lz_kernels} CUDA kernels and {lz_reads} blocking reads "
            f"per call, {lz_ms:.3f} ms per call on {card}")

    # TV denoising: admm (one constraint) and sdmm (two) at both sizes
    k4_soft_sdmm = {}
    for H, lo, hi in TV_SIZES:
        P = H * H
        truth, y_tv, admm_tv, sdmm_tv, sdmm_k4 = tv_solvers(
            algorithms, linop, top, tops, H)
        timed(admm_tv, 3)
        full = admm_tv(ITERS)
        half = admm_tv(ITERS // 2)
        rest = admm_tv(ITERS // 2, half.x, half.state)
        torch.cuda.synchronize()
        check(full.iterations == ITERS and rest.iterations == ITERS // 2
              and rest.state["total_it"] == ITERS,
              f"admm TV {H}: iterations {full.iterations}, "
              f"{rest.iterations}")
        check(bool(torch.isfinite(full.x).all()) and tuple(full.x.shape)
              == (H, H) and all(np.isfinite(full.errors)),
              f"admm TV {H}: non-finite result or errors")
        check(torch.equal(rest.x, full.x) and rest.errors == full.errors
              and all(torch.equal(rest.state[k], full.state[k])
                      for k in ("z", "u", "r_prev")),
              f"admm TV {H}: {ITERS // 2} + {ITERS // 2} resumed iterations "
              f"differ from {ITERS} straight ones")
        rmse_in = float(torch.sqrt(torch.mean((y_tv - truth) ** 2)))
        rmse_admm = float(torch.sqrt(torch.mean((full.x - truth) ** 2)))
        log(f"admm TV {H}x{H} (horizontal differences): {ITERS} iterations, "
            f"slack {full.slack}, errors (e_pri, e_dual, |R|, |S|) "
            + ", ".join(f"{v:.4e}" for v in full.errors)
            + f"; RMSE against the truth {rmse_in:.4f} -> {rmse_admm:.4f}; "
            f"{ITERS // 2} + {ITERS // 2} resumed iterations equal {ITERS} "
            "straight ones bit for bit (x, Z, U, R and the errors)")
        # the benchmark's quality row
        q = sdmm_tv(400, e_rel=1e-4)
        rmse_out = float(torch.sqrt(torch.mean((q.x - truth) ** 2)))
        check(bool(torch.isfinite(q.x).all()) and rmse_out < rmse_in,
              f"sdmm TV {H}: RMSE {rmse_in:.4f} -> {rmse_out:.4f}")
        log(f"sdmm TV {H}x{H} (both directions), e_rel=1e-4, max_iter=400: "
            f"RMSE against the truth {rmse_in:.4f} -> {rmse_out:.4f} in "
            f"{q.iterations} iterations, status {q.status}")
        # sdmm with K4 soft as prox_g against the plain operator
        reset_counts(every_kernel)
        r_k4 = sdmm_k4(ITERS)
        torch.cuda.synchronize()
        counts = {f.__name__: f.launches for f in every_kernel}
        r_pl = sdmm_tv(ITERS)
        torch.cuda.synchronize()
        check(r_k4.iterations == ITERS == r_pl.iterations
              and soft_fn.launches == 2 * ITERS
              and sum(counts.values()) == soft_fn.launches,
              f"sdmm TV {H} with K4: launches {counts} in {ITERS} "
              "iterations")
        check(torch.equal(r_k4.x, r_pl.x) and r_k4.errors == r_pl.errors
              and bool(torch.isfinite(r_k4.x).all()),
              f"sdmm TV {H}: K4 soft and operators.prox_soft differ")
        k4_soft_sdmm[H] = soft_fn.launches
        log(f"sdmm TV {H}x{H} with K4 soft as prox_g: equal to "
            f"operators.prox_soft bit for bit after {ITERS} iterations (x "
            f"and the errors); K4 soft launches {soft_fn.launches} = 2 per "
            "iteration, no other kernel of the port")
        # launches and blocking reads per iteration, and the marginal time
        for label, solve, nbytes in (("admm", admm_tv, 32 * P),
                                     ("sdmm", sdmm_tv, 56 * P),
                                     ("sdmm K4", sdmm_k4, 56 * P)):
            kern, k4_it, reads, reads_lo = per_iteration(solve, soft_fn)
            check(reads_lo >= 10 and reads <= 1.0,
                  f"{label} TV {H}: {reads} blocking reads per iteration "
                  f"({reads_lo} in 10 iterations)")
            check(k4_it == (2 if label == "sdmm K4" else 0),
                  f"{label} TV {H}: {k4_it} K4 kernels per iteration")
            log(f"{label} TV {H}x{H}: {kern:.1f} CUDA kernels per iteration "
                f"(K4's: {k4_it:.0f}), {reads:.2f} blocking host reads per "
                "iteration (torch.cuda.set_sync_debug_mode; "
                f"{reads_lo} in a call of 10 iterations)")
        m_a, m_s, m_k, m_k2, m_s2 = (marginal_ms(f, lo, hi) for f in (
            admm_tv, sdmm_tv, sdmm_k4, sdmm_k4, sdmm_tv))
        log(f"admm TV {H}x{H}: {m_a:.4f} ms/iter marginal ({lo}->{hi} "
            f"iterations), {32 * P / m_a / 1e6:.1f} GB/s of "
            f"{32 * P / 1e6:.0f} MB naive per iteration, on {card}")
        log(f"sdmm TV {H}x{H}: {min(m_s, m_s2):.4f} ms/iter marginal "
            f"({m_s:.4f}, {m_s2:.4f}; {lo}->{hi} iterations), "
            f"{56 * P / min(m_s, m_s2) / 1e6:.1f} GB/s of "
            f"{56 * P / 1e6:.0f} MB naive per iteration; with K4 soft as "
            f"prox_g {min(m_k, m_k2):.4f} ({m_k:.4f}, {m_k2:.4f}); order "
            f"plain, K4, K4, plain; on {card}")
        del truth, y_tv, admm_tv, sdmm_tv, sdmm_k4, full, half, rest, q
        del r_k4, r_pl
        torch.cuda.empty_cache()

    # bsdmm on the flagship
    bs = bsdmm_solvers(algorithms, tnmf, top, Y, A0, S0, Ww)
    reset_counts(every_kernel)
    bs_res = {}
    for label, solve in bs.items():
        W_ = Ww if label.startswith("weighted") else None
        r = solve(ITERS, trace=True) if "proxs_g" in label else solve(ITERS)
        torch.cuda.synchronize()
        bs_res[label] = r
        l0_, l_r = wloss(A0, S0, Y, W_), wloss(*r.x, Y, W_)
        check(r.iterations == ITERS and r.status == "max_iter",
              f"bsdmm {label}: {r.iterations} sweeps, status {r.status}")
        check(all(bool(torch.isfinite(a).all()) for a in r.x)
              and tuple(r.x[1].shape) == (K, N) and np.isfinite(l_r)
              and l_r < l0_, f"bsdmm {label}: non-finite, or loss {l0_:.6e} "
              f"-> {l_r:.6e}")
        extra = ""
        if "proxs_g" in label:
            # the constraint lives on Z: its columns sum to 1, and the
            # primal residual |S - Z| falls from the first sweep on
            Z = r.state["z"][1][0]
            dev1 = float((Z.sum(0) - 1).abs().max())
            lR = r.history[:, 1, 0]
            check(dev1 <= UNITY_SUM_ATOL and lR[-1] < lR[0],
                  f"bsdmm {label}: Z's columns sum to 1 within {dev1:.2e}; "
                  f"|R| {lR[0]:.4e} -> {lR[-1]:.4e}")
            extra = (f"; Z's columns sum to 1 within {dev1:.2e}, primal "
                     f"residual |S - Z| {lR[0]:.4e} -> {lR[-1]:.4e} (|S| "
                     f"{float(torch.linalg.norm(r.x[1])):.4e})")
        if label.startswith("weighted"):
            _, strides, nxt = r.state["steps_state"]
            extra = f"; final strides (A, S) {strides}, next refreshes {nxt}"
        log(f"bsdmm [{label}]: {ITERS} sweeps at e_rel=0: loss {l0_:.6e} -> "
            f"{l_r:.6e}{extra}")
    check(sum(f.launches for f in every_kernel) == 0,
          "bsdmm paths launched a kernel of the port")
    # with no proxs_g a bsdmm sweep is a Gauss-Seidel PGM step (the S
    # update sees the new A): the same sweeps written out by hand; PGM
    # itself updates both factors from the old ones, so only its loss is
    # set beside
    A_g, S_g = A0, S0
    for _ in range(ITERS):
        sA = tnmf.step_A(A_g, S_g)
        A_g = top.prox_plus(A_g - sA * ((A_g @ S_g - Y) @ S_g.T), sA)
        sS = tnmf.step_S(A_g, S_g)
        S_g = top.prox_plus(S_g - sS * (A_g.T @ (A_g @ S_g - Y)), sS)
    r_u = bs_res["unweighted"]
    n_A, n_S = norm_err(r_u.x[0], A_g), norm_err(r_u.x[1], S_g)
    check(n_A <= ENGINE_RTOL and n_S <= ENGINE_RTOL,
          f"bsdmm unweighted against Gauss-Seidel PGM by hand: normwise A "
          f"{n_A:.2e}, S {n_S:.2e} > {ENGINE_RTOL:g}")
    log(f"bsdmm [unweighted] against {ITERS} Gauss-Seidel PGM steps written "
        f"out by hand: normwise rel err A {n_A:.2e}, S {n_S:.2e} (tol "
        f"{ENGINE_RTOL:g}); loss {wloss(*r_u.x, Y):.6e} beside "
        f"nmf(engine='torch') PGM's {loss_pgm:.6e} after {ITERS} iterations "
        "(PGM updates both factors from the old ones)")
    # resumed sweeps equal straight ones, across refresh boundaries too
    for label, splits in (("unweighted", (ITERS // 4,) * 4),
                          ("sum-to-one S as proxs_g", (ITERS // 4,) * 4),
                          ("weighted stride 10", (7, ITERS - 7)),
                          ("weighted adaptive", (ITERS // 4,) * 4),
                          ("weighted adaptive", (STRIDE, ITERS - STRIDE))):
        x, state = None, None
        for n in splits:
            seg = bs[label](n, x, state)
            x, state = seg.x, seg.state
        straight = bs_res[label]
        check(all(torch.equal(a, b) for a, b in zip(x, straight.x))
              and state["it"] == ITERS
              and state["steps_state"][1:] == straight.state[
                  "steps_state"][1:],
              f"bsdmm {label}: resumed as {splits} differs from {ITERS} "
              "straight sweeps")
    log(f"bsdmm: unweighted, constrained and weighted adaptive resumed as 4 "
        f"x {ITERS // 4}, weighted stride 10 as 7 + {ITERS - 7} (inside a "
        f"segment) and weighted adaptive as {STRIDE} + {ITERS - STRIDE} (a "
        f"refresh boundary) equal {ITERS} straight sweeps bit for bit")
    for label, solve in bs.items():
        kern, _, reads, reads_lo = per_iteration(solve, soft_fn)
        log(f"bsdmm [{label}]: {kern:.1f} CUDA kernels per sweep, "
            f"{reads:.2f} blocking host reads per sweep (bsdmm's own one, "
            "and one per eigvalsh of a step; "
            f"{reads_lo} in a call of 10 sweeps)")

    def pgm_torch(n):
        return tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n)

    def pgm_weighted(n):
        return tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n, W=Ww,
                        step_stride=STRIDE, step_adapt=True)

    for label, twin_label, twin in (
            ("unweighted", "pgm engine=torch", pgm_torch),
            ("sum-to-one S as proxs_g", "pgm engine=torch", pgm_torch),
            ("weighted stride 10", "pgm weighted engine=torch adaptive",
             pgm_weighted),
            ("weighted adaptive", "pgm weighted engine=torch adaptive",
             pgm_weighted)):
        fn = bs[label]
        ms_t, ms_b, ms_b2, ms_t2 = (marginal_ms(f, LO, HI)
                                    for f in (twin, fn, fn, twin))
        log(f"bsdmm [{label}]: {min(ms_b, ms_b2):.4f} ms/sweep marginal "
            f"({ms_b:.4f}, {ms_b2:.4f}; {LO}->{HI} sweeps), {twin_label} "
            f"{min(ms_t, ms_t2):.4f} ms/iter ({ms_t:.4f}, {ms_t2:.4f}); "
            f"order pgm, bsdmm, bsdmm, pgm; on {card}")

    return k4_soft_sdmm[TV_SIZES[0][0]]


def driver_options_phase(mods, problem, card, every_kernel, kernel_fns,
                         prof_dir):
    """Phase 12: the solvers' options and the checkpoint on the card (see the
    module docstring). ``mods`` are the port's modules ``(algorithms, linop,
    tnmf, top, tops)``, ``problem`` the flagship ``(Y, A0, S0, Ww)``,
    ``kernel_fns`` the wrappers ``(K1, K2, K4 soft)``. Returns the launches
    of the checkpoint path by kernel: K1 with the float32 and with the
    bfloat16 store, K2 with the bfloat16 store, K4 soft."""
    from proxmin_tpu_torch import utils as tu
    from proxmin_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    algorithms, linop, tnmf, top, tops = mods
    Y, A0, S0, Ww = problem
    k1_fn, k2_fn, soft_fn = kernel_fns
    loss0 = wloss(A0, S0, Y)
    f = partial(tnmf.log_likelihood, Y=Y)
    grad = partial(tnmf.grad_likelihood, Y=Y)

    def nmf_solve(**kw):
        def solve(n, x=None, state=None):
            A, S = (A0, S0) if x is None else x
            return tnmf.nmf(Y, A, S, e_rel=0, max_iter=n, state=state, **kw)
        return solve

    def pgm_solve(grad_=grad, step=tnmf.step_pgm, **kw):
        def solve(n, x=None, state=None):
            return algorithms.pgm(
                list((A0, S0) if x is None else x), grad_, step,
                prox=[top.prox_plus] * 2, e_rel=0, max_iter=n, state=state,
                **kw)
        return solve

    def counts_of(solve):
        kern, _, reads, reads_lo = per_iteration(solve)
        return kern, reads, reads_lo

    # callbacks: NullCallback against no callback, in turns
    plain, with_cb = nmf_solve(), nmf_solve(callback=tu.NullCallback())
    timed(plain, 5)
    timed(with_cb, 5)
    (k_p, r_p, r_p10), (k_c, r_c, r_c10) = counts_of(plain), counts_of(with_cb)
    check(r_c == r_p and r_c10 == r_p10 and abs(k_c - k_p) < 0.5,
          f"callback=NullCallback(): {k_c:.1f} kernels and {r_c:.2f} "
          f"blocking reads per iteration, {k_p:.1f} and {r_p:.2f} without")
    ms_p, ms_c, ms_c2, ms_p2 = (marginal_ms(fn, LO, HI) for fn in (
        plain, with_cb, with_cb, plain))
    log(f"nmf engine=torch callback=NullCallback(): {min(ms_c, ms_c2):.4f} "
        f"ms/iter marginal ({ms_c:.4f}, {ms_c2:.4f}), no callback "
        f"{min(ms_p, ms_p2):.4f} ({ms_p:.4f}, {ms_p2:.4f}); order none, "
        f"callback, callback, none; {k_c:.1f} CUDA kernels and {r_c:.2f} "
        f"blocking reads per iteration with it, {k_p:.1f} and {r_p:.2f} "
        f"without ({r_c10} and {r_p10} in a call of 10 iterations); on "
        f"{card}")

    def stop_at(*X, it=None):
        if it == STOP_AT:
            raise StopIteration

    r = nmf_solve(callback=stop_at)(ITERS)
    check(r.iterations == STOP_AT and r.state["it"] == STOP_AT
          and r.status == "max_iter"
          and all(bool(torch.isfinite(a).all()) for a in (*r.x, *r.G)),
          f"StopIteration at it == {STOP_AT}: {r.iterations} iterations, "
          f"status {r.status}")
    log(f"nmf engine=torch, a callback raising StopIteration at it == "
        f"{STOP_AT}: stopped after {r.iterations} iterations, the final "
        "gradient computed")

    tb = tu.Traceback()

    def record_then_stop(*X, it=None):
        tb(*X, it=it)
        if it == TRACEBACK_ITERS:
            raise StopIteration

    r = nmf_solve(callback=record_then_stop)(ITERS)
    torch.cuda.synchronize()
    check(r.iterations == TRACEBACK_ITERS
          and len(tb.trace) == TRACEBACK_ITERS + 1
          and all(type(b) is np.ndarray for b in tb.trace[-1])
          and all(np.array_equal(b, x.cpu().numpy())
                  for b, x in zip(tb.trace[-1], r.x))
          and np.array_equal(tb.trace[0][1], S0.cpu().numpy()),
          "Traceback: its last entry differs from .x, or its first from S0")
    tb.clear()

    def with_tb(n):
        tb.clear()
        return tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n, callback=tb)

    t_null = min(timed(with_cb, TRACEBACK_ITERS) for _ in range(2))
    t_tb = min(timed(with_tb, TRACEBACK_ITERS) for _ in range(2))
    tb.clear()
    copied = TRACEBACK_ITERS * tensor_bytes(A0, S0)
    log(f"nmf engine=torch callback=Traceback(): {TRACEBACK_ITERS} "
        f"iterations in {t_tb * 1e3:.2f} ms ({t_tb / TRACEBACK_ITERS * 1e3:.4f}"
        f" ms/iter), with NullCallback {t_null * 1e3:.2f} ms "
        f"({t_null / TRACEBACK_ITERS * 1e3:.4f} ms/iter); its copies move "
        f"{copied / 1e6:.0f} MB to the host in the "
        f"{(t_tb - t_null) * 1e3:.2f} ms between: "
        f"{copied / max(t_tb - t_null, 1e-9) / 1e9:.2f} GB/s; the entry "
        f"recorded before iteration {TRACEBACK_ITERS} equals the .x of a "
        f"solve stopped there bit for bit; on {card}")

    # trace=True
    traced, untraced = pgm_solve(trace=True), pgm_solve()
    r_tr, r_before = traced(TRACE_ITERS), untraced(TRACE_ITERS - 1)
    last = [float(torch.sqrt(d / torch.clamp_min(nx, 1e-30)))
            for d, nx in (tu.fixed_point_norms(x, xp)
                          for x, xp in zip(r_tr.x, r_before.x))]
    h = r_tr.history
    check(h.shape == (TRACE_ITERS, 2) and h.dtype == np.float32
          and bool(np.isfinite(h).all()) and untraced(3).history is None,
          f"pgm trace=True: history of shape {h.shape}, {h.dtype}")
    check(np.allclose(h[-1], last, rtol=TRACE_RTOL, atol=0),
          f"pgm trace=True: last row {h[-1]} against the residual of the "
          f"last two iterates {last}")
    (k_t, r_t, r_t10), (k_u, r_u, r_u10) = (counts_of(traced),
                                            counts_of(untraced))
    # the trace's one copy to the host comes at the end of the solve
    check(r_t == r_u and r_t10 == r_u10 + 1,
          f"pgm trace=True: {r_t:.2f} blocking reads per iteration ({r_t10} "
          f"in a call of 10), {r_u:.2f} without ({r_u10})")
    log(f"pgm trace=True on the flagship gradient: history {h.shape}, "
        f"residuals (A, S) {h[0]} -> {h[-1]}, the last row equal to the "
        f"residual of the last two iterates within {TRACE_RTOL:g} "
        f"(bitwise: {bool((h[-1] == np.float32(last)).all())}); "
        f"{k_t:.1f} CUDA kernels and {r_t:.2f} blocking reads per iteration "
        f"with the trace, {k_u:.1f} and {r_u:.2f} without ({r_t10} and "
        f"{r_u10} in a call of 10 iterations: the history's one copy at the "
        "end)")

    # backtracking from constant steps, the Lipschitz ones of the start
    # iterate with A's taken BT_FACTOR times too long
    sA0, sS0 = (float(v) for v in tnmf.step_pgm(A0, S0))
    long_A, both_long = (BT_FACTOR * sA0, sS0), (BT_FACTOR * sA0,
                                                 BT_FACTOR * sS0)
    for accelerated in (False, True):
        label = "FISTA" if accelerated else "plain"
        # the same loop with constant steps and no line search
        k_loop, r_loop, _ = counts_of(pgm_solve(step=(sA0, sS0),
                                                accelerated=accelerated))
        bt = pgm_solve(step=long_A, accelerated=accelerated,
                       backtracking=True, f=f)
        r_bt = bt(BT_ITERS)
        r_no = pgm_solve(step=long_A, accelerated=accelerated)(BT_ITERS)
        torch.cuda.synchronize()
        l_bt, l_no = wloss(*r_bt.x, Y), wloss(*r_no.x, Y)
        T = r_bt.state["T"].tolist()
        check(r_bt.iterations == BT_ITERS and np.isfinite(l_bt)
              and l_bt < loss0 and T[0] < 1.0
              and all(bool(torch.isfinite(a).all()) for a in r_bt.x),
              f"backtracking [{label}]: loss {loss0:.6e} -> {l_bt:.6e}, "
              f"T {T}")
        check(r_no.status == "diverged" or not l_no < loss0,
              f"A's step {BT_FACTOR} times too long without backtracking "
              f"[{label}]: status {r_no.status}, loss {l_no:.6e}")
        kern, reads, reads10 = counts_of(bt)
        log(f"pgm backtracking [{label}], constant steps, A's {BT_FACTOR} x "
            f"step_pgm(A0, S0)'s, {BT_ITERS} iterations: loss {loss0:.6e} "
            f"-> {l_bt:.6e}, T (A, S) {T}; without backtracking: status "
            f"{r_no.status} after {r_no.iterations} iterations; {kern:.1f} "
            f"CUDA kernels and {reads:.2f} blocking reads per iteration "
            f"once T has settled ({k_loop:.1f} and {r_loop:.2f} for the same "
            f"loop without the line search), {reads10} reads in the first "
            "10 iterations, halvings included")
    # with both steps too long the rule (the block with the steepest
    # relative update halves) can keep halving the block that is not at
    # fault, up to the cap: the reference's rule, as the JAX package has it
    r_both = pgm_solve(step=both_long, backtracking=True, f=f)(BT_ITERS)
    T = r_both.state["T"].tolist()
    check(r_both.iterations == BT_ITERS and min(T) < 1.0
          and all(bool(torch.isfinite(a).all()) for a in r_both.x),
          f"backtracking, both steps {BT_FACTOR} times too long: T {T}")
    log(f"pgm backtracking [plain], both steps {BT_FACTOR} x "
        f"step_pgm(A0, S0)'s, {BT_ITERS} iterations: loss {loss0:.6e} -> "
        f"{wloss(*r_both.x, Y):.6e}, T (A, S) {T}")

    # grad=None against the explicit gradient, in turns
    by_f = pgm_solve(grad_=None, f=f)
    r_f, r_g = by_f(GRAD_NONE_ITERS), untraced(GRAD_NONE_ITERS)
    n_A, n_S = (norm_err(r_f.x[i], r_g.x[i]) for i in (0, 1))
    check(n_A <= GRAD_NONE_RTOL and n_S <= GRAD_NONE_RTOL
          and not r_f.x[1].requires_grad,
          f"grad=None against grad_likelihood after {GRAD_NONE_ITERS} "
          f"iterations: normwise A {n_A:.2e}, S {n_S:.2e} > "
          f"{GRAD_NONE_RTOL:g}")
    (k_f, rd_f, _), (k_g, rd_g, _) = counts_of(by_f), counts_of(untraced)
    check(rd_f == rd_g, f"grad=None: {rd_f:.2f} blocking reads per "
          f"iteration, {rd_g:.2f} with the explicit gradient")
    ms_g, ms_f, ms_f2, ms_g2 = (
        marginal_ms(fn, GRAD_NONE_LO, GRAD_NONE_HI)
        for fn in (untraced, by_f, by_f, untraced))
    log(f"pgm grad=None (autograd of log_likelihood) against "
        f"grad_likelihood, {GRAD_NONE_ITERS} iterations: normwise rel err "
        f"A {n_A:.2e}, S {n_S:.2e} (tol {GRAD_NONE_RTOL:g}); "
        f"{min(ms_f, ms_f2):.4f} ms/iter marginal ({ms_f:.4f}, {ms_f2:.4f};"
        f" {GRAD_NONE_LO}->{GRAD_NONE_HI} iterations), explicit "
        f"{min(ms_g, ms_g2):.4f} ({ms_g:.4f}, {ms_g2:.4f}); order explicit, "
        f"f, f, explicit; {k_f:.1f} CUDA kernels per iteration against "
        f"{k_g:.1f}, {rd_f:.2f} blocking reads against {rd_g:.2f}; on "
        f"{card}")

    # Barzilai-Borwein steps
    for bb_type in (1, 2):
        bb = pgm_solve(step=tu.BarzilaiBorweinStepper(type=bb_type))
        full, half = bb(BB_ITERS), bb(BB_ITERS // 2)
        rest = bb(BB_ITERS - BB_ITERS // 2, half.x, half.state)
        torch.cuda.synchronize()
        l_bb = wloss(*full.x, Y)
        check(full.iterations == BB_ITERS and np.isfinite(l_bb)
              and l_bb < loss0, f"BB{bb_type}: loss {loss0:.6e} -> "
              f"{l_bb:.6e}")
        check(all(torch.equal(a, b) for a, b in zip(rest.x, full.x))
              and rest.state["it"] == BB_ITERS
              and torch.equal(rest.state["stepper_state"][2],
                              full.state["stepper_state"][2]),
              f"BB{bb_type}: {BB_ITERS // 2} + {BB_ITERS // 2} resumed "
              f"iterations differ from {BB_ITERS} straight ones")
        kern, reads, _ = counts_of(bb)
        log(f"pgm BarzilaiBorweinStepper(type={bb_type}), {BB_ITERS} "
            f"iterations: loss {loss0:.6e} -> {l_bb:.6e}, last steps "
            + ", ".join(f"{float(s):.3e}" for s in full.S)
            + f"; {BB_ITERS // 2} + {BB_ITERS // 2} resumed equal "
            f"{BB_ITERS} straight bit for bit; {kern:.1f} CUDA kernels and "
            f"{reads:.2f} blocking reads per iteration")

    # checkpoint: run, save, drop every tensor, load onto the card, resume
    _, _, _, _, sdmm_k4 = tv_solvers(algorithms, linop, top, tops,
                                     TV_SIZES[0][0])
    half_half = (ITERS // 2, ITERS - ITERS // 2)
    on_boundary = (STRIDE, ITERS - STRIDE)
    bf16 = torch.bfloat16
    # (label, solve, its kernel's wrapper, launches per iteration, weights
    # of its loss (False: not an NMF solve), the splits)
    configs = (
        ("pgm engine=cuda exact", nmf_solve(engine="cuda"), k1_fn, 1, None,
         (half_half,)),
        ("pgm weighted engine=cuda adaptive bf16 store", nmf_solve(
            engine="cuda", W=Ww, step_stride=STRIDE, step_adapt=True,
            store_dtype=bf16), k1_fn, 1, Ww, (half_half, on_boundary)),
        ("adaprox engine=cuda bf16 store and moments", nmf_solve(
            algorithm="adaprox", engine="cuda", store_dtype=bf16,
            moment_dtype=bf16), k2_fn, 1, None, (half_half,)),
        ("pgm engine=torch FISTA + backtracking", nmf_solve(
            accelerated=True, backtracking=True, f=f), None, 0, None,
         (half_half,)),
        ("sdmm TV 1024x1024 K4 soft", sdmm_k4, soft_fn, 2, False,
         (half_half,)),
        ("bsdmm weighted adaptive", nmf_solve(
            algorithm="bsdmm", W=Ww, step_stride=STRIDE, step_adapt=True),
         None, 0, Ww, (half_half, on_boundary)),
    )

    def blocks(x):
        return x if isinstance(x, (tuple, list)) else (x,)

    launches = []
    with tempfile.TemporaryDirectory(dir=prof_dir.parent) as tmp:
        for label, solve, kernel_fn, per_iter, W_, split_list in configs:
            reset_counts(every_kernel)
            straight = solve(ITERS)
            torch.cuda.synchronize()
            check(straight.iterations == ITERS and all(
                bool(torch.isfinite(a).all()) for a in blocks(straight.x)),
                f"checkpoint [{label}]: {straight.iterations} iterations, "
                "or a non-finite iterate")
            if W_ is not False:
                l0_, l_s = wloss(A0, S0, Y, W_), wloss(*straight.x, Y, W_)
                check(np.isfinite(l_s) and l_s < l0_,
                      f"checkpoint [{label}]: loss {l0_:.6e} -> {l_s:.6e}")
            files = []
            for splits in split_list:
                x = state = None
                for i, n in enumerate(splits):
                    seg = solve(n, x, state)
                    if i + 1 == len(splits):
                        break
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    path = save_checkpoint(
                        os.path.join(tmp, re.sub(r"\W+", "_", label)),
                        x=seg.x, solver_state=seg.state)
                    t_save = time.perf_counter() - t0
                    # the killed process: nothing of the solve survives
                    # but the file
                    del seg, x, state
                    torch.cuda.empty_cache()
                    t0 = time.perf_counter()
                    ck = load_checkpoint(path)
                    torch.cuda.synchronize()
                    t_load = time.perf_counter() - t0
                    x, state = ck["x"], ck["solver_state"]
                    del ck
                    check(all(a.is_cuda for a in blocks(x)),
                          f"checkpoint [{label}]: loaded off the card")
                    files.append((splits, os.path.getsize(path), t_save,
                                  t_load))
                check(all(torch.equal(a, b) for a, b in zip(
                    blocks(seg.x), blocks(straight.x)))
                    and seg.iterations == splits[-1],
                    f"checkpoint [{label}]: resumed from the file as "
                    f"{splits} differs from {ITERS} straight iterations")
            counts = {fn.__name__: fn.launches for fn in every_kernel}
            ran = ITERS * (1 + len(split_list))
            check(sum(counts.values()) == per_iter * ran and (
                kernel_fn is None or kernel_fn.launches == per_iter * ran),
                f"checkpoint [{label}]: launches {counts} in {ran} "
                "iterations")
            launches.append(kernel_fn.launches if kernel_fn else 0)
            log(f"checkpoint [{label}]: " + "; ".join(
                f"{a} + {b} through a file of {size / 1e6:.1f} MB (saved "
                f"in {t_s:.3f} s, loaded onto the card in {t_l:.3f} s)"
                for (a, b), size, t_s, t_l in files)
                + f": equal to {ITERS} straight iterations bit for bit"
                + (f"; {kernel_fn.__name__} launches {kernel_fn.launches} "
                   f"= {per_iter} per iteration, no other kernel"
                   if kernel_fn else "; no kernel of the port")
                + f"; on {card}")
    return {"K1": launches[0], "K1 bf16 store": launches[1],
            "K2 bf16 store": launches[2], "K4 soft": launches[4]}


def functional_phase(mods, problem, card, every_kernel, kernel_fns):
    """Phase 13: the functional factories on the card (see the module
    docstring). ``mods`` are the port's modules ``(algorithms, linop, tnmf,
    top, tops)``, ``problem`` the flagship ``(Y, A0, S0, Ww)``,
    ``kernel_fns`` the wrappers ``(K3, K4 soft)``. Returns their launches
    on the factories' paths."""
    from proxmin_tpu_torch import functional as tfn

    algorithms, linop, tnmf, top, tops = mods
    Y, A0, S0, Ww = problem
    k3_fn, soft_fn = kernel_fns
    launches = {"K3": 0, "K4 soft": 0}

    # (a) each factory against its driver, bit for bit
    def k3_grad(A_, S_):
        return tops.fused_nmf_grad(A_, S_, Y)[:2]

    pgm_kw = dict(prox=[top.prox_plus] * 2, e_rel=0)
    truth, y_tv = tv_problem(FN_TV_H)
    Dh, Dv = tv_operators(linop, FN_TV_H)
    x0_tv = torch.zeros_like(y_tv)

    def prox_quad(x, step):
        return (x + step * y_tv) / (1.0 + step)

    k4_soft = partial(tops.prox_soft_pallas, thresh=TV_LAM)
    unity = [None, [partial(top.prox_unity, axis=0)]]

    def block_prox_f(Xj, step, Xs=None, j=None):
        A, S = Xs
        D = A @ S - Y
        return top.prox_plus(Xj - step * (D @ S.T if j == 0 else A.T @ D),
                             step)

    def block_step(Xs, j=None):
        return tnmf.step_A(*Xs) if j == 0 else tnmf.step_S(*Xs)

    tv = dict(e_rel=0, e_abs=0)
    pairs = (
        ("make_pgm_solver, K3 gradient, flagship", k3_fn, 1,
         lambda n: tfn.make_pgm_solver(k3_grad, tnmf.step_pgm, max_iter=n,
                                       **pgm_kw)(A0, S0)[0],
         lambda n: algorithms.pgm([A0, S0], k3_grad, tnmf.step_pgm,
                                  max_iter=n, **pgm_kw).x),
        (f"make_admm_solver, TV {FN_TV_H}x{FN_TV_H}, K4 soft as prox_g",
         soft_fn, 1,
         lambda n: tfn.make_admm_solver(prox_quad, TV_STEP_F, prox_g=k4_soft,
                                        L=Dh, max_iter=n, **tv)(x0_tv)[0],
         lambda n: algorithms.admm(x0_tv, prox_quad, TV_STEP_F,
                                   prox_g=k4_soft, L=Dh, max_iter=n,
                                   **tv).x),
        (f"make_sdmm_solver, TV {FN_TV_H}x{FN_TV_H}, K4 soft as prox_g",
         soft_fn, 2,
         lambda n: tfn.make_sdmm_solver(prox_quad, TV_STEP_F, [k4_soft] * 2,
                                        Ls=[Dh, Dv], max_iter=n,
                                        **tv)(x0_tv)[0],
         lambda n: algorithms.sdmm(x0_tv, prox_quad, TV_STEP_F,
                                   proxs_g=[k4_soft] * 2, Ls=[Dh, Dv],
                                   max_iter=n, **tv).x),
        ("make_bsdmm_solver, sum-to-one S, flagship", None, 0,
         lambda n: tfn.make_bsdmm_solver(block_prox_f, block_step,
                                         proxs_g=unity, e_rel=0,
                                         max_iter=n)(A0, S0)[0],
         lambda n: algorithms.bsdmm([A0, S0], block_prox_f, block_step,
                                    proxs_g=unity, e_rel=0,
                                    max_iter=n).x),
    )
    for label, kern, per_it, factory, driver in pairs:
        reset_counts(every_kernel)
        xf = factory(ITERS)
        torch.cuda.synchronize()
        counts = {f.__name__: f.launches for f in every_kernel}
        k_launches = kern.launches if kern is not None else 0
        xd = driver(ITERS)
        torch.cuda.synchronize()
        xf, xd = as_blocks(xf), as_blocks(xd)
        check(len(xf) == len(xd) and all(torch.equal(a, b)
                                         for a, b in zip(xf, xd)),
              f"{label}: the factory differs from its driver after {ITERS} "
              "iterations")
        check(all(bool(torch.isfinite(a).all()) for a in xf),
              f"{label}: non-finite iterate")
        want = per_it * ITERS
        check(k_launches == want and sum(counts.values()) == want,
              f"{label}: launches {counts} in {ITERS} iterations, "
              f"{want} expected")
        if kern is not None:
            launches["K3" if kern is k3_fn else "K4 soft"] += k_launches
        r_f = [blocking_reads(lambda n=n: factory(n)) for n in (10, 10, 20)]
        r_d = [blocking_reads(lambda n=n: driver(n)) for n in (10, 10, 20)]
        reads_f, reads_d = (r_f[2] - r_f[1]) / 10, (r_d[2] - r_d[1]) / 10
        check(reads_f == reads_d,
              f"{label}: {reads_f} blocking reads per iteration, the driver "
              f"{reads_d}")
        kern_it = (launches_of(lambda: factory(20))
                   - launches_of(lambda: factory(10))) / 10
        timed(factory, 5)
        timed(driver, 5)
        ms_d, ms_f, ms_f2, ms_d2 = (turn_ms(f) for f in (driver, factory,
                                                         factory, driver))
        log(f"functional [{label}]: equal to its driver bit for bit after "
            f"{ITERS} iterations; "
            + (f"{kern.__name__} launches {k_launches} = {per_it} per "
               "iteration, " if kern else "no kernel of the port, ")
            + f"{kern_it:.1f} CUDA kernels and {reads_f:.2f} blocking reads "
            f"per iteration (the driver {reads_d:.2f}); marginal ms/iter "
            f"factory {min(ms_f, ms_f2):.4f} ({ms_f:.4f}, {ms_f2:.4f}), "
            f"driver {min(ms_d, ms_d2):.4f} ({ms_d:.4f}, {ms_d2:.4f}); order "
            f"driver, factory, factory, driver; on {card}")

    # (b) the flagship image as FN_PATCHES patches under torch.func.vmap
    B, Np = FN_PATCHES, FN_PATCH_N
    check(B * Np == N, "the patches cut the flagship image")

    def patches(T):
        return T.reshape(T.shape[0], B, Np).permute(1, 0, 2).contiguous()

    Yb, S0b, Wb = patches(Y), patches(S0), patches(Ww)
    A0b = A0.expand(B, C, K).contiguous()
    sample = np.sort(np.random.default_rng(SEED).choice(B, FN_SAMPLE,
                                                        replace=False))
    vmap = torch.func.vmap

    def lane_losses(A, S, Yp, Wp=None):
        R = A.double() @ S.double() - Yp.double()
        return 0.5 * torch.sum((1.0 if Wp is None else Wp.double()) * R * R,
                               dim=(1, 2))

    for weighted in (False, True):
        wl = "weighted" if weighted else "unweighted"
        args = (A0b, S0b, Yb) + ((Wb,) if weighted else ())

        def lane(a, b):
            return tuple(t[b] for t in a)

        fixed = tfn.make_nmf_solver(e_rel=0, max_iter=ITERS,
                                    weighted=weighted)
        t0 = time.perf_counter()
        Ab, Sb, itb, _ = vmap(fixed)(*args)
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
        check(tuple(Sb.shape) == (B, K, Np) and bool((itb == ITERS).all()),
              f"batched NMF [{wl}]: shape {tuple(Sb.shape)}, iterations "
              f"{sorted(set(itb.tolist()))}")
        errs = []
        for b in (0, B - 1):
            Ai, Si, iti, _ = fixed(*lane(args, b))
            errs.append((norm_err(Ab[b], Ai), norm_err(Sb[b], Si)))
            check(max(errs[-1]) <= ENGINE_RTOL and int(iti) == ITERS,
                  f"batched NMF [{wl}]: lane {b} against its own solve "
                  f"after {ITERS} iterations: normwise {errs[-1]} > "
                  f"{ENGINE_RTOL:g}")
        l0 = lane_losses(A0b, S0b, Yb, Wb if weighted else None)
        l1 = lane_losses(Ab, Sb, Yb, Wb if weighted else None)
        check(bool(torch.isfinite(l1).all()) and bool((l1 < l0).all()),
              f"batched NMF [{wl}]: a lane's loss did not fall")
        # to the tolerance: each lane stops on its own
        solve = tfn.make_nmf_solver(e_rel=FN_E_REL, max_iter=FN_MAX_ITER,
                                    weighted=weighted)
        Ac, Sc, itc, convc = vmap(solve)(*args)
        its_lane = {b: (int(itc[b]), int(solve(*lane(args, b))[2]))
                    for b in (0, B - 1)}
        flips = {b: v for b, v in its_lane.items() if v[0] != v[1]}
        # float32: the batched products sum in other orders than the single
        # ones, so a lane near its threshold may stop one iteration apart
        check(all(abs(a - b) <= 1 for a, b in flips.values()),
              f"batched NMF [{wl}]: iterations to e_rel={FN_E_REL:g} "
              f"(batched, own solve) {its_lane}")

        def batch_run(n):
            vmap(tfn.make_nmf_solver(e_rel=0, max_iter=n,
                                     weighted=weighted))(*args)

        def sample_run(n):
            one = tfn.make_nmf_solver(e_rel=0, max_iter=n, weighted=weighted)
            for b in sample:
                one(*lane(args, int(b)))

        timed(batch_run, 3)
        timed(sample_run, 3)
        ms_b, ms_s, ms_s2, ms_b2 = (turn_ms(f, FN_LO, FN_HI)
                                    for f in (batch_run, sample_run,
                                              sample_run, batch_run))
        ms_batch, ms_one = min(ms_b, ms_b2), min(ms_s, ms_s2) / FN_SAMPLE
        launches_b = (launches_of(lambda: batch_run(2 * FN_LO))
                      - launches_of(lambda: batch_run(FN_LO))) / FN_LO
        reads_b = (blocking_reads(lambda: batch_run(2 * FN_LO))
                   - blocking_reads(lambda: batch_run(FN_LO))) / FN_LO
        log(f"functional [make_nmf_solver {wl}, torch.func.vmap over {B} "
            f"patches of {Np} pixels]: {ITERS} iterations in "
            f"{t_batch:.3f} s; lanes 0 and {B - 1} against their own solves "
            "normwise (A, S) "
            + "; ".join(f"{a:.2e}, {b:.2e}" for a, b in errs)
            + f" (tol {ENGINE_RTOL:g}); every lane's loss falls ("
            f"{float(l0.sum()):.6e} -> {float(l1.sum()):.6e} in all); to "
            f"e_rel={FN_E_REL:g}: lanes stop at {int(itc.min())}-"
            f"{int(itc.max())} iterations ({int(convc.sum())} of {B} "
            "converged), lanes 0 and B-1 (batched, own solve) "
            + ", ".join(f"{v[0]}, {v[1]}" for v in its_lane.values())
            + (f" (a rounding flip at {sorted(flips)}: float32 batched "
               "products sum in another order)" if flips else " equal")
            + f"; marginal ms/iter: the batch {ms_batch:.4f} ({ms_b:.4f}, "
            f"{ms_b2:.4f}), one patch {ms_one:.4f} (the {FN_SAMPLE} seeded "
            f"patches {sample.tolist()} in {min(ms_s, ms_s2):.4f}), "
            f"{B} patches one by one ~{ms_one * B:.4f} (scaled), "
            f"{ms_one * B / ms_batch:.1f} times the batch; order batch, "
            f"patches, patches, batch; the batch runs {launches_b:.1f} CUDA "
            f"kernels and {reads_b:.2f} blocking reads per iteration; on "
            f"{card}")

    # (c) implicit gradients against central differences, float64
    f64 = torch.float64
    A64, Y64 = A0.to(f64), Y.to(f64)
    L_ift = float(torch.linalg.eigvalsh(A64.T @ A64)[-1]) + IFT_MU
    evals = [0]

    def nnls_grad(S, Yp):
        evals[0] += 1
        return A64.T @ (A64 @ S - Yp) + IFT_MU * S

    solve = tfn.make_differentiable_pgm_solver(
        nnls_grad, 1.0 / L_ift, prox=top.prox_plus, e_rel=IFT_E_REL,
        max_iter=IFT_MAX_ITER, vjp_iters=IFT_MAX_ITER, vjp_rtol=IFT_E_REL)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    wv = torch.randn((K, N), dtype=f64, device=DEVICE, generator=gen)
    d = torch.randn((C, N), dtype=f64, device=DEVICE, generator=gen)
    S_zero = torch.zeros((K, N), dtype=f64, device=DEVICE)
    theta = Y64.clone().requires_grad_(True)
    t0 = time.perf_counter()
    S_star, conv = solve(S_zero, theta)
    torch.cuda.synchronize()
    t_fwd, n_fwd = time.perf_counter() - t0, evals[0]
    check(bool(conv), f"IFT NNLS: the forward pass did not converge in "
          f"{n_fwd} iterations")
    t0 = time.perf_counter()
    (g,) = torch.autograd.grad(torch.sum(wv * S_star), theta)
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    with torch.no_grad():
        slack = torch.where(S_star > 0, S_star, nnls_grad(S_star, Y64))
        kept = slack.min(dim=0).values >= IFT_MARGIN
        d = d * kept
        d = d / torch.linalg.norm(d)
    gd = float(torch.sum(g * d))
    with torch.no_grad():
        lp, lm = (float(torch.sum(
            wv * solve(S_zero, Y64 + sg * IFT_EPS * d)[0])) for sg in (1, -1))
    fd = (lp - lm) / (2 * IFT_EPS)
    err = abs(fd - gd) / abs(gd)
    log(f"functional [make_differentiable_pgm_solver, float64 NNLS in S at "
        f"C={C} K={K} N={N}, A0 fixed, ridge {IFT_MU:g}, theta = Y]: forward "
        f"{n_fwd} iterations to e_rel={IFT_E_REL:g} in {t_fwd:.2f} s, "
        f"backward (the adjoint to {IFT_E_REL:g}) {t_bwd:.2f} s; zero "
        f"fraction of S* {float((S_star == 0).double().mean()):.4f}; "
        f"d/dY <w, S*> along a seeded unit direction on the "
        f"{float(kept.double().mean()):.4f} of the pixels away from a change "
        f"of the active set: implicit {gd:.10e}, central difference (step "
        f"{IFT_EPS:g}) {fd:.10e}, rel {err:.2e} (tol {IFT_RTOL:g}); on {card}")
    check(np.isfinite(gd) and err <= IFT_RTOL,
          f"IFT NNLS: implicit {gd:.10e} against central difference "
          f"{fd:.10e}: rel {err:.2e} > {IFT_RTOL:g}")

    truth64, y64 = truth.to(f64), y_tv.to(f64)
    evals[0] = 0

    def tv_prox_f(x, step, lam):
        evals[0] += 1
        return (x + step * y64) / (1.0 + step)

    tv_solve = tfn.make_differentiable_admm_solver(
        tv_prox_f, TV_STEP_F, lambda v, step, lam: top.prox_soft(
            v, step, thresh=lam), L=Dh, e_rel=IFT_TV_E_REL,
        max_iter=IFT_MAX_ITER, vjp_iters=IFT_MAX_ITER, vjp_rtol=IFT_TV_E_REL,
        prox_params=True)
    x0_64 = torch.zeros_like(y64)
    lam = torch.tensor(TV_LAM, dtype=f64, device=DEVICE, requires_grad=True)
    t0 = time.perf_counter()
    x_star, conv = tv_solve(x0_64, lam)
    torch.cuda.synchronize()
    t_fwd, n_fwd = time.perf_counter() - t0, evals[0]
    check(bool(conv), f"IFT TV: the forward pass did not converge in "
          f"{n_fwd} iterations")
    t0 = time.perf_counter()
    (g,) = torch.autograd.grad(torch.mean((x_star - truth64) ** 2), lam)
    torch.cuda.synchronize()
    t_bwd, g = time.perf_counter() - t0, float(g)
    with torch.no_grad():
        lp, lm = (float(torch.mean((tv_solve(x0_64, lam + sg * IFT_TV_EPS)[0]
                                    - truth64) ** 2)) for sg in (1, -1))
    fd = (lp - lm) / (2 * IFT_TV_EPS)
    err = abs(fd - g) / abs(g)
    log(f"functional [make_differentiable_admm_solver, float64 TV denoise "
        f"{FN_TV_H}x{FN_TV_H}, penalty {TV_LAM:g} learned through prox_g]: "
        f"forward {n_fwd} iterations to e_rel={IFT_TV_E_REL:g} in "
        f"{t_fwd:.2f} s, backward {t_bwd:.2f} s; d MSE / d lam: implicit "
        f"{g:.10e}, central difference (step {IFT_TV_EPS:g}) {fd:.10e}, rel "
        f"{err:.2e} (tol {IFT_TV_RTOL:g}); on {card}")
    check(np.isfinite(g) and err <= IFT_TV_RTOL,
          f"IFT TV: implicit {g:.10e} against central difference {fd:.10e}: "
          f"rel {err:.2e} > {IFT_TV_RTOL:g}")
    functional_lanes_paths(tfn, top, problem, card)
    return launches


def lanes_of(t, B):
    """A tensor inside ``torch.func.vmap`` as a plain tensor whose first
    dimension is the lane (an unbatched one stands for every lane)."""
    F = torch._C._functorch
    batched = False
    while F.is_batchedtensor(t) or F.is_gradtrackingtensor(t):
        if F.is_batchedtensor(t):
            t = F.get_unwrapped(t).movedim(F.maybe_get_bdim(t), 0)
            batched = True
        else:
            t = F.get_unwrapped(t)
    t = t.detach()
    return t if batched else t.expand(B, *t.shape)


def counting(module, name):
    """``module.name`` patched to count its calls: ``(patch, counter)``."""
    from unittest import mock

    real = getattr(module, name)
    counter = [0]

    def counted(*args, **kwargs):
        counter[0] += 1
        return real(*args, **kwargs)

    return mock.patch.object(module, name, counted), counter


def first_test_thresholds(A, S0b, Yb, L):
    """Each lane's largest step whose first PGM trial point from ``S0b``
    (``prox_plus``) passes backtracking's test, bisected in log step. For
    the quadratic ``f`` the test ``f(x + d) <= f(x) + <G, d> + |d|^2 / (2
    s)`` is ``s |A d|^2 <= |d|^2``."""
    B = S0b.shape[0]
    G = A.T @ (A @ S0b - Yb)
    lo = torch.full((B,), 1e-3 / L, dtype=S0b.dtype, device=S0b.device)
    hi = torch.full((B,), 1e3 / L, dtype=S0b.dtype, device=S0b.device)
    for _ in range(FN_BT_BISECT):
        mid = torch.sqrt(lo * hi)
        D = torch.clamp_min(S0b - mid[:, None, None] * G, 0) - S0b
        ok = mid * (A @ D).square().sum((1, 2)) <= D.square().sum((1, 2))
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def functional_lanes_paths(tfn, top, problem, card):
    """Phase 13's paths through the lanes controller's inner loops and the
    implicit gradients under ``torch.func`` (see FN_BT_HALVINGS): each
    prints and checks its sampled lanes against their own solves, its
    launches and blocking reads per batch iteration (the sync debug mode,
    beside the profiler's device-to-host copies), its inner rounds per
    iteration and its ms/iter against the sampled own solves scaled to the
    batch."""
    import importlib
    from unittest import mock

    pgm_mod = importlib.import_module("proxmin_tpu_torch.solvers.pgm")
    ada_mod = importlib.import_module("proxmin_tpu_torch.solvers.adaprox")
    Y, A0, S0, _ = problem
    B, Np = FN_PATCHES, FN_PATCH_N
    f64 = torch.float64
    vmap = torch.func.vmap

    def patches(T):
        return (T.reshape(T.shape[0], B, Np).permute(1, 0, 2).contiguous()
                .to(f64))

    Yb, S0b, A = patches(Y), patches(S0), A0.to(f64)
    L = float(torch.linalg.eigvalsh(A.T @ A)[-1])
    sample = [int(b) for b in np.sort(np.random.default_rng(SEED).choice(
        B, FN_SAMPLE, replace=False))]

    def grad(Yp):
        return lambda S: A.T @ (A @ S - Yp)

    # (a) backtracking
    th = torch.sort(first_test_thresholds(A, S0b, Yb, L)).values
    mid = 0.5 * (th[B // 2 - 1] + th[B // 2])
    gap = float((th[B // 2] - th[B // 2 - 1]) / mid)
    step_bt = float(2 ** FN_BT_HALVINGS * mid)

    def bt_lane(S0p, Yp, n=FN_LANES_MAX_ITER):
        return tfn.make_pgm_solver(
            grad(Yp), step_bt, prox=top.prox_plus, backtracking=True,
            f=lambda S: 0.5 * torch.sum((A @ S - Yp) ** 2), e_rel=FN_E_REL,
            max_iter=n)(S0p)

    # (b) the prox sub-iterations
    unity = partial(top.prox_unity_plus, axis=0)
    rounds = [0]

    def unity_counted(x, step):
        rounds[0] += 1
        return unity(x, step)

    def ada_lane(S0p, Yp, n=FN_LANES_MAX_ITER):
        out = tfn.make_adaprox_solver(
            grad(Yp), FN_ADA_STEP, prox=unity_counted, e_rel=FN_E_REL,
            max_iter=n, prox_max_iter=FN_ADA_SUB)(S0p)
        return out[0], out[4], out[5], out[6]

    paths = (("make_pgm_solver(backtracking=True), prox_plus, step "
              f"{step_bt / (1 / L):.6f}/L", bt_lane, pgm_mod,
              "halving rounds (one read each)"),
             (f"make_adaprox_solver(prox=prox_unity_plus(axis=0)), step "
              f"{FN_ADA_STEP:g}", ada_lane, ada_mod,
              "sub-iteration rounds"))
    for label, lane, mod, inner in paths:
        out = {}
        patch, inner_reads = counting(mod, "any_lane")
        seen = {}
        real_run = tfn.run_lanes

        def spy(st, *a, **k):
            r = real_run(st, *a, **k)
            if "T" in st:
                seen["T"] = lanes_of(st["T"], B)
            return r

        t0 = time.perf_counter()
        vmap(lane)(S0b, Yb)
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
        # counted on the second run: a process's first counted call of a
        # path was seen to show one stray wait
        rounds[0] = 0
        with patch, mock.patch.object(tfn, "run_lanes", spy):
            reads, sites = reads_in(
                lambda: out.update(r=vmap(lane)(S0b, Yb)))
        x, its, conv, div = out["r"]
        n_it, n_in, n_rounds = int(its.max()), inner_reads[0], rounds[0]
        # what a solve reads once, before its loop (the carry's scalars
        # filled from the host)
        setup = reads_in(lambda: vmap(partial(lane, n=0))(S0b, Yb))[0]
        copies = dtoh_copies(lambda: vmap(lane)(S0b, Yb))
        copies0 = dtoh_copies(lambda: vmap(partial(lane, n=0))(S0b, Yb))
        check(bool(conv.all()) and not bool(div.any()),
              f"{label}: {int(conv.sum())} of {B} lanes converged")
        check(len(set(its.tolist())) > 1 and int(its.min()) > FN_HI,
              f"{label}: the lanes stopped at iterations "
              f"{sorted(set(its.tolist()))}: the same, or before FN_HI")
        check(reads - setup == n_it + n_in,
              f"{label}: {reads} blocking reads ({setup} before the loop) "
              f"in {n_it} batch iterations with {n_in} inner reads; "
              f"{n_it + n_in} expected in the loop; where: {sites}")
        halvings = ""
        if "T" in seen:
            h = sorted(set((-torch.log2(seen["T"][:, 0])).round().int()
                           .tolist()))
            check(len(h) > 1, f"{label}: every lane halved {h} times")
            halvings = (f"; the lanes halved {h} times (the middle "
                        f"threshold gap {gap:.2e} of the step)")
            n_rounds = n_in
        errs = []
        t0 = time.perf_counter()
        for b in sample:
            xb, itb, convb, _ = lane(S0b[b], Yb[b])
            errs.append(norm_err(x[b], xb))
            check(int(itb) == int(its[b]) and errs[-1] <= ENGINE_RTOL
                  and bool(convb) == bool(conv[b]),
                  f"{label}: lane {b} stopped at {int(its[b])}, its own "
                  f"solve at {int(itb)}; normwise {errs[-1]:.2e} > "
                  f"{ENGINE_RTOL:g}")
        t_own = (time.perf_counter() - t0) / FN_SAMPLE

        # every lane runs n iterations (n <= FN_HI, below every lane's
        # stop), its inner loops to their own tolerance as in the solve
        def batch_run(n):
            vmap(partial(lane, n=n))(S0b, Yb)

        def sample_run(n):
            for b in sample:
                lane(S0b[b], Yb[b], n=n)

        timed(batch_run, 3)
        timed(sample_run, 3)
        ms_b, ms_s, ms_s2, ms_b2 = (turn_ms(f, FN_LO, FN_HI)
                                    for f in (batch_run, sample_run,
                                              sample_run, batch_run))
        ms_batch, ms_one = min(ms_b, ms_b2), min(ms_s, ms_s2) / FN_SAMPLE
        launches_b = (launches_of(lambda: batch_run(2 * FN_LO))
                      - launches_of(lambda: batch_run(FN_LO))) / FN_LO
        log(f"functional [{label}, torch.func.vmap over {B} patches of {Np} "
            f"pixels, float64, S-step with A0 fixed]: lanes stop at "
            f"{int(its.min())}-{n_it} iterations to e_rel={FN_E_REL:g} in "
            f"{t_batch:.3f} s; {reads - setup} blocking reads in {n_it} "
            f"batch iterations = {(reads - setup) / n_it:.3f} per iteration "
            f"({n_in} of them inner; {setup} more before the loop), "
            f"device-to-host copies {copies - copies0} in the loop by the "
            f"profiler ({copies0} before it); "
            f"{inner} {n_rounds} = {n_rounds / n_it:.3f} per iteration"
            + halvings + f"; the {FN_SAMPLE} seeded lanes {sample} equal "
            "their own solves' iteration counts, normwise "
            + ", ".join(f"{e:.2e}" for e in errs)
            + f" (tol {ENGINE_RTOL:g}), {t_own:.3f} s a lane; marginal "
            f"ms/iter: the batch {ms_batch:.4f} ({ms_b:.4f}, {ms_b2:.4f}), "
            f"one lane {ms_one:.4f}, {B} lanes one by one ~{ms_one * B:.4f} "
            f"(scaled), {ms_one * B / ms_batch:.1f} times the batch; order "
            f"batch, lanes, lanes, batch; the batch runs {launches_b:.1f} "
            f"CUDA kernels per iteration; on {card}")

    # (c) implicit gradients under torch.func.vmap(torch.func.grad)
    L_ift = L + IFT_MU

    def nnls_grad(S, Yp):
        return A.T @ (A @ S - Yp) + IFT_MU * S

    def ift_solver(e_rel, n):
        return tfn.make_differentiable_pgm_solver(
            nnls_grad, 1.0 / L_ift, prox=top.prox_plus, e_rel=e_rel,
            max_iter=n, vjp_iters=n, vjp_rtol=e_rel)

    Bi = FN_IFT_PATCHES
    Yi = Yb[:Bi]
    sample_i = [int(b) for b in np.sort(np.random.default_rng(SEED).choice(
        Bi, FN_IFT_SAMPLE, replace=False))]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    wb = torch.randn((Bi, K, Np), dtype=f64, device=DEVICE, generator=gen)
    S_zero = torch.zeros((K, Np), dtype=f64, device=DEVICE)

    def loss_of(solve):
        return lambda Yp, w: torch.sum(w * solve(S_zero, Yp)[0])

    loss = loss_of(ift_solver(FN_IFT_E_REL, IFT_MAX_ITER))

    def counted_reads(fn):
        patch, n = counting(tfn, "any_lane")
        with patch:
            r, sites = reads_in(fn)
        return r, n[0], sites

    # launches and reads per round: fixed-length forward and adjoint loops
    # (the capped adjoint warns); and what a call reads besides its loops
    quiet = logging.getLogger("proxmin")
    level = quiet.level
    quiet.setLevel(logging.ERROR)

    def fixed(n):
        vmap(torch.func.grad(loss_of(ift_solver(0.0, n))))(Yi, wb)

    try:
        fixed(FN_LO)
        r1, n1, _ = counted_reads(lambda: fixed(1))
        launches_r = (launches_of(lambda: fixed(2 * FN_LO))
                      - launches_of(lambda: fixed(FN_LO))) / (2 * FN_LO)
        reads_r = (reads_in(lambda: fixed(2 * FN_LO))[0]
                   - reads_in(lambda: fixed(FN_LO))[0]) / (2 * FN_LO)
    finally:
        quiet.setLevel(level)
    out = {}
    t0 = time.perf_counter()
    reads, n_rounds, sites = counted_reads(lambda: out.update(
        g=vmap(torch.func.grad(loss))(Yi, wb)))
    t_batch = time.perf_counter() - t0
    g = out["g"]
    check(tuple(g.shape) == (Bi, C, Np) and bool(torch.isfinite(g).all()),
          f"IFT under vmap(grad): shape {tuple(g.shape)} or non-finite")
    errs, t_own, own_rounds = [], 0.0, 0
    for b in sample_i:
        theta = Yi[b].clone().requires_grad_(True)
        patch, own_in = counting(tfn, "any_lane")
        t0 = time.perf_counter()
        with patch:
            (gb,) = torch.autograd.grad(loss(theta, wb[b]), theta)
            torch.cuda.synchronize()
        t_own += time.perf_counter() - t0
        own_rounds += own_in[0]
        errs.append(norm_err(g[b], gb))
        check(errs[-1] <= FN_IFT_RTOL,
              f"IFT under vmap(grad): lane {b} against its own "
              f"torch.autograd.grad: normwise {errs[-1]:.2e} > "
              f"{FN_IFT_RTOL:g}")
    setup = r1 - n1
    check(reads - setup == n_rounds,
          f"IFT under vmap(grad): {reads} blocking reads ({setup} outside "
          f"the loops), {n_rounds} reads of the forward and adjoint loops' "
          f"flags; where: {sites}")
    ms_batch = t_batch / n_rounds * 1e3
    ms_one = t_own / own_rounds * 1e3
    log(f"functional [make_differentiable_pgm_solver under torch.func.vmap("
        f"torch.func.grad), float64 NNLS in S with the ridge {IFT_MU:g} per "
        f"patch, theta = Y_p, the first {Bi} patches of {Np} pixels]: "
        f"forward and "
        f"adjoint to {FN_IFT_E_REL:g} in {n_rounds} batch rounds, "
        f"{t_batch:.2f} s; {reads - setup} blocking reads in the loops (one "
        f"a round; {setup} outside them); the "
        f"gradients of lanes {sample_i} against their own "
        "torch.autograd.grad normwise "
        + ", ".join(f"{e:.2e}" for e in errs)
        + f" (tol {FN_IFT_RTOL:g}), their own {own_rounds} rounds in "
        f"{t_own:.2f} s; ms per round: the batch {ms_batch:.4f}, one lane "
        f"{ms_one:.4f}, {Bi} lanes one by one ~{ms_one * Bi:.4f} (scaled), "
        f"{ms_one * Bi / ms_batch:.1f} times the batch; {launches_r:.1f} CUDA "
        f"kernels and {reads_r:.2f} blocking reads per round of the fixed-"
        f"length loops; on {card}")


# Phase 14: whole solves exported with torch.export. The fused NMF programs
# at the flagship (each against its driver after ITERS iterations, served by
# a fresh process that imports torch and proxmin_tpu_torch.ops only), a
# weighted resume chain, the TV admm/sdmm programs with K4 soft; marginals
# between TURN_LO and TURN_HI
# iterations in turns with the driver, and launches and blocking reads per
# iteration between COUNT_LO and COUNT_HI iterations (the TV programs',
# exported for TURN_LO and HI iterations, between those).
EX_CHAIN = (10, 15)
# The fused NMF programs: name -> (kind, the exporter's options).
EX_FUSED = {
    "pgm": ("pgm", {}),
    # with its carries: the resume chain starts from it
    "pgm_w_stride10": ("pgm", {"weighted": True, "step_stride": STRIDE,
                               "return_carries": True}),
    "pgm_w_adaptive": ("pgm", {"weighted": True, "step_stride": STRIDE,
                               "step_adapt": True}),
    "pgm_bf16_store": ("pgm", {"store_dtype": torch.bfloat16}),
    "adaprox_f32": ("adaprox", {}),
    "adaprox_bf16_moments": ("adaprox", {"moment_dtype": torch.bfloat16}),
    "pgm_w_stride10_resume": ("pgm", {"weighted": True,
                                      "step_stride": STRIDE,
                                      "resume": True}),
}
# Every program of the phase is exported in a process of its own, all at
# once: an export is single-threaded tracing on the host, and one after
# another they took 130 s of a slow host's phase (the two TV programs at
# two iteration counts each, 87 s of it).
EXPORT_SCRIPT = r"""
import json
import sys
import time
import chip_smoke as cs
out_dir, name = sys.argv[1], sys.argv[2]
t0 = time.perf_counter()
blob = cs.export_program(name)
seconds = time.perf_counter() - t0
with open(f"{out_dir}/{name}.pt2", "wb") as fh:
    fh.write(blob)
print(json.dumps({"name": name, "seconds": seconds, "mb": len(blob) / 1e6}))
"""
SERVE_SCRIPT = r"""
import sys
import torch
import proxmin_tpu_torch.ops  # registers the proxmin_torch ops
names = sys.argv[2:]
data = torch.load(sys.argv[1] + "/inputs.pt")
for name in names:
    module = torch.export.load(f"{sys.argv[1]}/{name}.pt2").module()
    args = data[name]
    out = module(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    torch.save([o.cpu() for o in out], f"{sys.argv[1]}/{name}.out.pt")
print("served", len(names))
"""


def tv_cases_of(algorithms, linop, tex, tops):
    """Phase 14's TV programs: name -> (export(n), driver(n), x0, K4
    launches per iteration), on the TV denoise at TV_SIZES[0]; admm and
    sdmm with K4 soft as ``prox_g``."""
    H = TV_SIZES[0][0]
    _, y_tv = tv_problem(H)
    Dh, Dv = tv_operators(linop, H)
    x0_tv = torch.zeros_like(y_tv)

    def prox_quad(x, step):
        return (x + step * y_tv) / (1.0 + step)

    k4_soft = partial(tops.prox_soft_pallas, thresh=TV_LAM)
    tv = dict(e_rel=0, e_abs=0)
    return {
        "admm_tv_k4": (
            lambda n: tex.export_admm_solver(
                (H, H), prox_quad, TV_STEP_F, prox_g=k4_soft, L=Dh,
                max_iter=n, **tv),
            lambda n: algorithms.admm(x0_tv, prox_quad, TV_STEP_F,
                                      prox_g=k4_soft, L=Dh, max_iter=n,
                                      **tv), x0_tv, 1),
        "sdmm_tv_k4": (
            lambda n: tex.export_sdmm_solver(
                (H, H), prox_quad, TV_STEP_F, [k4_soft] * 2, Ls=[Dh, Dv],
                max_iter=n, **tv),
            lambda n: algorithms.sdmm(x0_tv, prox_quad, TV_STEP_F,
                                      proxs_g=[k4_soft] * 2, Ls=[Dh, Dv],
                                      max_iter=n, **tv), x0_tv, 2),
    }


def k3_pgm_case(tnmf, tops, Y):
    """Phase 14's generic program: ``pgm`` with K3 as its gradient at the
    flagship, ``(grad, options)``."""
    def k3_grad(A_, S_):
        return tops.fused_nmf_grad(A_, S_, Y)[:2]

    from proxmin_tpu_torch import operators

    return k3_grad, dict(prox=[operators.prox_plus] * 2, e_rel=0,
                         max_iter=ITERS)


# The bsdmm programs whose steps carry across sweeps, at the flagship
# (phase 14): nmf(algorithm="bsdmm", W=...) on the WeightedBSDMMStepper at
# stride 10, fixed and adaptive; the unweighted steps_f_stride=3; and the
# sum-to-one S of phase 11 with steps_g_update="relative". Each program is
# exported for TURN_LO and TURN_HI sweeps (bsdmm's max_iter is baked in) and
# held to its driver bit for bit at TURN_HI.
EX_BSDMM = ("bsdmm_w_stride10", "bsdmm_w_adaptive", "bsdmm_stride3",
            "bsdmm_relative")


def bsdmm_program_case(name, tnmf, top, Y, A0, S0, Ww):
    """Phase 14's bsdmm program ``name`` of EX_BSDMM: ``(export(n) ->
    bytes, driver(n) -> result)``, the driver as a user calls it (``nmf``,
    or ``bsdmm`` for the constrained one) and the program from the same
    callables (``nmf``'s block prox and steps)."""
    from proxmin_tpu_torch import algorithms, utils
    from proxmin_tpu_torch import export as tex

    shapes = [tuple(A0.shape), tuple(S0.shape)]
    plus = (top.prox_plus, top.prox_plus)
    if name == "bsdmm_relative":
        def block_prox_f(Xj, step, Xs=None, j=None):
            A, S = Xs
            D = A @ S - Y
            grad = D @ S.T if j == 0 else A.T @ D
            return top.prox_plus(Xj - step * grad, step)

        def block_step(Xs, j=None):
            return tnmf.step_A(*Xs) if j == 0 else tnmf.step_S(*Xs)

        # steps_g as the steps_f mode would take it at sweep 0, a tensor as
        # the step callable's (a Python number would round otherwise in
        # the program's float32 carry)
        sg = utils.get_step_g(tnmf.step_S(A0, S0), 1.0, N=2, M=1)
        kw = dict(proxs_g=[None, [partial(top.prox_unity, axis=0)]],
                  steps_g=[None, [sg]], steps_g_update="relative", e_rel=0)

        def export(n):
            return tex.export_bsdmm_solver(shapes, block_prox_f, block_step,
                                           max_iter=n, **kw)

        def driver(n):
            return algorithms.bsdmm([A0, S0], block_prox_f, block_step,
                                    max_iter=n, **kw)
        return export, driver
    weighted = name.startswith("bsdmm_w")
    W = Ww if weighted else 1
    prox_f = partial(tnmf._bsdmm_prox_f, Y=Y, W=W, prox=plus)
    if weighted:
        adapt = name.endswith("adaptive")
        opts = dict(W=Ww, step_stride=STRIDE, step_adapt=adapt)

        def steps():
            return dict(steps_f_cb=tnmf.WeightedBSDMMStepper(
                Ww, stride=STRIDE, adapt=adapt))
    else:
        opts = dict(step_stride=3)

        def steps():
            return dict(steps_f_cb=partial(tnmf._bsdmm_step_default, W=1),
                        steps_f_stride=3)

    def export(n):
        return tex.export_bsdmm_solver(shapes, prox_f, e_rel=0, max_iter=n,
                                       **steps())

    def driver(n):
        return tnmf.nmf(Y, A0, S0, algorithm="bsdmm", e_rel=0, max_iter=n,
                        **opts)
    return export, driver


def export_program(name):
    """The bytes of phase 14's program ``name``, exported in this process:
    a fused NMF program of EX_FUSED, ``<tv>_<n>`` (a TV program of
    ``tv_cases_of`` for ``n`` iterations), ``<bsdmm>_<n>`` (a program of
    EX_BSDMM for ``n`` sweeps) or ``pgm_k3``. Each is made from the phase's
    own data (seeded), so the program equals the one the phase would export
    itself."""
    from proxmin_tpu_torch import algorithms, linop
    from proxmin_tpu_torch import export as tex
    from proxmin_tpu_torch import nmf as tnmf
    from proxmin_tpu_torch import operators as top
    from proxmin_tpu_torch import ops as tops

    case, _, n = name.rpartition("_")
    if case in EX_BSDMM:
        Y, A0, S0, Ww = make_problem(C, K, N, True)
        return bsdmm_program_case(case, tnmf, top, Y, A0, S0,
                                  Ww)[0](int(n))
    if name in EX_FUSED:
        kind, kw = EX_FUSED[name]
        exporter = (tex.export_nmf_solver if kind == "pgm"
                    else tex.export_nmf_adaprox_solver)
        return exporter(C, K, N, e_rel=0, **kw)
    if name == "pgm_k3":
        Y = make_problem(C, K, N, False)[0]
        grad, kw = k3_pgm_case(tnmf, tops, Y)
        return tex.export_pgm_solver([(C, K), (K, N)], grad, tnmf.step_pgm,
                                     **kw)
    tv_name, n = name.rsplit("_", 1)
    return tv_cases_of(algorithms, linop, tex, tops)[tv_name][0](int(n))


def export_all(out_dir, names):
    """Export the programs ``names`` in a process each, all at once, into
    ``out_dir``: ``{name: (seconds, MB)}`` as each process timed its own
    export."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", EXPORT_SCRIPT, str(out_dir), name],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in names}
    made = {}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        check(proc.returncode == 0,
              f"export: exporting {name} failed: {err[-3000:]}")
        info = json.loads(out.strip().splitlines()[-1])
        made[name] = (info["seconds"], info["mb"])
    return made


def bsdmm_programs_check(mods, problem, out_dir, exported, card):
    """Phase 14's bsdmm programs (EX_BSDMM), exported into ``out_dir``
    (``exported``: ``{name: (seconds, MB)}`` of :func:`export_all`): each
    bit for bit against its driver at TURN_HI sweeps, then its marginal
    ms/sweep in turns with the driver. ``mods`` are ``(tnmf, top)``."""
    from proxmin_tpu_torch import export as tex

    tnmf, top = mods
    Y, A0, S0, Ww = problem
    for name in EX_BSDMM:
        _, drv = bsdmm_program_case(name, tnmf, top, Y, A0, S0, Ww)
        made = {}
        for n in (TURN_LO, TURN_HI):
            t0 = time.perf_counter()
            made[n] = tex.load_exported(out_dir / f"{name}_{n}.pt2")
            t_load = time.perf_counter() - t0
        seconds, mb = exported[f"{name}_{TURN_HI}"]
        xs_p, it_p, _ = made[TURN_HI](A0, S0)
        res = drv(TURN_HI)
        diff = max(float((a - b).abs().max()) for a, b in zip(xs_p, res.x))
        check(int(it_p) == res.iterations == TURN_HI and all(
            torch.equal(a, b) for a, b in zip(xs_p, res.x)),
            f"export: {name}: the program differs from its driver after "
            f"{TURN_HI} sweeps ({int(it_p)} against {res.iterations}; max "
            f"|diff| {diff:.3e})")
        if "w_" in name:
            # the refreshes and strides the driver's stepper reached
            steps_state = res.state["steps_state"]
            detail = (f"; the driver's strides {steps_state[1]}, next "
                      f"refreshes {steps_state[2]}")
        else:
            detail = ""

        def run_p(n, made=made):
            return made[n](A0, S0)
        timed(run_p, TURN_LO)
        timed(drv, TURN_LO)
        ms_d, ms_p, ms_p2, ms_d2 = (turn_ms(f) for f in (drv, run_p, run_p,
                                                          drv))
        log(f"export: {name}: program = driver bit for bit after {TURN_HI} "
            f"sweeps{detail}; program {min(ms_p, ms_p2):.4f} ms/sweep "
            f"marginal ({ms_p:.4f}, {ms_p2:.4f}), driver "
            f"{min(ms_d, ms_d2):.4f} ({ms_d:.4f}, {ms_d2:.4f}); order "
            f"driver, program, program, driver, between {TURN_LO} and "
            f"{TURN_HI} sweeps; exported in {seconds:.2f} s, {mb:.2f} MB, "
            f"loaded in {t_load:.2f} s; on {card}")


def export_phase(mods, problem, card, every_kernel, kernel_fns, prof_dir):
    """Phase 14: the port's exporters on the card (see the module
    docstring). ``mods`` are the port's modules ``(algorithms, linop, tnmf,
    top, tops)``, ``problem`` the flagship ``(Y, A0, S0, Ww)``,
    ``kernel_fns`` the wrappers ``(K1, K2, K3, K4 soft)``. Returns their
    launches in this process on the programs' paths."""
    from proxmin_tpu_torch import export as tex
    from proxmin_tpu_torch.ops import nmf_kernels as kk

    algorithms, linop, tnmf, top, tops = mods
    Y, A0, S0, Ww = problem
    k1_fn, k2_fn, k3_fn, soft_fn = kernel_fns
    out_dir = prof_dir.parent / "export"
    out_dir.mkdir(parents=True, exist_ok=True)
    launches = {"K1": 0, "K1 bf16 store": 0, "K2 device scalars": 0,
                "K3": 0, "K4 soft": 0}

    def nmf_case(kind, kw):
        weighted = kw.get("weighted", False)
        data = (A0, S0, Y) + ((Ww,) if weighted else ())
        if kind == "pgm":
            def driver(n):
                return tnmf.nmf_pgm_fused(
                    Y, A0, S0, W=Ww if weighted else None, e_rel=0,
                    max_iter=n, store_dtype=kw.get("store_dtype"),
                    step_stride=kw.get("step_stride"),
                    step_adapt=kw.get("step_adapt", False))
        else:
            def driver(n):
                return tnmf.nmf_adaprox_fused(
                    Y, A0, S0, e_rel=0, max_iter=n,
                    moment_dtype=kw.get("moment_dtype"))
        return data, driver

    cases = {name: case for name, case in EX_FUSED.items()
             if not case[1].get("resume")}
    tv_cases = tv_cases_of(algorithms, linop, tex, tops)
    names = [*EX_FUSED, "pgm_k3"] + [f"{name}_{n}" for name in tv_cases
                                     for n in (TURN_LO, HI)] + [
        f"{name}_{n}" for name in EX_BSDMM for n in (TURN_LO, TURN_HI)]
    t0 = time.perf_counter()
    exported = export_all(out_dir, names)
    log(f"export: {len(names)} programs exported in a process each, all "
        f"at once, in {time.perf_counter() - t0:.1f} s")
    programs, drivers, inputs, sizes = {}, {}, {}, {}
    for name, (kind, kw) in cases.items():
        data, driver = nmf_case(kind, kw)
        t0 = time.perf_counter()
        programs[name] = tex.load_exported(out_dir / f"{name}.pt2")
        t_load = time.perf_counter() - t0
        drivers[name] = driver
        inputs[name] = data + (torch.tensor(ITERS, dtype=torch.int32,
                                            device=DEVICE),)
        sizes[name] = exported[name] + (t_load,)
        log(f"export: {name}: exported in {sizes[name][0]:.2f} s, "
            f"{sizes[name][1]:.2f} MB, loaded in {t_load:.2f} s")

    # served by a fresh process that imports torch and the ops alone; it
    # runs while this process checks the programs, and its results are read
    # before anything is timed
    torch.save(inputs, out_dir / "inputs.pt")
    t_serve = time.perf_counter()
    serving = subprocess.Popen(
        [sys.executable, "-c", SERVE_SCRIPT, str(out_dir), *cases],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def held(name, where, got, res):
        same = all(torch.equal(g, w.cpu()) for g, w in zip(got[:2], res.x))
        diff = max(float((g - w.cpu()).abs().max())
                   for g, w in zip(got[:2], res.x))
        check(int(got[2]) == res.iterations == ITERS,
              f"export: {name} {where}: {int(got[2])} iterations, "
              f"{res.iterations} driven")
        check(same, f"export: {name} {where}: the program differs from its "
                    f"driver after {ITERS} iterations (max |diff| "
                    f"{diff:.3e})")
        check(float(got[5]) == res.loss,
              f"export: {name} {where}: loss {float(got[5])} != {res.loss}")

    driven = {}
    for name, (kind, kw) in cases.items():
        res = driven[name] = drivers[name](ITERS)
        # the program in this process: its launches are the kernels' count
        reset_counts(every_kernel)
        outs = programs[name](*inputs[name])
        torch.cuda.synchronize()
        if kind == "pgm":
            n = k1_fn.launches
            launches["K1 bf16 store" if "store_dtype" in kw else "K1"] += n
        else:
            n = k2_fn.device_scalar_launches
            check(k2_fn.launches == n, f"export: {name}: K2 launched "
                  f"{k2_fn.launches - n} times by value")
            launches["K2 device scalars"] += n
        check(n == ITERS, f"export: {name}: the program launched its kernel "
                          f"{n} times in {ITERS} iterations")
        held(name, "in this process", [o.cpu() for o in outs], res)
        log(f"export: {name}: the program in this process ({n} launches of "
            f"its kernel in {ITERS} iterations) = driver bit for bit after "
            f"{ITERS} iterations (loss {res.loss:.6e})")

    # the AdaProx driver forms its bias corrections as the programs do,
    # float64 powers rounded to float32: its drift from float32 NumPy
    # powers (not correctly rounded on every platform) after 100 iterations
    ours = tnmf._bias_corrections

    def numpy_f32(b1, b2, t):
        one, b1_t, b2_t, t = (np.float32(v) for v in (1, b1, b2, t))
        return b1_t, one / (one - b1_t ** t), one / (one - b2_t ** t)

    differ = [t for t in range(1, 10_001) if tuple(ours(0.9, 0.999, t))
              != tuple(numpy_f32(0.9, 0.999, t))]
    base = tnmf.nmf_adaprox_fused(Y, A0, S0, e_rel=0, max_iter=100)
    tnmf._bias_corrections = numpy_f32
    try:
        other = tnmf.nmf_adaprox_fused(Y, A0, S0, e_rel=0, max_iter=100)
    finally:
        tnmf._bias_corrections = ours
    drift = max(float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
                for x, y in zip(base.x, other.x))
    check(drift <= 1e-6, f"export: the AdaProx driver drifts {drift:.3e} "
                         "normwise from float32 NumPy powers")
    log(f"export: AdaProx bias corrections, float64 powers rounded to "
        f"float32 against float32 NumPy powers (NumPy {np.__version__}): "
        f"{len(differ)} of the first 10000 steps' scalars differ "
        f"{differ[:5]}; the driver after 100 iterations differs by "
        f"{drift:.3e} normwise (max over A, S; held to 1e-6)")

    # the resume chain: weighted stride 10, fresh 10 with its carries then
    # resume=True for 15, against the straight 25
    fresh = programs["pgm_w_stride10"]
    cont = tex.load_exported(out_dir / "pgm_w_stride10_resume.pt2")
    reset_counts(every_kernel)
    straight = fresh(A0, S0, Y, Ww, sum(EX_CHAIN))
    outs = fresh(A0, S0, Y, Ww, EX_CHAIN[0])
    outs2 = cont(outs[0], outs[1], Y, Ww, EX_CHAIN[1], *outs[2:])
    torch.cuda.synchronize()
    launches["K1"] += k1_fn.launches
    check(k1_fn.launches == 2 * sum(EX_CHAIN),
          f"export: resume chain: K1 launched {k1_fn.launches} times")
    check(int(outs2[2]) == sum(EX_CHAIN)
          and all(torch.equal(a, b) for a, b in zip(outs2, straight)),
          f"export: the chain {EX_CHAIN} differs from the straight "
          f"{sum(EX_CHAIN)} iterations")
    log(f"export: weighted stride {STRIDE} chain {EX_CHAIN[0]} + "
        f"{EX_CHAIN[1]} = straight {sum(EX_CHAIN)} bit for bit, with every "
        "carry")

    # the TV denoise: admm and sdmm with K4 soft as prox_g, against their
    # drivers bit for bit; max_iter is baked into these programs, so the
    # counts take two of each
    tv_programs = {}
    for name, (_, driver, x0_tv, per_it) in tv_cases.items():
        made = {}
        for n in (TURN_LO, HI):
            t0 = time.perf_counter()
            made[n] = tex.load_exported(out_dir / f"{name}_{n}.pt2")
            if n == HI:
                sizes[name] = exported[f"{name}_{n}"] + (
                    time.perf_counter() - t0,)
        tv_programs[name] = made
        log(f"export: {name}: exported in {sizes[name][0]:.2f} s, "
            f"{sizes[name][1]:.2f} MB, loaded in {sizes[name][2]:.2f} s")
        reset_counts(every_kernel)
        x_p, it_p, _, _ = made[HI](x0_tv)
        torch.cuda.synchronize()
        launches["K4 soft"] += soft_fn.launches
        check(soft_fn.launches == per_it * HI,
              f"export: {name}: K4 soft launched {soft_fn.launches} times "
              f"in {HI} iterations")
        res = driver(HI)
        check(int(it_p) == res.iterations and torch.equal(x_p, res.x),
              f"export: {name}: the program differs from its driver after "
              f"{HI} iterations (max |diff| "
              f"{float((x_p - res.x).abs().max()):.3e})")
        log(f"export: {name}: program = driver bit for bit after {HI} "
            "iterations")

    # a generic program with K3 as its gradient (export_pgm_solver)
    k3_grad, pgm_kw = k3_pgm_case(tnmf, tops, Y)
    k3_program = tex.load_exported(out_dir / "pgm_k3.pt2")
    reset_counts(every_kernel)
    xs_p, it_p, _, _ = k3_program(A0, S0)
    torch.cuda.synchronize()
    launches["K3"] += k3_fn.launches
    check(k3_fn.launches == ITERS,
          f"export: pgm with K3: {k3_fn.launches} launches")
    res = algorithms.pgm([A0, S0], k3_grad, tnmf.step_pgm, **pgm_kw)
    check(int(it_p) == res.iterations and all(
        torch.equal(a, b) for a, b in zip(xs_p, res.x)),
        "export: pgm with K3: the program differs from its driver")
    log(f"export: pgm with K3 as grad: program = driver bit for bit after "
        f"{ITERS} iterations")

    try:
        _, err = serving.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        serving.kill()
        raise
    check(serving.returncode == 0,
          f"export: the serving process failed: {err[-3000:]}")
    for name in cases:
        held(name, "served", torch.load(out_dir / f"{name}.out.pt"),
             driven[name])
    log(f"export: a fresh process (torch and proxmin_tpu_torch.ops) served "
        f"{len(cases)} programs for {ITERS} iterations each in "
        f"{time.perf_counter() - t_serve:.1f} s (beside this process's "
        f"checks), each = its driver bit for bit")

    # per iteration: launches, blocking reads and device-to-host copies,
    # and the marginal ms/iter in turns with the driver (driver, program,
    # program, driver); the weighted programs' refreshes in the window are
    # counted on their driver (the same schedule, bit for bit)
    steps_fn = tnmf._weighted_steps
    refreshes = []

    def counted_steps(*args, **kwargs):
        refreshes.append(1)
        return steps_fn(*args, **kwargs)

    for name in (*cases, *tv_cases):
        if name in cases:
            prog, drv = programs[name], drivers[name]
            data = inputs[name][:-1]

            def run_p(n, prog=prog, data=data):
                return prog(*data, n)
        else:
            made, drv, x0_tv = tv_programs[name], *tv_cases[name][1:3]

            def run_p(n, made=made, x0_tv=x0_tv):
                return made[n](x0_tv)
        # the TV programs have max_iter baked in: count them at TURN_LO and
        # HI
        lo, hi = (COUNT_LO, COUNT_HI) if name in cases else (TURN_LO, HI)
        k = [launches_of(lambda n=n: f(n)) for f in (run_p, drv)
             for n in (lo, hi)]
        run_p(lo)
        drv(lo)
        r = [blocking_reads(lambda n=n: f(n)) for f in (run_p, drv)
             for n in (lo, hi)]
        c = [dtoh_copies(lambda n=n: f(n)) for f in (run_p, drv)
             for n in (lo, hi)]
        span = hi - lo
        kw = cases.get(name, (None, {}))[1]
        refreshes.clear()
        tnmf._weighted_steps = counted_steps
        try:
            drv(lo)
            r_lo = len(refreshes)
            drv(hi)
        finally:
            tnmf._weighted_steps = steps_fn
        window = len(refreshes) - 2 * r_lo
        # the loop's stop test is the one read the sync debug mode sees;
        # the profiler also sees the copies inside eigvalsh and the
        # adaptive stride's copy to the host clock, but its count of one
        # call varies by a few copies at this size, so it is reported and
        # tests/test_torch_cuda.py holds it exactly on a small problem
        check(r[1] - r[0] == span,
              f"export: {name}: {r[1] - r[0]} blocking reads in {span} "
              "iterations")
        timed(run_p, lo)
        timed(drv, lo)
        # the TV programs run only the counts they were exported for
        m_lo, m_hi = (TURN_LO, TURN_HI) if name in cases else (TURN_LO, HI)
        ms_d, ms_p, ms_p2, ms_d2 = (turn_ms(f, m_lo, m_hi)
                                    for f in (drv, run_p, run_p, drv))
        log(f"export: {name}: program {min(ms_p, ms_p2):.4f} ms/iter "
            f"marginal ({ms_p:.4f}, {ms_p2:.4f}), driver "
            f"{min(ms_d, ms_d2):.4f} ({ms_d:.4f}, {ms_d2:.4f}); order "
            f"driver, program, program, driver, between {m_lo} and {m_hi} "
            f"iterations; CUDA launches/iter program "
            f"{(k[1] - k[0]) / span:.2f}, driver {(k[3] - k[2]) / span:.2f}; "
            f"blocking reads/iter (sync debug mode) program "
            f"{(r[1] - r[0]) / span:.2f} ({r[0]} at {lo}), driver "
            f"{(r[3] - r[2]) / span:.2f} ({r[2]} at {lo}); device-to-host "
            f"copies/iter (profiler) program {(c[1] - c[0]) / span:.2f}, "
            f"driver {(c[3] - c[2]) / span:.2f}; {window} step refreshes in "
            f"the window; counted between {lo} and {hi} iterations; "
            f"exported in {sizes[name][0]:.2f} s, {sizes[name][1]:.2f} MB, "
            f"loaded in {sizes[name][2]:.2f} s; on {card}")

    # the bsdmm programs whose steps carry across sweeps
    bsdmm_programs_check((tnmf, top), problem, out_dir, exported, card)

    # each registered op's host cost per call beside its wrapper's
    sS = torch.full((), 1e-3, dtype=torch.float32, device=DEVICE)
    MS = torch.zeros_like(S0)
    rowsum = torch.sum(S0, dim=1, keepdim=True)
    al = rowsum / N / 10.0
    sc_host = (0.9, 1.0 / (1 - 0.9), 1.0 / (1 - 0.999))
    sc_dev = torch.tensor(sc_host, dtype=torch.float32, device=DEVICE)
    Z = S0.clone()
    ops = torch.ops.proxmin_torch
    pairs = (
        ("K1 fused_nmf_pgm_step",
         lambda: ops.fused_nmf_pgm_step(A0, S0, Y, sS, None, [2], [0.0], 1,
                                        4096),
         lambda: kk.fused_nmf_pgm_step(A0, S0, Y, sS)),
        ("K2 fused_nmf_adaprox_step",
         lambda: ops.fused_nmf_adaprox_step(A0, S0, MS, MS, Y, al, sc_dev,
                                            None, [2], [0.0], 1, 0.999, 1e-8,
                                            4096),
         lambda: kk.fused_nmf_adaprox_step(A0, S0, MS, MS, Y, al, sc_host)),
        ("K3 fused_nmf_grad",
         lambda: ops.fused_nmf_grad(A0, S0, Y, None, 4096),
         lambda: kk.fused_nmf_grad(A0, S0, Y)),
        ("K4 prox_soft",
         lambda: ops.prox_soft(Z, sS, True, 0.0, TV_LAM),
         lambda: tops.prox_soft_pallas(Z, sS, thresh=TV_LAM)),
    )
    for label, op_call, wrapper_call in pairs:
        h_op = host_us(op_call, calls=400)
        h_w = host_us(wrapper_call, calls=400)
        log(f"export: {label}: registered op {h_op:.1f} us of host time per "
            f"call, wrapper {h_w:.1f} us; on {card}")
    return launches


def wide_ops(C_, K_, N_, gram=True):
    """The wide body's float32 operations per pass: the residual, gS and
    gA (3 C K FMAs a column) and, with ``gram``, the Gram's K (K + 1) / 2
    distinct entries (it is symmetric), two each: pgm_ops."""
    return pgm_ops(C_, K_, N_) if gram else 2 * N_ * 3 * C_ * K_


def make_unmixing(C_, K_, N_, seed=SEED):
    """Y = A_true S_true + noise with each column of S_true on the simplex,
    random A0 and S0, and W in [0.5, 1.5); made with NumPy from ``seed``
    and moved to the card."""
    rng = np.random.default_rng(seed)
    A_true = rng.random((C_, K_), dtype=np.float32)
    S_true = rng.random((K_, N_), dtype=np.float32)
    S_true /= S_true.sum(0, keepdims=True)
    Y = A_true @ S_true
    Y += WIDE_NOISE * rng.standard_normal((C_, N_), dtype=np.float32)
    A0 = rng.random((C_, K_), dtype=np.float32)
    S0 = rng.random((K_, N_), dtype=np.float32)
    W = 0.5 + rng.random((C_, N_), dtype=np.float32)
    return tuple(torch.from_numpy(a).to(DEVICE) for a in (Y, A0, S0, W))


def device_us(fn, trace):
    """Device microseconds of one call of ``fn``: the durations of the CUDA
    kernel events in a ``torch.profiler`` trace of the call, summed."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    return sum(e.get("dur", 0) for e in json.loads(trace.read_text())[
        "traceEvents"] if e.get("cat") == "kernel")


def route_counts(fns):
    return {f.__name__: dict(f.route_launches) for f in fns}


def reset_routes(fns):
    for f in fns:
        for r in f.route_launches:
            f.route_launches[r] = 0


def compare_outputs(label, got, ref, ds_at):
    """Every output of a fused step against its plain version's, max abs
    error over max abs; returns S''s max abs error."""
    errs = [rel_err(g.float(), r.float()) for g, r in zip(got, ref)]
    for i, e in enumerate(errs):
        tol = DS_RTOL if i == ds_at else STEP_RTOL
        check(e <= tol, f"{label}: output {i} rel err {e:.3e} > {tol:g}")
    check(bool(torch.isfinite(got[1]).all()), f"{label}: non-finite S'")
    max_abs = float((got[1].float() - ref[1].float()).abs().max())
    log(f"{label}: max rel err per output " + ", ".join(
        f"{e:.2e}" for e in errs) + f" (tol {STEP_RTOL:g}, |S' - S|^2 "
        f"{DS_RTOL:g}); S' max abs err {max_abs:.3e}")
    return max_abs


def wide_phase(mods, card, prof_dir):
    """Phase 15, the full-width path: K1's compiled chain and split path,
    K2's and K3's wide instances against their plain versions at C=128,
    K=32, N=1e6 and at (64, 16, 250_000), each timed beside its plain
    version and its bound; then nmf(engine="cuda") exact PGM, weighted PGM
    at stride 10 and AdaProx on that problem against engine="torch", the
    loss falling and the resume bit for bit, with marginal ms/iter and
    device us/iter; the compiled simplex against the split path with the
    same prox as a closure; general chains on the flagship (K1's narrow
    instance, K2's wide body). Returns the times, the errors and the route
    launches of the main path's run, for the kernels line."""
    algorithms, tnmf, top, tops, kk = mods
    k1, k2, k3 = (kk.fused_nmf_pgm_step, kk.fused_nmf_adaprox_step,
                  kk.fused_nmf_grad)
    counted = (k1, k2, k3)
    C_, K_, N_ = WIDE
    simplex = partial(top.prox_unity_plus, axis=0)
    l1 = partial(top.prox_soft_plus, thresh=WIDE_L1, type="relative")

    def simplex_closure(x, s):
        return top.prox_unity_plus(x, s, axis=0)

    def l1_closure(x, s):
        return top.prox_soft_plus(x, s, thresh=WIDE_L1, type="relative")

    t0 = time.perf_counter()
    Y, A0, S0, W = make_unmixing(C_, K_, N_)
    torch.cuda.synchronize()
    log(f"wide: C={C_} K={K_} N={N_} unmixing problem made (seed {SEED}, "
        f"NumPy) and moved to the card in {time.perf_counter() - t0:.1f} s; "
        f"Y {tensor_bytes(Y) / 1e9:.2f} GB, W {tensor_bytes(W) / 1e9:.2f} "
        f"GB, S {tensor_bytes(S0) / 1e9:.2f} GB")
    results = {}

    # the kernels against their plain versions, and their times
    sS = 1.0 / torch.linalg.eigvalsh(A0.T @ A0)[-1]
    bf = torch.bfloat16
    for label, (C1, K1_, N1) in (("full width", WIDE),
                                 ("sweep", WIDE_SWEEP)):
        if label == "sweep":
            Y_, A_, S_, W_ = make_unmixing(C1, K1_, N1)
            s_ = 1.0 / torch.linalg.eigvalsh(A_.T @ A_)[-1]
        else:
            Y_, A_, S_, W_, s_ = Y, A0, S0, W, sS
        for w_label, Wx in (("", None), (", W", W_)):
            for p_label, prox in (("chain", simplex),
                                  ("split", simplex_closure)):
                got = k1(A_, S_, Y_, s_, W=Wx, prox_S=prox)
                again = k1(A_, S_, Y_, s_, W=Wx, prox_S=prox)
                ref = kk.fused_nmf_pgm_step_reference(A_, S_, Y_, s_, W=Wx,
                                                      prox_S=prox)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"K1 {p_label} [{label}{w_label}]: two launches "
                      "differ")
                results["K1", p_label, label, w_label] = compare_outputs(
                    f"K1 {p_label} vs plain [{label}{w_label}, C={C1} "
                    f"K={K1_} N={N1}]", got, ref, 4)
                if p_label == "chain":
                    chain_out = got
            e = rel_err(got[1], chain_out[1])
            check(e <= CHAIN_SPLIT_RTOL, f"K1 [{label}{w_label}]: compiled "
                  f"simplex and split path differ by {e:.3e}")
            log(f"K1 [{label}{w_label}]: compiled simplex vs the split path "
                f"with the same prox as a closure: S' rel err {e:.2e} (tol "
                f"{CHAIN_SPLIT_RTOL:g})")
        # the bfloat16 store on the wide body
        got = k1(A_, S_.to(bf), Y_.to(bf), s_, W=W_.to(bf), prox_S=simplex)
        ref = kk.fused_nmf_pgm_step_reference(A_, S_.to(bf), Y_.to(bf), s_,
                                              W=W_.to(bf), prox_S=simplex)
        torch.cuda.synchronize()
        ok, ulps, diff = bf16_within(got[1], ref[1])
        check(ok and rel_err(got[0], ref[0]) <= STEP_RTOL,
              f"K1 bf16 store [{label}]: S' {ulps:g} ulps, gA rel err "
              f"{rel_err(got[0], ref[0]):.3e}")
        log(f"K1 bf16 store, W vs plain [{label}]: S' {ulps:.3g} bfloat16 "
            f"ulps max ({diff:.3e} abs); gA rel err "
            f"{rel_err(got[0], ref[0]):.2e}")
        # K2: the compiled relative L1 threshold and its split twin, float32
        # and bfloat16 moments
        rng = np.random.default_rng(SEED + 3)
        M_ = torch.from_numpy(0.1 * rng.standard_normal(
            (K1_, N1), dtype=np.float32)).to(DEVICE)
        V_ = torch.from_numpy(0.01 * rng.random(
            (K1_, N1), dtype=np.float32)).to(DEVICE)
        al_ = S_.sum(1, keepdim=True) / N1 / 10
        sc_ = tnmf._bias_corrections(0.9, 0.999, 3)
        for m_label, mdt in (("f32 moments", torch.float32),
                             ("bf16 moments", torch.bfloat16)):
            for p_label, prox in (("chain", l1), ("split", l1_closure)):
                plan = kk.describe_prox(prox, "adaprox", True)
                args = (A_, S_, M_.to(mdt), V_.to(mdt), Y_, al_, sc_)
                got = k2(*args, W=W_, prox_S=plan)
                again = k2(*args, W=W_, prox_S=plan)
                ref = kk.fused_nmf_adaprox_step_reference(*args, W=W_,
                                                          prox_S=plan)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"K2 {p_label} [{label}, {m_label}]: two launches "
                      "differ")
                if mdt == torch.bfloat16:
                    for i in (2, 3):
                        ok, ulps, _ = bf16_within(got[i], ref[i])
                        check(ok, f"K2 {p_label} [{label}, {m_label}]: "
                              f"moment {i} {ulps:g} ulps")
                    got = tuple(g for i, g in enumerate(got) if i not in
                                (2, 3))
                    ref = tuple(r for i, r in enumerate(ref) if i not in
                                (2, 3))
                results["K2", p_label, label, m_label] = compare_outputs(
                    f"K2 {p_label} vs plain [{label}, W, {m_label}, C={C1} "
                    f"K={K1_} N={N1}]", got, ref,
                    6 if mdt == torch.float32 else 4)
        for w_label, Wx in (("", None), (", W", W_)):
            got = tops.fused_nmf_grad(A_, S_, Y_, W=Wx)
            again = tops.fused_nmf_grad(A_, S_, Y_, W=Wx)
            ref = tops.fused_nmf_grad_reference(A_, S_, Y_, W=Wx)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K3 wide [{label}{w_label}]: two launches differ")
            errs = [rel_err(g, r) for g, r in zip(got, ref)]
            check(max(errs) <= STEP_RTOL, f"K3 wide [{label}{w_label}]: "
                  f"rel errs {errs}")
            results["K3", label, w_label] = float(
                (got[1] - ref[1]).abs().max())
            log(f"K3 wide vs plain [{label}{w_label}, C={C1} K={K1_} "
                f"N={N1}]: max rel err (gA, gS, Gram, loss) " + ", ".join(
                    f"{e:.2e}" for e in errs) + f" (tol {STEP_RTOL:g}); two "
                "launches bitwise equal")
        if label == "sweep":
            del Y_, A_, S_, W_, M_, V_

    # times at the full width, beside the plain version and the bound
    M0 = torch.zeros_like(S0)
    al0 = S0.sum(1, keepdim=True) / N_ / 10
    sc0 = tnmf._bias_corrections(0.9, 0.999, 3)
    times = {}

    def timing(key, call, plain, moved, ops):
        k_ms = min(cuda_ms(call, reps=10) for _ in range(2))
        p_ms = min(cuda_ms(plain, reps=10) for _ in range(2))
        times[key] = (k_ms, p_ms, bound_of(moved, ops))
        b = times[key][2]
        log(f"wide time [{key}] on {card}: kernel {k_ms:.4f} ms "
            f"({ops / k_ms / 1e9:.1f} TFLOP/s, {moved / k_ms / 1e6:.0f} GB/s "
            f"of {moved / 1e6:.0f} MB), plain version {p_ms:.4f} ms, bound "
            f"{b[0]:.4f} ms by {b[1]} ({b[0] / k_ms:.1%} of it)")

    out = k1(A0, S0, Y, sS, prox_S=simplex)
    timing("K1 chain", lambda: k1(A0, S0, Y, sS, prox_S=simplex),
           lambda: kk.fused_nmf_pgm_step_reference(A0, S0, Y, sS,
                                                   prox_S=simplex),
           tensor_bytes(A0, S0, Y) + tensor_bytes(*out),
           wide_ops(C_, K_, N_))
    out = k1(A0, S0, Y, sS, W=W, prox_S=simplex)
    timing("K1 chain, W", lambda: k1(A0, S0, Y, sS, W=W, prox_S=simplex),
           lambda: kk.fused_nmf_pgm_step_reference(A0, S0, Y, sS, W=W,
                                                   prox_S=simplex),
           tensor_bytes(A0, S0, Y, W) + tensor_bytes(*out),
           wide_ops(C_, K_, N_))
    X, gA_, st_ = kk._pgm_pass1_cuda(A0, S0, Y, sS, None, kk.DEFAULT_TILE_N)
    P_ = simplex(X, sS)
    timing("K1 split pass 1",
           lambda: kk._pgm_pass1_cuda(A0, S0, Y, sS, None, kk.DEFAULT_TILE_N),
           lambda: kk._pgm_pass1_reference(A0, S0, Y, sS),
           tensor_bytes(A0, S0, Y, X, gA_, st_[:1]),
           wide_ops(C_, K_, N_, gram=False))
    timing("K1 split pass 2",
           lambda: kk._pgm_pass2_cuda(S0, P_, kk.DEFAULT_TILE_N),
           lambda: kk._pgm_pass2_reference(S0, P_, torch.float32),
           tensor_bytes(S0, P_) + 4 * (K_ * K_ + 2), pgm_ops(0, K_, N_))
    timing("K1 split step", lambda: k1(A0, S0, Y, sS,
                                       prox_S=simplex_closure),
           lambda: kk.fused_nmf_pgm_step_reference(A0, S0, Y, sS,
                                                   prox_S=simplex_closure),
           tensor_bytes(A0, S0, Y) + tensor_bytes(*out),
           wide_ops(C_, K_, N_))
    out = k2(A0, S0, M0, M0, Y, al0, sc0, prox_S=l1)
    timing("K2 chain", lambda: k2(A0, S0, M0, M0, Y, al0, sc0, prox_S=l1),
           lambda: kk.fused_nmf_adaprox_step_reference(
               A0, S0, M0, M0, Y, al0, sc0, prox_S=l1),
           tensor_bytes(A0, S0, M0, M0, Y, al0) + tensor_bytes(*out),
           wide_ops(C_, K_, N_, gram=False) + 20 * K_ * N_)
    l1_split = kk.describe_prox(l1_closure, "adaprox", True)
    pre = kk._adaprox_pass1_cuda(A0, S0, M0, M0, Y, al0, sc0, None, 0.999,
                                 1e-8, kk.DEFAULT_TILE_N)
    P2 = l1_closure(pre[0], pre[1])
    timing("K2 split pass 1",
           lambda: kk._adaprox_pass1_cuda(A0, S0, M0, M0, Y, al0, sc0, None,
                                          0.999, 1e-8, kk.DEFAULT_TILE_N),
           lambda: kk._adaprox_pass1_reference(A0, S0, M0, M0, Y, al0, sc0),
           tensor_bytes(A0, S0, M0, M0, Y, al0) + tensor_bytes(
               *pre[:5]) + 4, wide_ops(C_, K_, N_, gram=False)
           + 20 * K_ * N_)
    timing("K2 split pass 2",
           lambda: kk._adaprox_pass2_cuda(S0, P2, kk.DEFAULT_TILE_N),
           lambda: kk._adaprox_pass2_reference(S0, P2, torch.float32),
           tensor_bytes(S0, P2) + 4 * (K_ + 2), 4 * N_ * K_)
    out = tops.fused_nmf_grad(A0, S0, Y)
    timing("K3 wide", lambda: tops.fused_nmf_grad(A0, S0, Y),
           lambda: tops.fused_nmf_grad_reference(A0, S0, Y),
           tensor_bytes(A0, S0, Y) + tensor_bytes(*out),
           wide_ops(C_, K_, N_))
    del X, P_, P2, pre, out
    # Context, not a yardstick: the step's four float32 products as four
    # cuBLAS calls (TF32 off), R = A S, A^T D, D S^T and S' S'^T, which
    # move R and D through memory where the kernel keeps them on chip.
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        D_ = A0 @ S0 - Y
        products = {"A@S": lambda: A0 @ S0, "A.T@D": lambda: A0.T @ D_,
                    "D@S.T": lambda: D_ @ S0.T, "S@S.T": lambda: S0 @ S0.T}
        p_ms = {k: min(cuda_ms(f, reps=10) for _ in range(2))
                for k, f in products.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del D_
    k1_ms = times["K1 chain"][0]
    log(f"wide context [four float32 cuBLAS calls, TF32 off, C={C_} K={K_} "
        f"N={N_}; not a single-call yardstick] on {card}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in p_ms.items())
        + f"; sum {sum(p_ms.values()):.4f} ms against K1 wide's one pass "
        f"{k1_ms:.4f} ms")

    # the full-width solves: engine="cuda" against engine="torch"
    ada = dict(algorithm="adaprox")
    paths = (
        ("exact PGM", dict(prox_S=simplex), {}),
        ("weighted PGM stride 10", dict(prox_S=simplex, W=W,
                                        step_stride=STRIDE), {}),
        ("AdaProx", dict(prox_S=l1, **ada), dict(separable_prox="auto")),
    )
    reset_counts(counted)
    reset_routes(counted)
    loss0 = {"w": wloss(A0, S0, Y, W), "u": wloss(A0, S0, Y)}
    solves = {}
    for label, kw, torch_kw in paths:
        before = route_counts(counted)
        r_c = tnmf.nmf(Y, A0, S0, prox_A=top.prox_plus, e_rel=0,
                       max_iter=WIDE_ITERS, engine="cuda", **kw)
        torch.cuda.synchronize()
        after = route_counts(counted)
        kname = "fused_nmf_adaprox_step" if "algorithm" in kw else \
            "fused_nmf_pgm_step"
        ran = {r: after[kname][r] - before[kname][r] for r in after[kname]}
        check(ran["wide"] == WIDE_ITERS == r_c.iterations
              and sum(ran.values()) == WIDE_ITERS,
              f"wide {label}: routes {ran} in {r_c.iterations} iterations")
        r_t = tnmf.nmf(Y, A0, S0, prox_A=top.prox_plus, e_rel=0,
                       max_iter=WIDE_ITERS, engine="torch", **kw,
                       **torch_kw)
        torch.cuda.synchronize()
        for a in (*r_c.x, *r_t.x):
            check(bool(torch.isfinite(a).all()), f"wide {label}: "
                  "non-finite iterate")
        check(tuple(r_c.x[1].shape) == (K_, N_), f"wide {label}: S shape")
        n_A, n_S = (norm_err(r_c.x[i], r_t.x[i]) for i in (0, 1))
        check(n_A <= ENGINE_RTOL and n_S <= ENGINE_RTOL,
              f"wide {label}: engines disagree after {WIDE_ITERS} "
              f"iterations: normwise A {n_A:.2e}, S {n_S:.2e}")
        W_ = kw.get("W")
        l0 = loss0["u" if W_ is None else "w"]
        l_c, l_t = wloss(*r_c.x, Y, W_), wloss(*r_t.x, Y, W_)
        check(np.isfinite([l_c, l_t]).all() and l_c < l0 and l_t < l0,
              f"wide {label}: loss did not decrease")
        half = tnmf.nmf(Y, A0, S0, prox_A=top.prox_plus, e_rel=0,
                        max_iter=WIDE_SPLIT, engine="cuda", **kw)
        rest = tnmf.nmf(Y, *half.x, prox_A=top.prox_plus, e_rel=0,
                        max_iter=WIDE_ITERS - WIDE_SPLIT, engine="cuda",
                        state=half.state, **kw)
        check(torch.equal(rest.x[0], r_c.x[0])
              and torch.equal(rest.x[1], r_c.x[1]),
              f"wide {label}: {WIDE_SPLIT} + {WIDE_ITERS - WIDE_SPLIT} "
              f"resumed differs from {WIDE_ITERS} straight")
        extra = ""
        if "algorithm" not in kw:
            colsum = float((r_c.x[1].sum(0) - 1).abs().max())
            check(colsum <= UNITY_SUM_ATOL and bool((r_c.x[1] >= 0).all()),
                  f"wide {label}: columns of S sum to 1 within {colsum:.2e}")
            extra = f"; columns of S sum to 1 within {colsum:.2e}"
        solves[label] = r_c
        log(f"wide {label}: nmf engine=cuda vs engine=torch, {WIDE_ITERS} "
            f"iterations at e_rel=0, C={C_} K={K_} N={N_}: normwise rel err "
            f"A {n_A:.2e}, S {n_S:.2e} (tol {ENGINE_RTOL:g}); loss {l0:.6e} "
            f"-> cuda {l_c:.6e}, torch {l_t:.6e}; {WIDE_SPLIT} + "
            f"{WIDE_ITERS - WIDE_SPLIT} resumed equal {WIDE_ITERS} straight "
            f"bit for bit; launches {ran}{extra}")
    # the split path on the same solves, the prox as a closure
    for label, kw in (("exact PGM", dict(prox_S=simplex_closure)),
                      ("AdaProx", dict(prox_S=l1_closure,
                                       separable_prox=True, **ada))):
        kname = "fused_nmf_adaprox_step" if "algorithm" in kw else \
            "fused_nmf_pgm_step"
        before = route_counts(counted)
        r_s = tnmf.nmf(Y, A0, S0, prox_A=top.prox_plus, e_rel=0,
                       max_iter=WIDE_ITERS, engine="cuda", **kw)
        torch.cuda.synchronize()
        after = route_counts(counted)
        ran = {r: after[kname][r] - before[kname][r] for r in after[kname]}
        check(ran["split pass 1"] == ran["split pass 2"] == WIDE_ITERS
              and sum(ran.values()) == 2 * WIDE_ITERS,
              f"wide {label} split path: routes {ran}")
        n_A, n_S = (norm_err(r_s.x[i], solves[label].x[i]) for i in (0, 1))
        check(n_A <= ENGINE_RTOL and n_S <= ENGINE_RTOL,
              f"wide {label}: split path and compiled chain disagree after "
              f"{WIDE_ITERS} iterations: normwise A {n_A:.2e}, S {n_S:.2e}")
        log(f"wide {label}, prox_S as a closure (split path) vs the "
            f"compiled chain, {WIDE_ITERS} iterations: normwise rel err A "
            f"{n_A:.2e}, S {n_S:.2e} (tol {ENGINE_RTOL:g}); launches {ran}")
    # K3 on the main path: pgm with fused_nmf_grad as its gradient
    before = dict(k3.route_launches)
    rg = algorithms.pgm(
        [A0, S0], lambda A_, S_: tops.fused_nmf_grad(A_, S_, Y)[:2],
        tnmf.step_pgm, prox=[top.prox_plus, simplex], e_rel=0,
        max_iter=WIDE_SPLIT)
    torch.cuda.synchronize()
    k3_wide = k3.route_launches["wide"] - before["wide"]
    check(k3_wide == rg.iterations + 1 and all(
        bool(torch.isfinite(x).all()) for x in rg.x),
        f"wide K3 path: {k3_wide} launches in {rg.iterations} iterations")
    l_g = wloss(*rg.x, Y)
    check(l_g < loss0["u"], "wide K3 path: loss did not decrease")
    log(f"wide ops path [K3 gradient]: pgm(grad=fused_nmf_grad) with the "
        f"simplex on S, {rg.iterations} iterations: loss {loss0['u']:.6e} "
        f"-> {l_g:.6e}; K3 wide launches {k3_wide} = iterations + the "
        "final gradient")
    # the sweep shape's exact PGM
    Ys, As, Ss, _ = make_unmixing(*WIDE_SWEEP)
    r_sw = tnmf.nmf(Ys, As, Ss, prox_A=top.prox_plus, prox_S=simplex,
                    e_rel=0, max_iter=WIDE_ITERS, engine="cuda")
    r_swt = tnmf.nmf(Ys, As, Ss, prox_A=top.prox_plus, prox_S=simplex,
                     e_rel=0, max_iter=WIDE_ITERS, engine="torch")
    n_S = norm_err(r_sw.x[1], r_swt.x[1])
    check(n_S <= ENGINE_RTOL and wloss(*r_sw.x, Ys) < wloss(As, Ss, Ys),
          f"sweep {WIDE_SWEEP} exact PGM: S normwise {n_S:.2e}")
    log(f"sweep {WIDE_SWEEP} exact PGM with the simplex: engines agree "
        f"normwise S {n_S:.2e}; loss {wloss(As, Ss, Ys):.6e} -> "
        f"{wloss(*r_sw.x, Ys):.6e}")
    del Ys, As, Ss, r_sw, r_swt
    # general chains at the flagship's C and K
    Yf, Af, Sf, _ = make_problem(C, K, N, False)
    before = route_counts(counted)
    rn = tnmf.nmf(Yf, Af, Sf, prox_S=simplex, e_rel=0,
                  max_iter=CHAIN_ITERS, engine="cuda")
    rna = tnmf.nmf(Yf, Af, Sf, prox_S=l1, e_rel=0, max_iter=CHAIN_ITERS,
                   engine="cuda", **ada)
    torch.cuda.synchronize()
    after = route_counts(counted)
    n1 = after["fused_nmf_pgm_step"]["narrow"] - before[
        "fused_nmf_pgm_step"]["narrow"]
    # K2's narrow instances apply max(., 0) and the identity only: any other
    # chain runs on the wide body, at the flagship too
    n2 = after["fused_nmf_adaprox_step"]["wide"] - before[
        "fused_nmf_adaprox_step"]["wide"]
    # the main path ends here: what follows compares and times
    routes = route_counts(counted)
    rnt = tnmf.nmf(Yf, Af, Sf, prox_S=simplex, e_rel=0,
                   max_iter=CHAIN_ITERS, engine="torch")
    rnat = tnmf.nmf(Yf, Af, Sf, prox_S=l1, e_rel=0, max_iter=CHAIN_ITERS,
                    engine="torch", separable_prox="auto", **ada)
    e1, e2 = norm_err(rn.x[1], rnt.x[1]), norm_err(rna.x[1], rnat.x[1])
    check(n1 == n2 == CHAIN_ITERS and max(e1, e2) <= ENGINE_RTOL,
          f"flagship chains: launches {n1}, {n2}; S normwise {e1:.2e}, "
          f"{e2:.2e}")
    log(f"flagship C={C} K={K} N={N}, general chains, {CHAIN_ITERS} "
        f"iterations: PGM simplex S normwise vs engine=torch {e1:.2e}, "
        f"AdaProx relative L1 {e2:.2e} (tol {ENGINE_RTOL:g}); K1 narrow "
        f"launches {n1}, K2 wide launches {n2}")
    # each chain's launch at the flagship against its plain version: K1's
    # pgm_chain_kernel and K2's wide body at KB = 8, every output, with and
    # without W
    rng = np.random.default_rng(SEED + 4)
    Wf = torch.from_numpy(0.5 + rng.random((C, N), dtype=np.float32)).to(
        DEVICE)
    Mf = torch.from_numpy(0.1 * rng.standard_normal(
        (K, N), dtype=np.float32)).to(DEVICE)
    Vf = torch.from_numpy(0.01 * rng.random((K, N), dtype=np.float32)).to(
        DEVICE)
    alf = Sf.sum(1, keepdim=True) / N / 10
    for w_label, Wx in (("", None), (", W", Wf)):
        for kname, label, call, plain, ds_at, route in (
                ("fused_nmf_pgm_step", "K1 narrow",
                 lambda: k1(Af, Sf, Yf, 1e-3, W=Wx, prox_S=simplex),
                 lambda: kk.fused_nmf_pgm_step_reference(
                     Af, Sf, Yf, 1e-3, W=Wx, prox_S=simplex), 4, "narrow"),
                ("fused_nmf_adaprox_step", "K2 flagship",
                 lambda: k2(Af, Sf, Mf, Vf, Yf, alf, sc0, W=Wx, prox_S=l1),
                 lambda: kk.fused_nmf_adaprox_step_reference(
                     Af, Sf, Mf, Vf, Yf, alf, sc0, W=Wx, prox_S=l1), 6,
                 "wide")):
            before = route_counts(counted)[kname]
            got, again = call(), call()
            after = route_counts(counted)[kname]
            ref = plain()
            torch.cuda.synchronize()
            check({r: after[r] - before[r] for r in after
                   if after[r] != before[r]} == {route: 2},
                  f"{label} chain [flagship{w_label}]: not the {route} "
                  "route")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{label} chain [flagship{w_label}]: two launches differ")
            results[label, w_label] = compare_outputs(
                f"{label} chain ({route} route) vs plain [flagship{w_label}, "
                f"C={C} K={K} N={N}]", got, ref, ds_at)
    a1 = max(results["K1 narrow", w] for w in ("", ", W"))
    a2 = max(results["K2 flagship", w] for w in ("", ", W"))
    k1n_ms = min(cuda_ms(lambda: k1(Af, Sf, Yf, 1e-3, prox_S=simplex))
                 for _ in range(2))
    k1n_plain = min(cuda_ms(lambda: kk.fused_nmf_pgm_step_reference(
        Af, Sf, Yf, 1e-3, prox_S=simplex)) for _ in range(2))
    out = k1(Af, Sf, Yf, 1e-3, prox_S=simplex)
    times["K1 narrow chain"] = (k1n_ms, k1n_plain, bound_of(
        tensor_bytes(Af, Sf, Yf) + tensor_bytes(*out), pgm_ops(C, K, N)))
    k2n_ms = min(cuda_ms(lambda: k2(Af, Sf, Mf, Vf, Yf, alf, sc0,
                                    prox_S=l1)) for _ in range(2))
    k2n_plain = min(cuda_ms(lambda: kk.fused_nmf_adaprox_step_reference(
        Af, Sf, Mf, Vf, Yf, alf, sc0, prox_S=l1)) for _ in range(2))
    out = k2(Af, Sf, Mf, Vf, Yf, alf, sc0, prox_S=l1)
    times["K2 chain, flagship"] = (k2n_ms, k2n_plain, bound_of(
        tensor_bytes(Af, Sf, Mf, Vf, Yf) + tensor_bytes(*out),
        adaprox_ops(C, K, N)))
    results["K1 narrow"], results["K2 flagship"] = a1, a2
    results["K2 flagship launches"] = n2
    log(f"flagship chains on {card}: K1 simplex {k1n_ms:.4f} ms (plain "
        f"{k1n_plain:.4f}), K2 relative L1 {k2n_ms:.4f} ms (plain "
        f"{k2n_plain:.4f}); S' max abs err {a1:.3e}, {a2:.3e}")
    del Yf, Af, Sf, Mf, Vf, Wf, out

    # marginal ms/iter (host clock) and device us/iter at the full width,
    # and the exact PGM on the torch engine beside them
    for label, kw, engine in (*((label, kw, "cuda") for label, kw, _ in paths),
                              ("exact PGM, engine=torch",
                               dict(prox_S=simplex), "torch")):
        def fn(n, kw=kw, engine=engine):
            return tnmf.nmf(Y, A0, S0, prox_A=top.prox_plus, e_rel=0,
                            max_iter=n, engine=engine, **kw)

        timed(fn, 2)
        ms = marginal_ms(fn, WIDE_LO, WIDE_HI)
        d_lo = device_us(lambda: fn(WIDE_LO), prof_dir / "wide_lo.json")
        d_hi = device_us(lambda: fn(WIDE_HI), prof_dir / "wide_hi.json")
        dev_us = (d_hi - d_lo) / (WIDE_HI - WIDE_LO)
        log(f"wide {label}: {ms:.4f} ms/iter marginal ({WIDE_LO}->{WIDE_HI} "
            f"iterations, host clock), device {dev_us:.1f} us/iter "
            f"(kernel time in a torch.profiler trace, same span), busy "
            f"share {dev_us / 1e3 / ms:.1%}; on {card}")
    return times, results, routes


# The sharded path (phase 16): proxmin_tpu_torch.parallel on a one-rank NCCL
# group at the flagship, against the single-card torch engine.
SHARD_ITERS = 200
SHARD_SPLIT = 80           # the resumed solve's first piece
# the window that counts all-reduces and copies: the profiler's count of a
# call jitters by a few copies, so a long one
SHARD_COUNT = (10, 110)
# Two gloo ranks on the one card (each process all-reduces its CUDA tensors
# through the host): the exact solve against the one-rank result, normwise
GLOO_TWO_RANKS = True
GLOO_RTOL = 1e-5
GLOO_RANK_SCRIPT = r"""
import sys
import torch
import chip_smoke as cs
from proxmin_tpu_torch import export as tex
from proxmin_tpu_torch import nmf as tnmf
from proxmin_tpu_torch import parallel as tpar
port, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
tpar.initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
Y, A0, S0, _ = cs.make_problem(cs.C, cs.K, cs.N, False)
mesh = tpar.make_mesh()
res = tpar.nmf_pgm_sharded(Y, A0, S0, mesh=mesh, e_rel=0,
                           max_iter=cs.SHARD_ITERS)
# the auto-SPMD route and the exact PGM program on the two ranks
bsdmm = tnmf.nmf(Y, A0, S0, mesh=mesh, algorithm="bsdmm", e_rel=0,
                 max_iter=cs.AUTO_ITERS)
Yd, Ad, Sd, _ = tpar.shard_nmf_problem(mesh, Y, A0, S0)
program = tex.load_solver(tex.export_nmf_pgm_sharded(mesh, cs.C, cs.K, cs.N,
                                                     e_rel=0.0))
outs = program(Ad, Sd, Yd, cs.SHARD_ITERS)
torch.save({"A": res.x[0].to_local().cpu(), "S": res.x[1].to_local().cpu(),
            "loss": res.loss, "iterations": res.iterations,
            "bsdmm_A": bsdmm.x[0].to_local().cpu(),
            "bsdmm_S": bsdmm.x[1].to_local().cpu(),
            "bsdmm_iterations": bsdmm.iterations,
            "program_A": outs[0].to_local().cpu(),
            "program_S": outs[1].to_local().cpu(),
            "program_loss": float(outs[5]),
            "program_iterations": int(outs[2])},
           f"{out}/rank{rank}.pt")
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""
# The rest of the scale-out (phase 16): the auto-SPMD routes, the ordinary
# drivers on DTensor shards, each AUTO_ITERS iterations against the same
# call on the torch engine without a mesh (within ENGINE_RTOL, equal
# iterations, and bit for bit: on one rank the driver runs the same local
# operations); admm on the TV denoise at FN_TV_H x FN_TV_H with x sharded
# over columns, AUTO_TV_ITERS iterations against its plain solve; their
# marginals in turns with the single-card driver. The per-rank programs of
# the two sharded exporters against their live solves bit for bit, and the
# weighted stride-10 program chained PROG_CHAIN against the straight sum.
AUTO_ITERS = 50
AUTO_TV_ITERS = 100
PROG_CHAIN = (10, 15)


def route_problem(C_, K_, N_):
    """The routing path's problem at (C, K, N), W in [0.5, 1.5): below
    ROUTE_SIMPLEX_FROM_C channels bench.py's data (make_problem) from its
    planted start, from it on phase 15's unmixing data (make_unmixing, the
    abundances on the simplex) from its random start. From make_problem's
    random start a step frozen for 10 iterations overshoots at C=5, K=7
    (the iterate reaches 1e16 and the prox zeroes it: the solve stops, an
    exact fixed point), and the simplex on S fails on data whose
    abundances are not on it (NaN after 12 iterations); both engines alike,
    and the JAX package does the same (tests/test_torch_strided.py holds
    the port to it: the stopping iteration and the NaN columns)."""
    if C_ >= ROUTE_SIMPLEX_FROM_C:
        return make_unmixing(C_, K_, N_)
    return make_problem(C_, K_, N_, True, planted=True)


def route_solver(tnmf, top, problem, path, engine):
    """``solve(n)``: ``n`` iterations of the ROUTE_PATHS path ``path`` on
    ``engine`` (``"torch"``, ``"cuda"`` or ``"auto"``) with ``e_rel=0``,
    from the problem's starting point (tensors: nmf writes nothing back
    into them); ``prox_plus`` on A and S, the simplex on S for PGM from
    C = ROUTE_SIMPLEX_FROM_C on."""
    Y, A0, S0, W = problem
    algorithm, weighted, kw_torch, kw_cuda = ROUTE_PATHS[path]
    prox_S = (partial(top.prox_unity_plus, axis=0)
              if algorithm == "pgm" and Y.shape[0] >= ROUTE_SIMPLEX_FROM_C
              else top.prox_plus)
    kw = kw_torch if engine == "torch" else kw_cuda
    return lambda n: tnmf.nmf(
        Y, A0, S0, W=W if weighted else 1, prox_A=top.prox_plus,
        prox_S=prox_S, algorithm=algorithm, e_rel=0.0, max_iter=n,
        engine=engine, **kw)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def all_reduces_of(fn):
    """``(calls, elements)`` of the ``torch.distributed.all_reduce`` calls
    that ``fn`` makes."""
    import torch.distributed as dist

    calls = []
    real = dist.all_reduce

    def counted(tensor, *args, **kwargs):
        calls.append(tensor.numel())
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counted
    try:
        fn()
    finally:
        dist.all_reduce = real
    return len(calls), sum(calls)


def dtensor_collectives_of(fn):
    """The collectives that DTensor issues in ``fn``: ``{op: (calls,
    elements)}``. DTensor desugars each redistribution into a functional
    collective on plain tensors, which a dispatch mode sees after it."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {}

    class Seen(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            name = str(func).split(".")
            if name[0] == "_c10d_functional" and name[1] not in (
                    "wait_tensor",):
                calls, elements = seen.get(name[1], (0, 0))
                seen[name[1]] = (calls + 1, elements + args[0].numel())
            return func(*args, **(kwargs or {}))

    with Seen():
        fn()
    torch.cuda.synchronize()
    return seen


def per_iteration_collectives(solve, lo, hi):
    """DTensor's collectives per iteration of ``solve(n)``: ``{op: (calls,
    elements)}`` between ``lo`` and ``hi`` iterations."""
    a, b = (dtensor_collectives_of(lambda n=n: solve(n)) for n in (lo, hi))
    return {op: ((b[op][0] - a.get(op, (0, 0))[0]) / (hi - lo),
                 (b[op][1] - a.get(op, (0, 0))[1]) / (hi - lo)) for op in b}


def auto_spmd_phase(mods, problem, card, mesh):
    """Phase 16, the rest of the scale-out on the one-rank NCCL mesh: the
    auto-SPMD routes (bsdmm weighted, AdaProx AMSGrad, PGM accelerated
    through ``nmf(mesh=)``; admm on the TV denoise with x a DTensor sharded
    over columns), each against its single-card solve, with its marginal
    ms/iter in turns beside the single-card driver and DTensor's
    collectives per iteration; and the per-rank programs of
    ``export_nmf_pgm_sharded`` (weighted, stride 10, ``resume=True``) and
    ``export_nmf_adaprox_sharded`` (Adam), loaded here and held against
    their live sharded solves bit for bit, with their ms/iter beside the
    live solves'."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from proxmin_tpu_torch import algorithms, linop
    from proxmin_tpu_torch import export as tex
    from proxmin_tpu_torch import operators as top

    tnmf, tpar = mods
    Y, A0, S0, Ww = problem
    routes = (
        ("bsdmm weighted", dict(algorithm="bsdmm", W=Ww)),
        ("adaprox amsgrad", dict(algorithm="adaprox", scheme="amsgrad")),
        ("pgm accelerated", dict(accelerated=True)),
    )
    timing = []
    for label, kw in routes:
        r = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=AUTO_ITERS,
                     mesh=mesh, **kw)
        ref = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=AUTO_ITERS,
                       engine="torch", **kw)
        torch.cuda.synchronize()
        kind = r.state.get("kind") if hasattr(r.state, "get") else None
        check(kind not in ("nmf_pgm_sharded", "nmf_adaprox_sharded")
              and all(isinstance(x, DTensor) for x in r.x),
              f"auto-SPMD {label}: routed to {kind}")
        check(r.iterations == ref.iterations == AUTO_ITERS,
              f"auto-SPMD {label}: {r.iterations} iterations, torch engine "
              f"{ref.iterations}")
        A_, S_ = (x.to_local() for x in r.x)
        check(bool(torch.isfinite(A_).all() and torch.isfinite(S_).all()),
              f"auto-SPMD {label}: non-finite iterate")
        n_A, n_S = norm_err(A_, ref.x[0]), norm_err(S_, ref.x[1])
        check(n_A <= ENGINE_RTOL and n_S <= ENGINE_RTOL,
              f"auto-SPMD {label}: against nmf(engine='torch') normwise A "
              f"{n_A:.2e}, S {n_S:.2e} > {ENGINE_RTOL:g}")
        check(torch.equal(A_, ref.x[0]) and torch.equal(S_, ref.x[1]),
              f"auto-SPMD {label}: not bit for bit the torch engine on one "
              "rank")
        log(f"auto-SPMD [{label}]: nmf(mesh=make_mesh()) on one NCCL rank "
            f"(the driver on DTensor shards) vs nmf(engine='torch'), "
            f"{AUTO_ITERS} iterations at e_rel=0: normwise A {n_A:.2e}, S "
            f"{n_S:.2e} (tol {ENGINE_RTOL:g}), bit for bit; loss "
            f"{wloss(A_, S_, Y, kw.get('W')):.6e} (torch engine "
            f"{wloss(*ref.x, Y, kw.get('W')):.6e})")

        def sharded(n, kw=kw):
            return tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n, mesh=mesh, **kw)

        def single(n, kw=kw):
            return tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n, engine="torch",
                            **kw)

        timing.append((label, sharded, single))

    # admm on the TV denoise, x sharded over columns: the vertical
    # differences act within a column, so every shard works alone
    H = FN_TV_H
    _, y_tv = tv_problem(H)
    _, Dv = tv_operators(linop, H)
    y_d = distribute_tensor(y_tv, mesh, [Shard(1)])

    def tv_admm(n, sharded_x):
        y = y_d if sharded_x else y_tv
        x0 = torch.zeros_like(y)

        def prox_quad(x, step):
            return (x + step * y) / (1.0 + step)

        return algorithms.admm(x0, prox_quad, TV_STEP_F,
                               prox_g=partial(top.prox_soft, thresh=TV_LAM),
                               L=Dv, e_rel=0, e_abs=0, max_iter=n)

    r, ref = tv_admm(AUTO_TV_ITERS, True), tv_admm(AUTO_TV_ITERS, False)
    torch.cuda.synchronize()
    x_ = r.x.to_local()
    n_x = norm_err(x_, ref.x)
    check(isinstance(r.x, DTensor) and r.x.placements == (Shard(1),)
          and r.iterations == ref.iterations and n_x <= ENGINE_RTOL,
          f"auto-SPMD admm TV: {r.iterations} iterations (plain "
          f"{ref.iterations}), normwise {n_x:.2e}")
    log(f"auto-SPMD [admm TV {H}x{H}, vertical differences, x sharded over "
        f"columns]: against its plain solve after {AUTO_TV_ITERS} "
        f"iterations normwise {n_x:.2e} (tol {ENGINE_RTOL:g})"
        f"{', bit for bit' if torch.equal(x_, ref.x) else ''}")
    timing.append(("admm TV", lambda n: tv_admm(n, True),
                   lambda n: tv_admm(n, False)))

    for label, sharded, single in timing:
        timed(sharded, 3)
        timed(single, 3)
        ms_t, ms_s, ms_s2, ms_t2 = (turn_ms(f) for f in (single, sharded,
                                                         sharded, single))
        per_it = per_iteration_collectives(sharded, COUNT_LO, COUNT_HI)
        log(f"auto-SPMD [{label}]: {min(ms_s, ms_s2):.4f} ms/iter marginal "
            f"on one NCCL rank ({ms_s:.4f}, {ms_s2:.4f}), single card "
            f"{min(ms_t, ms_t2):.4f} ({ms_t:.4f}, {ms_t2:.4f}); order "
            f"single, sharded, sharded, single, between {TURN_LO} and "
            f"{TURN_HI} iterations; DTensor collectives per iteration "
            + (", ".join(f"{op} {c:.2f} calls of {e / max(c, 1):.1f} "
                         f"elements" for op, (c, e) in per_it.items())
               or "none (DTensor skips a reduction over one rank)")
            + f"; on {card}")
        check(set(per_it) <= {"all_reduce"},
              f"auto-SPMD {label}: collectives other than all-reduces "
              f"{sorted(per_it)}")

    # the per-rank programs against their live sharded solves
    Yd, Ad, Sd, Wd = tpar.shard_nmf_problem(mesh, Y, A0, S0, Ww)
    t0 = time.perf_counter()
    pgm_blob = tex.export_nmf_pgm_sharded(mesh, C, K, N, e_rel=0.0,
                                          weighted=True, step_stride=STRIDE,
                                          resume=True)
    t_pgm = time.perf_counter() - t0
    t0 = time.perf_counter()
    ada_blob = tex.export_nmf_adaprox_sharded(mesh, C, K, N, e_rel=0.0)
    t_ada = time.perf_counter() - t0
    pgm_prog, ada_prog = tex.load_solver(pgm_blob), tex.load_solver(ada_blob)
    v0 = tpar.sharding._weighted_steps_v0(Ad.to_local(), Sd.to_local())
    v0 = DTensor.from_local(v0, mesh, [Shard(0)], run_check=False,
                            shape=(N, K), stride=(K, 1))

    def fresh_carries():
        z = torch.zeros((), device=DEVICE)
        return (0, False, False, float("inf"), z, z.clone(), STRIDE, 0, v0)

    def live_pgm(n, state=None, x=None):
        return tpar.nmf_pgm_sharded(Y, *(x or (A0, S0)), W=Ww, mesh=mesh,
                                    e_rel=0, max_iter=n,
                                    step_stride=STRIDE, state=state)

    total = sum(PROG_CHAIN)
    straight = live_pgm(total)
    half = live_pgm(PROG_CHAIN[0])
    st = half.state
    o_fresh = pgm_prog(Ad, Sd, Yd, Wd, total, *fresh_carries())
    o_state = pgm_prog(*half.x, Yd, Wd, PROG_CHAIN[1], st["it"],
                       st["conv_A"], st["conv_S"], st["loss"], st["step_A"],
                       st["step_S"], st["stride"], st["seg_end"], st["v"])
    o1 = pgm_prog(Ad, Sd, Yd, Wd, PROG_CHAIN[0], *fresh_carries())
    o_chain = pgm_prog(o1[0], o1[1], Yd, Wd, PROG_CHAIN[1], *o1[2:])
    torch.cuda.synchronize()
    for how, o in (("from a fresh start", o_fresh),
                   (f"resumed from the live solve's {PROG_CHAIN[0]}-"
                    "iteration state", o_state),
                   (f"chained {PROG_CHAIN[0]} + {PROG_CHAIN[1]}", o_chain)):
        same = int(o[2]) == total and all(
            torch.equal(a.to_local(), b.to_local())
            for a, b in zip(o[:2], straight.x)) and float(o[5]) == \
            straight.loss
        check(same, f"sharded program pgm weighted stride {STRIDE} {how}: "
                    f"differs from the live {total} iterations")
    log(f"sharded program [pgm weighted stride {STRIDE}, resume=True]: "
        f"exported in {t_pgm:.2f} s, {len(pgm_blob) / 1e6:.2f} MB; from a "
        f"fresh start, from the live solve's state after {PROG_CHAIN[0]} "
        f"and chained {PROG_CHAIN[0]} + {PROG_CHAIN[1]}: each = the live "
        f"{total} iterations bit for bit (loss {straight.loss:.6e})")

    def live_ada(n):
        return tnmf.nmf(Yd, Ad, Sd, algorithm="adaprox", e_rel=0,
                        max_iter=n)

    ref = live_ada(SHARD_ITERS)
    o = ada_prog(Ad, Sd, Yd, SHARD_ITERS)
    torch.cuda.synchronize()
    check(int(o[8]) == SHARD_ITERS and all(
        torch.equal(a.to_local(), b.to_local())
        for a, b in zip(o[:2], ref.x)),
        f"sharded program adaprox: differs from the live auto-SPMD solve "
        f"after {SHARD_ITERS} iterations")
    log(f"sharded program [adaprox adam]: exported in {t_ada:.2f} s, "
        f"{len(ada_blob) / 1e6:.2f} MB; = the live driver on the DTensor "
        f"shards bit for bit after {SHARD_ITERS} iterations")
    for label, prog, live in (
            ("pgm weighted stride 10", lambda n: pgm_prog(
                Ad, Sd, Yd, Wd, n, *fresh_carries()), live_pgm),
            ("adaprox adam", lambda n: ada_prog(Ad, Sd, Yd, n), live_ada)):
        timed(prog, 3)
        timed(live, 3)
        ms_l, ms_p, ms_p2, ms_l2 = (turn_ms(f) for f in (live, prog, prog,
                                                         live))
        log(f"sharded program [{label}]: {min(ms_p, ms_p2):.4f} ms/iter "
            f"marginal ({ms_p:.4f}, {ms_p2:.4f}), its live sharded solve "
            f"{min(ms_l, ms_l2):.4f} ({ms_l:.4f}, {ms_l2:.4f}); order live, "
            f"program, program, live, between {TURN_LO} and {TURN_HI} "
            f"iterations; on {card}")


def sharded_phase(mods, problem, card):
    """Phase 16, the sharded path: a one-rank NCCL group, and through
    ``nmf(mesh=make_mesh())`` the exact PGM, the weighted PGM at stride 10
    and adaptive, and AdaProx at the flagship, each against the single-card
    ``nmf(engine="torch")`` (normwise within ENGINE_RTOL, equal iterations
    at e_rel=0); the exact PGM on a 1 x 1 ``('data', 'model')`` mesh with
    ``model_axis``; the weighted adaptive solve and AdaProx resumed in two
    pieces (the PGM one through a sharded checkpoint on disk) bit for bit;
    the exact solve on two gloo ranks on the same card against the
    one-rank result; and for each path its marginal ms/iter in turns with
    the torch engine, its all-reduce calls and elements per iteration and
    its device-to-host copies per iteration beside the torch engine's."""
    import torch.distributed as dist

    tnmf, tpar, ckpt = mods
    Y, A0, S0, Ww = problem
    info = tpar.initialize_distributed(f"localhost:{free_port()}", 1, 0)
    check(info.process_count == 1 and dist.get_backend() == "nccl",
          f"sharded: {info}, backend {dist.get_backend()}")
    mesh = tpar.make_mesh()
    check(mesh.device_type == "cuda", f"sharded: mesh on {mesh.device_type}")
    paths = (
        ("pgm exact", {}, {}),
        ("pgm weighted stride 10", dict(W=Ww, step_stride=STRIDE), {}),
        ("pgm weighted adaptive", dict(W=Ww, step_stride=STRIDE,
                                       step_adapt=True), {}),
        ("adaprox", dict(algorithm="adaprox"), dict(separable_prox="auto")),
    )
    results = {}
    for label, kw, ref_kw in paths:
        r = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=SHARD_ITERS, mesh=mesh,
                     **kw)
        ref = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=SHARD_ITERS,
                       engine="torch", **kw, **ref_kw)
        torch.cuda.synchronize()
        kind = ("nmf_adaprox_sharded" if "algorithm" in kw
                else "nmf_pgm_sharded")
        check(r.state["kind"] == kind, f"sharded {label}: routed to "
              f"{r.state['kind']}")
        check(r.iterations == ref.iterations == SHARD_ITERS,
              f"sharded {label}: {r.iterations} iterations, torch engine "
              f"{ref.iterations}")
        A_, S_ = (x.to_local() for x in r.x)
        check(A_.is_cuda and tuple(S_.shape) == (K, N),
              f"sharded {label}: S {tuple(S_.shape)} on {S_.device}")
        check(bool(torch.isfinite(A_).all() and torch.isfinite(S_).all()),
              f"sharded {label}: non-finite iterate")
        n_A, n_S = norm_err(A_, ref.x[0]), norm_err(S_, ref.x[1])
        check(n_A <= ENGINE_RTOL and n_S <= ENGINE_RTOL,
              f"sharded {label}: against nmf(engine='torch') normwise A "
              f"{n_A:.2e}, S {n_S:.2e} > {ENGINE_RTOL:g}")
        W_ = kw.get("W")
        loss_r = wloss(A_, S_, Y, W_)
        check(loss_r < wloss(A0, S0, Y, W_), f"sharded {label}: the loss "
              "did not decrease")
        results[label] = r
        log(f"sharded [{label}]: nmf(mesh=make_mesh()) on one NCCL rank vs "
            f"nmf(engine='torch'), {SHARD_ITERS} iterations at e_rel=0: "
            f"normwise A {n_A:.2e}, S {n_S:.2e} (tol {ENGINE_RTOL:g}); "
            f"loss {loss_r:.6e} (torch engine "
            f"{wloss(*ref.x, Y, W_):.6e}); iterations {r.iterations}")

    # the channel axis on a 1 x 1 ('data', 'model') mesh
    mesh2 = tpar.make_mesh((1, 1))
    r2 = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=SHARD_ITERS, mesh=mesh2,
                  model_axis="model")
    ref = results["pgm exact"]
    n_A = norm_err(r2.x[0].to_local(), ref.x[0].to_local())
    n_S = norm_err(r2.x[1].to_local(), ref.x[1].to_local())
    check(r2.iterations == SHARD_ITERS and n_A <= ENGINE_RTOL
          and n_S <= ENGINE_RTOL, f"sharded 1 x 1 model_axis: "
          f"{r2.iterations} iterations, A {n_A:.2e}, S {n_S:.2e}")
    log(f"sharded [pgm exact, 1 x 1 ('data', 'model'), model_axis]: "
        f"against the 1-D mesh normwise A {n_A:.2e}, S {n_S:.2e}; "
        f"placements of A {r2.x[0].placements}")

    # resumes in two pieces: the weighted adaptive PGM through a sharded
    # checkpoint on disk, AdaProx directly
    for label, kw in (("pgm weighted adaptive", paths[2][1]),
                      ("adaprox", paths[3][1])):
        full = results[label]
        half = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=SHARD_SPLIT, mesh=mesh,
                        **kw)
        x, state, how = half.x, half.state, "state="
        if label.startswith("pgm"):
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                path = ckpt.save_checkpoint(f"{tmp}/pod", x=half.x,
                                            solver_state=half.state)
                t_save = time.perf_counter() - t0
                del half, x, state
                t0 = time.perf_counter()
                ck = ckpt.load_checkpoint(path, mesh=mesh)
                t_load = time.perf_counter() - t0
            x, state = ck["x"], ck["solver_state"]
            how = (f"a sharded checkpoint (saved in {t_save:.3f} s, loaded "
                   f"in {t_load:.3f} s)")
        rest = tnmf.nmf(Y, *x, e_rel=0, max_iter=SHARD_ITERS - SHARD_SPLIT,
                        mesh=mesh, state=state, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a.to_local(), b.to_local())
                   for a, b in zip(rest.x, full.x))
        check(same and rest.loss == full.loss and rest.state["it"]
              == SHARD_ITERS, f"sharded {label}: {SHARD_SPLIT} + "
              f"{SHARD_ITERS - SHARD_SPLIT} through {how} differs from "
              f"{SHARD_ITERS} straight")
        log(f"sharded [{label}]: {SHARD_SPLIT} + "
            f"{SHARD_ITERS - SHARD_SPLIT} iterations through {how} equal "
            f"{SHARD_ITERS} straight bit for bit")

    # the exact solve on two gloo ranks on this one card
    if GLOO_TWO_RANKS:
        with tempfile.TemporaryDirectory() as tmp:
            port = free_port()
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-c", GLOO_RANK_SCRIPT, str(port), str(r),
                 tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for r in range(2)]
            logs = []
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=300)[0])
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    logs.append(p.communicate()[0])
            for r, (p, out) in enumerate(zip(procs, logs)):
                check(p.returncode == 0,
                      f"sharded gloo rank {r} failed: {out[-3000:]}")
            parts = [torch.load(f"{tmp}/rank{r}.pt") for r in range(2)]
        t_two = time.perf_counter() - t0
        one = results["pgm exact"]
        S2 = torch.cat([p["S"] for p in parts], dim=1)
        n_A = norm_err(parts[0]["A"], one.x[0].to_local().cpu())
        n_S = norm_err(S2, one.x[1].to_local().cpu())
        check(torch.equal(parts[0]["A"], parts[1]["A"])
              and parts[0]["loss"] == parts[1]["loss"]
              and all(p["iterations"] == SHARD_ITERS for p in parts)
              and n_A <= GLOO_RTOL and n_S <= GLOO_RTOL,
              f"sharded two gloo ranks: A {n_A:.2e}, S {n_S:.2e} against "
              f"one rank (tol {GLOO_RTOL:g}), losses "
              f"{[p['loss'] for p in parts]}")
        log(f"sharded [pgm exact, two gloo ranks on the one card]: against "
            f"the one-rank NCCL result normwise A {n_A:.2e}, S {n_S:.2e} "
            f"(tol {GLOO_RTOL:g}); the same A and loss on both ranks; "
            f"{t_two:.1f} s with the processes' start")
        # the auto-SPMD bsdmm route and the exact program on the two ranks
        one_b = tnmf.nmf(Y, A0, S0, mesh=mesh, algorithm="bsdmm", e_rel=0,
                         max_iter=AUTO_ITERS)
        b_S = torch.cat([p["bsdmm_S"] for p in parts], dim=1)
        n_bA = norm_err(parts[0]["bsdmm_A"], one_b.x[0].to_local().cpu())
        n_bS = norm_err(b_S, one_b.x[1].to_local().cpu())
        check(torch.equal(parts[0]["bsdmm_A"], parts[1]["bsdmm_A"])
              and all(p["bsdmm_iterations"] == AUTO_ITERS for p in parts)
              and n_bA <= GLOO_RTOL and n_bS <= GLOO_RTOL,
              f"sharded two gloo ranks, bsdmm under mesh=: A {n_bA:.2e}, S "
              f"{n_bS:.2e} against one rank (tol {GLOO_RTOL:g})")
        p_same = all(torch.equal(p["program_A"], p["A"])
                     and torch.equal(p["program_S"], p["S"])
                     and p["program_loss"] == p["loss"]
                     and p["program_iterations"] == SHARD_ITERS
                     for p in parts)
        check(p_same, "sharded two gloo ranks: the exact PGM program differs "
                      "from the live sharded solve on its rank")
        log(f"sharded [two gloo ranks on the one card]: nmf(mesh=, "
            f"algorithm='bsdmm') against the one-rank NCCL result after "
            f"{AUTO_ITERS} iterations normwise A {n_bA:.2e}, S {n_bS:.2e} "
            f"(tol {GLOO_RTOL:g}); each rank's exact PGM program = its live "
            f"sharded solve bit for bit after {SHARD_ITERS} iterations (so "
            f"within the same {GLOO_RTOL:g} of the one-rank result)")

    # per iteration: ms in turns with the torch engine, all-reduces, copies
    lo, hi = SHARD_COUNT
    for label, kw, ref_kw in paths:
        def sharded(n, kw=kw):
            return tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n, mesh=mesh, **kw)

        def single(n, kw=kw, ref_kw=ref_kw):
            return tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n, engine="torch",
                            **kw, **ref_kw)

        timed(sharded, 5)
        timed(single, 5)
        ms_t, ms_s, ms_s2, ms_t2 = (marginal_ms(f, LO, HI) for f in
                                    (single, sharded, sharded, single))
        (c_lo, e_lo), (c_hi, e_hi) = (
            all_reduces_of(lambda n=n: sharded(n)) for n in (lo, hi))
        d_s = (dtoh_copies(lambda: sharded(hi))
               - dtoh_copies(lambda: sharded(lo))) / (hi - lo)
        d_t = (dtoh_copies(lambda: single(hi))
               - dtoh_copies(lambda: single(lo))) / (hi - lo)
        log(f"sharded [{label}]: {min(ms_s, ms_s2):.4f} ms/iter marginal on "
            f"one NCCL rank ({ms_s:.4f}, {ms_s2:.4f}), nmf(engine='torch') "
            f"{min(ms_t, ms_t2):.4f} ({ms_t:.4f}, {ms_t2:.4f}); order "
            f"torch, sharded, sharded, torch; all_reduce "
            f"{(c_hi - c_lo) / (hi - lo):.2f} calls and "
            f"{(e_hi - e_lo) / (hi - lo):.1f} elements per iteration; "
            f"device-to-host copies {d_s:.2f} per iteration (torch engine "
            f"{d_t:.2f}); on {card}")
    # what one all-reduce of the exact path's gradient and Gram costs the
    # host on the one-rank group (the solves make two per iteration)
    buf = torch.zeros(C * K + K * K, device=DEVICE)
    us = host_us(lambda: dist.all_reduce(buf, group=mesh.get_group("data")),
                 calls=200)
    log(f"sharded: one all_reduce of {buf.numel()} float32 on the one-rank "
        f"NCCL group costs {us:.1f} us of host per call; on {card}")
    auto_spmd_phase((tnmf, tpar), problem, card, mesh)
    dist.destroy_process_group()



def route_expected(tnmf, calibrate, C_, K_, N_, path):
    """What the routing table says for ``path`` at (C, K, N): ``"cuda"``,
    ``"torch"``, or ``"probe"`` inside a gray zone (the probes decide)."""
    algorithm, weighted, _, kw = ROUTE_PATHS[path]
    if "store_dtype" in kw or "moment_dtype" in kw:
        return "cuda"  # a precision opt-in only the kernels serve
    if algorithm == "adaprox":
        return "cuda" if tnmf._adaprox_fused_wins(C_, K_, N_) else "torch"
    strided = "step_stride" in kw or "step_adapt" in kw
    if calibrate.in_gray_zone(C_, K_, N_, weighted, strided):
        return "probe"
    wins = (tnmf._weighted_fused_wins if weighted
            else tnmf._unweighted_strided_fused_wins if strided
            else tnmf._unweighted_fused_wins)
    return "cuda" if wins(C_, K_, N_) else "torch"


def same_solve(a, b):
    """Two solves' factors and iteration counts equal, bit for bit."""
    return (a.iterations == b.iterations
            and all(torch.equal(x, y) for x, y in zip(a.x, b.x)))


def equivalence_problem(C_, K_, N_, seed, weighted):
    """benchmarks/engine_equivalence.py's make_problem (random start, noise
    0.02), re-made with NumPy: Y, A0, S0 and W (or None) on the card."""
    rng = np.random.default_rng(seed)
    A_true = rng.random((C_, K_)).astype(np.float32)
    S_true = rng.random((K_, N_)).astype(np.float32)
    Y = (A_true @ S_true
         + 0.02 * rng.standard_normal((C_, N_))).astype(np.float32)
    A0 = rng.random((C_, K_)).astype(np.float32)
    S0 = rng.random((K_, N_)).astype(np.float32)
    W = (0.5 + rng.random((C_, N_))).astype(np.float32) if weighted else None
    return tuple(None if a is None else torch.from_numpy(a).to(DEVICE)
                 for a in (Y, A0, S0, W))


def equivalence_stats(rows):
    """engine_equivalence.summarize: the convergence rate, and over the
    converged seeds the median iterations and the loss's median and 10 %
    and 90 % quantiles."""
    conv = [r for r in rows if r["converged"]]
    out = {"conv_rate": len(conv) / max(len(rows), 1)}
    if conv:
        losses = np.asarray([r["loss"] for r in conv], np.float64)
        out.update(iters_med=float(np.median([r["iterations"]
                                              for r in conv])),
                   loss_med=float(np.quantile(losses, 0.5)),
                   loss_q10=float(np.quantile(losses, 0.1)),
                   loss_q90=float(np.quantile(losses, 0.9)))
    return out


def equivalent(E, B, bound=EQUIV_ACCEPTANCE):
    """engine_equivalence.check_equivalence of engine E against baseline B:
    ``(ok, checks)``."""
    checks = {"conv_rate": abs(E["conv_rate"] - B["conv_rate"])
              <= bound["conv_rate_tol"]}
    if E.get("iters_med") and B.get("iters_med"):
        ratio = E["iters_med"] / B["iters_med"]
        checks["iterations"] = (1 / bound["iter_ratio"] <= ratio
                                <= bound["iter_ratio"])
        spread = max(B["loss_q90"] - B["loss_q10"],
                     E["loss_q90"] - E["loss_q10"])
        tol = max(bound["loss_spread_margin"] * spread,
                  bound["loss_frac_floor"] * abs(B["loss_med"]))
        checks["loss"] = abs(E["loss_med"] - B["loss_med"]) <= tol
    else:
        checks["iterations"] = checks["loss"] = False
    return all(checks.values()), checks


def equivalence_check(tnmf, top, C_, K_, N_, path, card):
    """EQUIV_SEEDS seeds of the engine-equivalence problem at (C, K, N)
    through both engines of ``path`` to EQUIV_E_REL, with the study's
    proxes (PGM: ``unity_A``, rows of A on the simplex and S non-negative;
    AdaProx: ``plain``, both non-negative, which its fused engine needs);
    the cuda engine against the torch engine under EQUIV_ACCEPTANCE."""
    algorithm, weighted, kw_torch, kw_cuda = ROUTE_PATHS[path]
    prox_A = (partial(top.prox_unity_plus, axis=1) if algorithm == "pgm"
              else top.prox_plus)
    rows = {"torch": [], "cuda": []}
    t0 = time.perf_counter()
    for i in range(EQUIV_SEEDS):
        Y, A0, S0, W = equivalence_problem(C_, K_, N_, 1000 + i, weighted)
        for eng, kw in (("torch", kw_torch), ("cuda", kw_cuda)):
            res = tnmf.nmf(Y, A0, S0, W=1 if W is None else W,
                           prox_A=prox_A, prox_S=top.prox_plus,
                           algorithm=algorithm,
                           e_rel=EQUIV_E_REL, max_iter=EQUIV_MAX_ITER,
                           engine=eng, **kw)
            rows[eng].append({"iterations": res.iterations,
                              "converged": all(res.converged),
                              "loss": wloss(*res.x, Y, W)})
    stats = {e: equivalence_stats(r) for e, r in rows.items()}
    ok, checks = equivalent(stats["cuda"], stats["torch"])
    log(f"routing equivalence [{path} at ({C_}, {K_}, {N_})]: "
        f"{EQUIV_SEEDS} seeds to e_rel {EQUIV_E_REL:g} in "
        f"{time.perf_counter() - t0:.1f} s; torch {stats['torch']}, cuda "
        f"{stats['cuda']}; checks {checks}; on {card}")
    check(stats["torch"]["conv_rate"] >= 0.9,
          f"routing equivalence [{path}]: the torch engine converged on "
          f"{stats['torch']['conv_rate']:.0%} of the seeds")
    check(ok, f"routing equivalence [{path} at ({C_}, {K_}, {N_})]: the "
          f"engines differ beyond the bound: {checks}")


def route_gray_shape(tnmf):
    """A shape inside a gray zone of the routing table, ``(path, (C, K,
    N))``: the band of the first PGM region that has one, at its smallest
    swept (C, K) and the band's least N; None without a band."""
    for path in ("pgm-exact", "pgm-stride10", "pgm-w-stride10"):
        for (c, k), (_, gray) in sorted(tnmf._H100_REGIONS[path].items()):
            if gray is not None:
                return path, (c, k, gray[0])
    return None

def route_boundaries(tnmf):
    """Where the equivalence check runs: for each region of the routing
    table (exact, stride 10, weighted, AdaProx), the boundary at the
    flagship's (C, K), or, where that shape has none, at the smallest swept
    (C, K) that has one, at the least N of its gray range (where auto may
    take either engine, and a solve costs least): ``(path, (C, K, N))``. A
    region without any crossover draws no boundary."""
    out = []
    for path in ("pgm-exact", "pgm-stride10", "pgm-w-stride10",
                 "adaprox-f32"):
        table = tnmf._H100_REGIONS[path]
        for c, k in sorted(table, key=lambda ck: ck != (C, K)):
            gray = table[c, k][1]
            if gray is not None:
                out.append((path, (c, k, gray[0])))
                break
    return out

def routing_phase(mods, card):
    """Phase 17, ``nmf(engine="auto")``: for each ROUTE_PATHS path at the
    flagship and at full width, auto's choice against the routing table,
    auto's solve equal to the chosen engine's bit for bit, the K1/K2
    launches auto made (more than none wherever it chose cuda) and both
    engines' marginal ms/iter in turns; a gray-zone shape probed once and
    then served from the cache; and the engine-equivalence check at the
    table's boundaries (see
    ``route_boundaries``). Returns the K1/K2 launches of auto's solves:
    ``{"K1": n, "K1 bf16 store": n, "K2": n, "K1 wide": n, "K2 wide": n}``."""
    tnmf, top, kk, calibrate = mods
    k1, k2 = kk.fused_nmf_pgm_step, kk.fused_nmf_adaprox_step
    counted = (k1, k2)
    launched = dict.fromkeys(("K1", "K1 bf16 store", "K2", "K1 wide",
                              "K2 wide"), 0)
    probes = []
    real_choice = calibrate.measured_choice

    def counted_choice(key, fns, fallback, **kw):
        fns = {e: (lambda n, _f=f: (probes.append(key), _f(n))[1])
               for e, f in fns.items()}
        return real_choice(key, fns, fallback, **kw)

    tmp = tempfile.TemporaryDirectory()
    os.environ["PROXMIN_TPU_TORCH_AUTOTUNE_CACHE"] = os.path.join(
        tmp.name, "routing.json")
    calibrate.clear_cache()
    calibrate._DISK, calibrate._DISK_LOADED = {}, False
    calibrate.set_auto_calibration("on")
    calibrate.measured_choice = counted_choice
    try:
        for label, shape in (("flagship", (C, K, N)), ("full width", WIDE)):
            problem = route_problem(*shape)
            for path in ROUTE_PATHS:
                expected = route_expected(tnmf, calibrate, *shape, path)
                solves = {e: route_solver(tnmf, top, problem, path, e)
                          for e in ("torch", "cuda", "auto")}
                n_probes = len(probes)
                reset_counts(counted)
                reset_routes(counted)
                res_a = solves["auto"](ROUTE_ITERS)
                torch.cuda.synchronize()
                routes = route_counts(counted)
                n_k = k1.launches + k2.launches
                probed = len(probes) > n_probes
                ref = {e: solves[e](ROUTE_ITERS) for e in ("torch", "cuda")}
                chose = [e for e in ref if same_solve(res_a, ref[e])]
                check(len(chose) >= 1, f"routing [{label}, {path}]: auto's "
                      "solve equals neither engine's bit for bit")
                if len(chose) == 2:  # the engines agree bit for bit
                    chose = (expected if expected in chose
                             else "cuda" if n_k and not probed else "torch")
                else:
                    chose = chose[0]
                check(expected in (chose, "probe"),
                      f"routing [{label}, {path}]: the table says "
                      f"{expected}, auto ran {chose}")
                if chose == "cuda":
                    check(n_k >= ROUTE_ITERS, f"routing [{label}, {path}]: "
                          f"auto chose cuda and launched K1/K2 {n_k} times "
                          f"in {ROUTE_ITERS} iterations")
                elif not probed:
                    check(n_k == 0, f"routing [{label}, {path}]: auto "
                          f"chose torch but launched K1/K2 {n_k} times")
                if not probed:
                    wide = shape[0] > 16 or shape[1] > 8
                    k1_key = ("K1 wide" if wide else "K1 bf16 store"
                              if "store_dtype" in ROUTE_PATHS[path][3]
                              else "K1")
                    launched[k1_key] += sum(
                        routes[k1.__name__].values())
                    launched["K2 wide" if wide else "K2"] += sum(
                        routes[k2.__name__].values())
                timed(solves["torch"], TURN_LO)
                timed(solves["cuda"], TURN_LO)
                ms = {e: [] for e in ("torch", "cuda")}
                for e in ("torch", "cuda", "cuda", "torch"):
                    ms[e].append(turn_ms(solves[e]))
                log(f"routing [{label} {shape}, {path}]: table {expected}, "
                    f"auto ran {chose}" + (" after probing" if probed else "")
                    + f", equal to it bit for bit over {ROUTE_ITERS} "
                    f"iterations; K1/K2 launches {routes}; marginal ms/iter "
                    f"torch {min(ms['torch']):.4f} ({ms['torch'][0]:.4f}, "
                    f"{ms['torch'][1]:.4f}), cuda {min(ms['cuda']):.4f} "
                    f"({ms['cuda'][0]:.4f}, {ms['cuda'][1]:.4f}); order "
                    f"torch, cuda, cuda, torch; on {card}")
            del problem

        # a gray-zone shape: the first auto call probes, the second is
        # served from the cache
        calibrate.clear_cache()
        calibrate._DISK, calibrate._DISK_LOADED = {}, False
        if os.path.exists(calibrate._disk_path()):
            os.remove(calibrate._disk_path())
        gray = route_gray_shape(tnmf)
        if gray is None:
            log("routing: the table has no gray zone at the swept shapes")
        else:
            path, shape = gray
            problem = route_problem(*shape)
            auto = route_solver(tnmf, top, problem, path, "auto")
            n0 = len(probes)
            auto(ROUTE_ITERS)
            n1 = len(probes)
            auto(ROUTE_ITERS)
            n2 = len(probes)
            check(n1 > n0 and n2 == n1, f"routing gray zone [{path} "
                  f"{shape}]: {n1 - n0} probe calls on the first auto "
                  f"solve, {n2 - n1} on the second")
            log(f"routing gray zone [{path} {shape}]: the first auto solve "
                f"made {n1 - n0} probe calls, the second none (cache: "
                f"{dict(calibrate._CACHE)}); on {card}")
            del problem

    finally:
        calibrate.measured_choice = real_choice
        tmp.cleanup()
        del os.environ["PROXMIN_TPU_TORCH_AUTOTUNE_CACHE"]
    torch.cuda.empty_cache()

    # the engine-equivalence contract at the table's boundaries
    for path, shape in route_boundaries(tnmf):
        equivalence_check(tnmf, top, *shape, path, card)
    return launched

# the TPU kernels the very-wide body's instances replace
K1_AT = "proxmin_tpu/ops/nmf_kernels.py:311"
K2_AT = "proxmin_tpu/ops/nmf_kernels.py:525"
K3_AT = "proxmin_tpu/ops/nmf_kernels.py:653"


def very_wide_phase(mods, card):
    """Phase 18, the very-wide path: K1's compiled chain and split passes,
    K2's (float32 and bfloat16 moments, its device-scalar entry) and K3's
    very-wide instances against their plain versions at C=425, K=32,
    N=1e6, at (128, 64, 250_000), at (128, 96, 4097) and at
    (64, 160, 4097), two launches bitwise equal, each timed beside its plain
    version and its bound; K5 beyond C, K <= 8 at (16, 12, 1e6); then
    nmf(engine="cuda") exact PGM, weighted PGM at stride 10 and AdaProx
    against engine="torch" at the four shapes, the loss falling, 10 + 20
    resumed bit for bit, the split path with the prox as a closure (K1, K2,
    and K3 as pgm's gradient), ``engine="auto"`` on exact PGM and AdaProx
    against the engine the routing table's rows name (bit for bit,
    calibration off), and both engines' marginal ms/iter in turns at the
    first two. Returns the times, the errors and the launches of the main
    path's run per (shape label, kernel, route), for the kernels line."""
    algorithms, tnmf, top, tops, kk, sm, calibrate = mods
    k1, k2, k3 = (kk.fused_nmf_pgm_step, kk.fused_nmf_adaprox_step,
                  kk.fused_nmf_grad)
    counted = (k1, k2, k3)
    simplex = partial(top.prox_unity_plus, axis=0)
    l1 = partial(top.prox_soft_plus, thresh=WIDE_L1, type="relative")

    def simplex_closure(x, s):
        return top.prox_unity_plus(x, s, axis=0)

    def l1_closure(x, s):
        return top.prox_soft_plus(x, s, thresh=WIDE_L1, type="relative")

    bf = torch.bfloat16
    tile = kk.DEFAULT_TILE_N
    results, times = {}, {}

    def timing(key, call, plain, moved, ops):
        k_ms = min(cuda_ms(call, reps=10) for _ in range(2))
        p_ms = min(cuda_ms(plain, reps=5) for _ in range(2))
        times[key] = (k_ms, p_ms, bound_of(moved, ops))
        b = times[key][2]
        log(f"very wide time [{key}] on {card}: kernel {k_ms:.4f} ms "
            f"({ops / k_ms / 1e9:.1f} TFLOP/s, {moved / k_ms / 1e6:.0f} GB/s "
            f"of {moved / 1e6:.0f} MB), plain version {p_ms:.4f} ms, bound "
            f"{b[0]:.4f} ms by {b[1]} ({b[0] / k_ms:.1%} of it)")

    problems = {}
    for label, shape in VWIDE_LABELS:
        C_, K_, N_ = shape
        t0 = time.perf_counter()
        Y, A0, S0, W = problems[label] = make_unmixing(*shape)
        torch.cuda.synchronize()
        log(f"very wide [{label}]: C={C_} K={K_} N={N_} unmixing problem "
            f"made (seed {SEED}, NumPy) and moved to the card in "
            f"{time.perf_counter() - t0:.1f} s; Y {tensor_bytes(Y) / 1e9:.2f}"
            f" GB, W {tensor_bytes(W) / 1e9:.2f} GB")
        tag = f"{label}, C={C_} K={K_} N={N_}"
        sS = 1.0 / torch.linalg.eigvalsh(A0.T @ A0)[-1]
        for w_label, Wx in (("", None), (", W", W)):
            outs = {}
            for p_label, prox in (("chain", simplex),
                                  ("split", simplex_closure)):
                got = k1(A0, S0, Y, sS, W=Wx, prox_S=prox)
                again = k1(A0, S0, Y, sS, W=Wx, prox_S=prox)
                ref = kk.fused_nmf_pgm_step_reference(A0, S0, Y, sS, W=Wx,
                                                      prox_S=prox)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"K1 {p_label} [{tag}{w_label}]: two launches differ")
                results["K1", p_label, label, w_label] = compare_outputs(
                    f"K1 very wide {p_label} vs plain [{tag}{w_label}]", got,
                    ref, 4)
                outs[p_label] = got
            e = rel_err(outs["split"][1], outs["chain"][1])
            check(e <= CHAIN_SPLIT_RTOL, f"K1 [{tag}{w_label}]: compiled "
                  f"simplex and split path differ by {e:.3e}")
            del outs, got, again, ref
        got = k1(A0, S0.to(bf), Y.to(bf), sS, W=W.to(bf), prox_S=simplex)
        ref = kk.fused_nmf_pgm_step_reference(A0, S0.to(bf), Y.to(bf), sS,
                                              W=W.to(bf), prox_S=simplex)
        torch.cuda.synchronize()
        ok, ulps, diff = bf16_within(got[1], ref[1])
        check(ok and rel_err(got[0], ref[0]) <= STEP_RTOL,
              f"K1 bf16 store [{tag}]: S' {ulps:g} ulps, gA rel err "
              f"{rel_err(got[0], ref[0]):.3e}")
        log(f"K1 very wide bf16 store, W vs plain [{tag}]: S' {ulps:.3g} "
            f"bfloat16 ulps max ({diff:.3e} abs; tol 1 ulp + "
            f"{BF16_STORE_ATOL:g}); gA rel err {rel_err(got[0], ref[0]):.2e}")
        del got, ref
        rng = np.random.default_rng(SEED + 3)
        M_ = torch.from_numpy(0.1 * rng.standard_normal(
            (K_, N_), dtype=np.float32)).to(DEVICE)
        V_ = torch.from_numpy(0.01 * rng.random(
            (K_, N_), dtype=np.float32)).to(DEVICE)
        al_ = S0.sum(1, keepdim=True) / N_ / 10
        sc_ = tnmf._bias_corrections(0.9, 0.999, 3)
        dsc = torch.tensor([float(v) for v in sc_], dtype=torch.float32,
                           device=DEVICE)
        for m_label, mdt in (("f32 moments", torch.float32),
                             ("bf16 moments", bf)):
            for p_label, prox in (("chain", l1), ("split", l1_closure)):
                plan = kk.describe_prox(prox, "adaprox", True)
                args = (A0, S0, M_.to(mdt), V_.to(mdt), Y, al_)
                got = k2(*args, sc_, W=W, prox_S=plan)
                again = k2(*args, sc_, W=W, prox_S=plan)
                on_card = k2(*args, dsc, W=W, prox_S=plan)
                ref = kk.fused_nmf_adaprox_step_reference(*args, sc_, W=W,
                                                          prox_S=plan)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"K2 {p_label} [{tag}, {m_label}]: two launches "
                      "differ")
                check(all(torch.equal(a, b) for a, b in zip(got, on_card)),
                      f"K2 {p_label} [{tag}, {m_label}]: the device-scalar "
                      "entry differs from the by-value one")
                if mdt == bf:
                    for i in (2, 3):
                        ok, ulps, _ = bf16_within(got[i], ref[i])
                        check(ok, f"K2 {p_label} [{tag}, {m_label}]: "
                              f"moment {i} {ulps:g} ulps")
                    got = tuple(g for i, g in enumerate(got)
                                if i not in (2, 3))
                    ref = tuple(r for i, r in enumerate(ref)
                                if i not in (2, 3))
                results["K2", p_label, label, m_label] = compare_outputs(
                    f"K2 very wide {p_label} vs plain [{tag}, W, {m_label}; "
                    "the device-scalar entry bitwise equal]", got, ref,
                    6 if mdt == torch.float32 else 4)
                del got, again, on_card, ref
        for w_label, Wx in (("", None), (", W", W)):
            got = tops.fused_nmf_grad(A0, S0, Y, W=Wx)
            again = tops.fused_nmf_grad(A0, S0, Y, W=Wx)
            ref = tops.fused_nmf_grad_reference(A0, S0, Y, W=Wx)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K3 very wide [{tag}{w_label}]: two launches differ")
            errs = [rel_err(g, r) for g, r in zip(got, ref)]
            check(max(errs) <= STEP_RTOL, f"K3 very wide [{tag}{w_label}]: "
                  f"rel errs {errs}")
            results["K3", label, w_label] = float(
                (got[1] - ref[1]).abs().max())
            log(f"K3 very wide vs plain [{tag}{w_label}]: max rel err (gA, "
                "gS, Gram, loss) " + ", ".join(f"{e:.2e}" for e in errs)
                + f" (tol {STEP_RTOL:g}); two launches bitwise equal")
            del got, again, ref

        # times, beside the plain version and the bound
        M0 = torch.zeros_like(S0)
        out = k1(A0, S0, Y, sS, prox_S=simplex)
        timing(f"K1 chain [{label}]",
               lambda: k1(A0, S0, Y, sS, prox_S=simplex),
               lambda: kk.fused_nmf_pgm_step_reference(A0, S0, Y, sS,
                                                       prox_S=simplex),
               tensor_bytes(A0, S0, Y) + tensor_bytes(*out),
               wide_ops(C_, K_, N_))
        X, gA_, st_ = kk._pgm_pass1_cuda(A0, S0, Y, sS, None, tile)
        P_ = simplex(X, sS)
        timing(f"K1 split pass 1 [{label}]",
               lambda: kk._pgm_pass1_cuda(A0, S0, Y, sS, None, tile),
               lambda: kk._pgm_pass1_reference(A0, S0, Y, sS),
               tensor_bytes(A0, S0, Y, X, gA_, st_[:1]),
               wide_ops(C_, K_, N_, gram=False))
        timing(f"K1 split pass 2 [{label}]",
               lambda: kk._pgm_pass2_cuda(S0, P_, tile),
               lambda: kk._pgm_pass2_reference(S0, P_, torch.float32),
               tensor_bytes(S0, P_) + 4 * (K_ * K_ + 2), pgm_ops(0, K_, N_))
        out = k2(A0, S0, M0, M0, Y, al_, sc_, prox_S=l1)
        timing(f"K2 chain [{label}]",
               lambda: k2(A0, S0, M0, M0, Y, al_, sc_, prox_S=l1),
               lambda: kk.fused_nmf_adaprox_step_reference(
                   A0, S0, M0, M0, Y, al_, sc_, prox_S=l1),
               tensor_bytes(A0, S0, M0, M0, Y, al_) + tensor_bytes(*out),
               adaprox_ops(C_, K_, N_))
        pre = kk._adaprox_pass1_cuda(A0, S0, M0, M0, Y, al_, sc_, None,
                                     0.999, 1e-8, tile)
        P2 = l1_closure(pre[0], pre[1])
        timing(f"K2 split pass 1 [{label}]",
               lambda: kk._adaprox_pass1_cuda(A0, S0, M0, M0, Y, al_, sc_,
                                              None, 0.999, 1e-8, tile),
               lambda: kk._adaprox_pass1_reference(A0, S0, M0, M0, Y, al_,
                                                   sc_),
               tensor_bytes(A0, S0, M0, M0, Y, al_)
               + tensor_bytes(*pre[:5]) + 4, adaprox_ops(C_, K_, N_))
        timing(f"K2 split pass 2 [{label}]",
               lambda: kk._adaprox_pass2_cuda(S0, P2, tile),
               lambda: kk._adaprox_pass2_reference(S0, P2, torch.float32),
               tensor_bytes(S0, P2) + 4 * (K_ + 2), 4 * N_ * K_)
        out = tops.fused_nmf_grad(A0, S0, Y)
        timing(f"K3 [{label}]", lambda: tops.fused_nmf_grad(A0, S0, Y),
               lambda: tops.fused_nmf_grad_reference(A0, S0, Y),
               tensor_bytes(A0, S0, Y) + tensor_bytes(*out),
               wide_ops(C_, K_, N_))
        del X, P_, P2, pre, out, M_, V_, M0
        # Context, not a yardstick: the step's four float32 products as four
        # cuBLAS calls (TF32 off), which move R and D through memory
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            D_ = A0 @ S0 - Y
            p_ms = {k: min(cuda_ms(f, reps=5) for _ in range(2))
                    for k, f in (("A@S", lambda: A0 @ S0),
                                 ("A.T@D", lambda: A0.T @ D_),
                                 ("D@S.T", lambda: D_ @ S0.T),
                                 ("S@S.T", lambda: S0 @ S0.T))}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del D_
        log(f"very wide context [four float32 cuBLAS calls, TF32 off, {tag}"
            f"; not a single-call yardstick] on {card}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in p_ms.items())
            + f"; sum {sum(p_ms.values()):.4f} ms against K1's one pass "
            f"{times[f'K1 chain [{label}]'][0]:.4f} ms")

    # K5 beyond C, K <= 8: K2's wide body on the packed arrays' row blocks
    for layout in ("smv", "mv"):
        args, kw, _, results["K5", layout] = compare_packed(
            sm, kk, layout, *VWIDE_PACKED)
        got = sm.packed_step(*args, **kw)
        C_, K_, N_ = VWIDE_PACKED
        timing(f"K5 {layout}", lambda: sm.packed_step(*args, **kw),
               lambda: sm.packed_step_reference(*args, **kw),
               tensor_bytes(*args[:4], *kw.values()) + tensor_bytes(*got),
               adaprox_ops(C_, K_, N_))
        del args, kw, got

    # the main path: the solves, engine="cuda" against engine="torch"
    ada = dict(algorithm="adaprox")
    paths = (
        ("exact PGM", dict(prox_S=simplex), {}),
        ("weighted PGM stride 10", dict(prox_S=simplex, step_stride=STRIDE,
                                        weighted=True), {}),
        ("AdaProx", dict(prox_S=l1, **ada), dict(separable_prox="auto")),
    )
    reset_counts(counted)
    reset_routes(counted)
    sm.packed_step.launches = 0
    for r in sm.packed_step.route_launches:
        sm.packed_step.route_launches[r] = 0
    solves = {}
    launched = {}

    def count(label, kname, ran):
        for r, n in ran.items():
            launched[label, kname, r] = launched.get((label, kname, r), 0) + n

    for label, (Y, A0, S0, W) in problems.items():
        C_, K_, N_ = Y.shape[0], A0.shape[1], Y.shape[1]
        tag = f"{label}, C={C_} K={K_} N={N_}"
        loss0 = {"w": wloss(A0, S0, Y, W), "u": wloss(A0, S0, Y)}
        for p_label, kw, torch_kw in paths:
            kw = dict(kw)
            Wx = W if kw.pop("weighted", False) else None
            if Wx is not None:
                kw["W"] = Wx
            kname = ("fused_nmf_adaprox_step" if "algorithm" in kw
                     else "fused_nmf_pgm_step")
            before = route_counts(counted)
            r_c = tnmf.nmf(Y, A0, S0, prox_A=top.prox_plus, e_rel=0,
                           max_iter=VWIDE_ITERS, engine="cuda", **kw)
            torch.cuda.synchronize()
            after = route_counts(counted)
            ran = {r: after[kname][r] - before[kname][r]
                   for r in after[kname]}
            check(ran["very wide"] == VWIDE_ITERS == r_c.iterations
                  and sum(ran.values()) == VWIDE_ITERS,
                  f"very wide {p_label} [{tag}]: routes {ran} in "
                  f"{r_c.iterations} iterations")
            r_t = tnmf.nmf(Y, A0, S0, prox_A=top.prox_plus, e_rel=0,
                           max_iter=VWIDE_ITERS, engine="torch", **kw,
                           **torch_kw)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(a).all())
                      for a in (*r_c.x, *r_t.x))
                  and tuple(r_c.x[1].shape) == (K_, N_),
                  f"very wide {p_label} [{tag}]: non-finite iterate or "
                  "wrong shape")
            n_A, n_S = (norm_err(r_c.x[i], r_t.x[i]) for i in (0, 1))
            check(n_A <= ENGINE_RTOL and n_S <= ENGINE_RTOL,
                  f"very wide {p_label} [{tag}]: engines disagree after "
                  f"{VWIDE_ITERS} iterations: normwise A {n_A:.2e}, S "
                  f"{n_S:.2e}")
            l0 = loss0["u" if Wx is None else "w"]
            l_c, l_t = wloss(*r_c.x, Y, Wx), wloss(*r_t.x, Y, Wx)
            check(np.isfinite([l_c, l_t]).all() and l_c < l0 and l_t < l0,
                  f"very wide {p_label} [{tag}]: loss did not decrease")
            half = tnmf.nmf(Y, A0, S0, prox_A=top.prox_plus, e_rel=0,
                            max_iter=VWIDE_SPLIT, engine="cuda", **kw)
            rest = tnmf.nmf(Y, *half.x, prox_A=top.prox_plus, e_rel=0,
                            max_iter=VWIDE_ITERS - VWIDE_SPLIT,
                            engine="cuda", state=half.state, **kw)
            check(torch.equal(rest.x[0], r_c.x[0])
                  and torch.equal(rest.x[1], r_c.x[1]),
                  f"very wide {p_label} [{tag}]: {VWIDE_SPLIT} + "
                  f"{VWIDE_ITERS - VWIDE_SPLIT} resumed differs from "
                  f"{VWIDE_ITERS} straight")
            extra = ""
            if "algorithm" not in kw:
                colsum = float((r_c.x[1].sum(0) - 1).abs().max())
                check(colsum <= UNITY_SUM_ATOL
                      and bool((r_c.x[1] >= 0).all()),
                      f"very wide {p_label} [{tag}]: columns of S sum to 1 "
                      f"within {colsum:.2e}")
                extra = f"; columns of S sum to 1 within {colsum:.2e}"
            solves[label, p_label] = r_c
            count(label, kname, {r: after[kname][r] - before[kname][r]
                                 for r in after[kname]})
            log(f"very wide {p_label} [{tag}]: nmf engine=cuda vs "
                f"engine=torch, {VWIDE_ITERS} iterations at e_rel=0: "
                f"normwise rel err A {n_A:.2e}, S {n_S:.2e} (tol "
                f"{ENGINE_RTOL:g}); loss {l0:.6e} -> cuda {l_c:.6e}, torch "
                f"{l_t:.6e}; {VWIDE_SPLIT} + {VWIDE_ITERS - VWIDE_SPLIT} "
                f"resumed equal {VWIDE_ITERS} straight bit for bit; "
                f"launches {ran}{extra}")
        # the split path, the prox as a closure: K1, K2, and K3 as pgm's
        # gradient
        for p_label, kw in (("exact PGM", dict(prox_S=simplex_closure)),
                            ("AdaProx", dict(prox_S=l1_closure,
                                             separable_prox=True, **ada))):
            kname = ("fused_nmf_adaprox_step" if "algorithm" in kw
                     else "fused_nmf_pgm_step")
            before = route_counts(counted)
            r_s = tnmf.nmf(Y, A0, S0, prox_A=top.prox_plus, e_rel=0,
                           max_iter=VWIDE_SPLIT, engine="cuda", **kw)
            torch.cuda.synchronize()
            after = route_counts(counted)
            ran = {r: after[kname][r] - before[kname][r]
                   for r in after[kname]}
            count(label, kname, ran)
            check(ran["split pass 1"] == ran["split pass 2"] == VWIDE_SPLIT
                  and sum(ran.values()) == 2 * VWIDE_SPLIT,
                  f"very wide {p_label} split path [{tag}]: routes {ran}")
            r_ref = tnmf.nmf(Y, A0, S0, prox_A=top.prox_plus, e_rel=0,
                             max_iter=VWIDE_SPLIT, engine="cuda",
                             **dict(kw, prox_S=simplex if "algorithm"
                                    not in kw else l1))
            n_A, n_S = (norm_err(r_s.x[i], r_ref.x[i]) for i in (0, 1))
            check(n_A <= ENGINE_RTOL and n_S <= ENGINE_RTOL,
                  f"very wide {p_label} [{tag}]: split path and compiled "
                  f"chain disagree: normwise A {n_A:.2e}, S {n_S:.2e}")
            log(f"very wide {p_label}, prox_S as a closure (split path) vs "
                f"the compiled chain, {VWIDE_SPLIT} iterations [{tag}]: "
                f"normwise rel err A {n_A:.2e}, S {n_S:.2e} (tol "
                f"{ENGINE_RTOL:g}); launches {ran}")
        before = k3.route_launches["very wide"]
        rg = algorithms.pgm(
            [A0, S0], lambda A_, S_, Y=Y: tops.fused_nmf_grad(A_, S_, Y)[:2],
            tnmf.step_pgm, prox=[top.prox_plus, simplex_closure], e_rel=0,
            max_iter=VWIDE_SPLIT)
        torch.cuda.synchronize()
        n3 = k3.route_launches["very wide"] - before
        count(label, "fused_nmf_grad", {"very wide": n3})
        l_g = wloss(*rg.x, Y)
        check(n3 == rg.iterations + 1 and l_g < loss0["u"]
              and all(bool(torch.isfinite(x).all()) for x in rg.x),
              f"very wide K3 path [{tag}]: {n3} launches in "
              f"{rg.iterations} iterations, loss {l_g:.6e}")
        log(f"very wide ops path [K3 gradient, {tag}]: pgm(grad="
            f"fused_nmf_grad) with the simplex as a closure, {rg.iterations}"
            f" iterations: loss {loss0['u']:.6e} -> {l_g:.6e}; K3 very wide "
            f"launches {n3} = iterations + the final gradient")
    # K5's own loop beyond C, K <= 8
    C_, K_, N_ = VWIDE_PACKED
    A5, S5, M5, V5, Y5, al5, _, _ = adaprox_inputs(C_, K_, N_, False,
                                                   torch.float32)
    _, packed_smv, packed_mv = sm.build_loops()
    packed_smv(A5, torch.cat([S5, M5, V5]), Y5, al5, 5)
    packed_mv(A5, S5, torch.cat([M5, V5]).to(bf), Y5, al5, 5)
    torch.cuda.synchronize()
    check(sm.packed_step.route_launches["wide"] == 10,
          f"K5 loops at {VWIDE_PACKED}: routes {sm.packed_step.route_launches}")
    count("K5", "packed_step", sm.packed_step.route_launches)
    # the main path ends here: what follows routes and times
    del A5, S5, M5, V5, Y5

    # auto on the very-wide shapes: the engine the table's rows name
    prev = calibrate.set_auto_calibration("off")
    try:
        for label, problem in problems.items():
            shape = (problem[0].shape[0], problem[1].shape[1],
                     problem[0].shape[1])
            for path in ("pgm-exact", "adaprox-f32"):
                wins = (tnmf._adaprox_fused_wins if path == "adaprox-f32"
                        else tnmf._unweighted_fused_wins)
                expected = "cuda" if wins(*shape) else "torch"
                reset_counts(counted)
                res = route_solver(tnmf, top, problem, path, "auto")(
                    ROUTE_VWIDE_ITERS)
                n_k = k1.launches + k2.launches
                ref = route_solver(tnmf, top, problem, path, expected)(
                    ROUTE_VWIDE_ITERS)
                check(same_solve(res, ref) and (
                    n_k >= ROUTE_VWIDE_ITERS if expected == "cuda"
                    else n_k == 0),
                    f"routing very wide [{path} {shape}]: the table says "
                    f"{expected}; auto's solve differs or launched K1/K2 "
                    f"{n_k} times")
                log(f"routing very wide [{label}, {path} {shape}]: table "
                    f"{expected}, auto ran {expected}, equal to it bit for "
                    f"bit over {ROUTE_VWIDE_ITERS} iterations, K1/K2 "
                    f"launches {n_k}; on {card}")
    finally:
        calibrate.set_auto_calibration(prev)

    # marginal ms/iter (host clock), the engines in turns
    for label, shape in VWIDE_LABELS[:2]:
        Y, A0, S0, W = problems[label]
        for p_label, kw, torch_kw in (paths[0], paths[2]):
            ms = {e: [] for e in ("cuda", "torch")}
            fns = {e: (lambda n, e=e: tnmf.nmf(
                Y, A0, S0, prox_A=top.prox_plus, e_rel=0, max_iter=n,
                engine=e, **kw, **(torch_kw if e == "torch" else {})))
                for e in ms}
            for e in ms:
                timed(fns[e], 2)
            for e in ("cuda", "torch", "torch", "cuda"):
                ms[e].append(marginal_ms(fns[e], VWIDE_LO, VWIDE_HI))
            log(f"very wide {p_label} [{label}, C={shape[0]} K={shape[1]} "
                f"N={shape[2]}]: marginal ms/iter cuda "
                f"{min(ms['cuda']):.4f} ({ms['cuda'][0]:.4f}, "
                f"{ms['cuda'][1]:.4f}), torch {min(ms['torch']):.4f} "
                f"({ms['torch'][0]:.4f}, {ms['torch'][1]:.4f}); order cuda, "
                f"torch, torch, cuda ({VWIDE_LO}->{VWIDE_HI} iterations, "
                f"host clock); on {card}")
    del problems, Y, A0, S0, W, solves
    torch.cuda.empty_cache()
    return times, results, launched


# The examples (phase 19): every module of proxmin_tpu_torch.examples at its
# default arguments, each in a process of its own, EX_PARALLEL at once, the
# longest first. Each must exit 0 and print its success lines (substring,
# least count), as tests/test_examples.py asserts them of the JAX scripts;
# fused_adam_unmixing must launch K2 at least once in each of its cuda
# segments' EX_K2_ITERS iterations.
EX_PARALLEL = 4
EX_K2_ITERS = 300
EX_SUCCESS = {
    "unmixing": (("match = 0.9", 3),),
    "astro_unmixing": (("weighted (W = 1/sky)", 1), ("weighted loss", 5)),
    "pod_serving": (("bit-exact vs live", 1),),
    "preemptible_resume": (
        ("preempted trajectory == uninterrupted trajectory", 1),),
    "learn_regularizer": (("learned wins", 1),),
    "sharded_unmixing": (("all three paths agree", 1),),
    "parabola": (("SDMM", 1), ("FISTA", 1)),
    "batched_solves": (("4096 solves in one call", 1),
                       ("match individual solves", 1)),
    "fused_adam_unmixing": (("fused adam", 1), ("continued", 1)),
    "tv_denoise": (("RMSE", 1),),
    "image_tv": (("RMSE", 1),),
}
EXAMPLE_SCRIPT = r"""
import importlib
import json
import sys
import time
import chip_smoke as cs
name, cpu = sys.argv[1], "--cpu" in sys.argv
wrappers = cs.kernel_wrappers()
module = importlib.import_module("proxmin_tpu_torch.examples." + name)
cs.reset_counts(wrappers.values())
t0 = time.perf_counter()
result = module.main(cpu=cpu)
seconds = time.perf_counter() - t0
print(json.dumps({"name": name, "seconds": seconds, "launches": {
    k: w.launches for k, w in wrappers.items()}, "result": result},
    default=float))
"""


def kernel_wrappers():
    """Every kernel's wrapper by the name the phases give it."""
    from proxmin_tpu_torch import ops as tops
    from proxmin_tpu_torch.ops import nmf_kernels as kk
    from proxmin_tpu_torch.ops import stream_merge as sm

    return {"K1": kk.fused_nmf_pgm_step, "K2": kk.fused_nmf_adaprox_step,
            "K3": tops.fused_nmf_grad,
            **{f"K4 {op}": prox_pair(tops, op)[0]
               for op in ("plus", "soft", "hard", "unity")},
            "K5": sm.packed_step}


def examples_phase(card):
    """Phase 19: the eleven examples of ``proxmin_tpu_torch.examples`` on the
    card at their default arguments, each in a process of its own
    (EXAMPLE_SCRIPT: ``main()``, with every kernel wrapper's count set to 0
    just before and read just after), EX_PARALLEL at once. The sharded
    three run a one-rank NCCL group in their own process (one card), so
    their counts are theirs too. Fails unless each exits 0 and prints its
    success lines (EX_SUCCESS), and unless fused_adam_unmixing launched K2
    at least once per iteration of its cuda segments; a failing check stops
    every example still running. Returns ``{example: {kernel:
    launches}}``."""
    todo = list(EX_SUCCESS)
    cpu = ["--cpu"] if DEVICE.type == "cpu" else []
    if not cpu:
        # the card's memory this process cached in the earlier phases
        torch.cuda.empty_cache()
    running, done = {}, {}
    t_phase = time.perf_counter()
    try:
        while todo or running:
            while todo and len(running) < EX_PARALLEL:
                name = todo.pop(0)
                out = tempfile.TemporaryFile("w+")
                err = tempfile.TemporaryFile("w+")
                running[name] = (subprocess.Popen(
                    [sys.executable, "-c", EXAMPLE_SCRIPT, name, *cpu],
                    stdout=out, stderr=err, text=True), out, err,
                    time.perf_counter())
            time.sleep(0.1)
            for name, (proc, out, err, t0) in list(running.items()):
                if proc.poll() is None:
                    check(time.perf_counter() - t0 <= 900,
                          f"examples: {name} ran past 900 s")
                    continue
                del running[name]
                out.seek(0)
                err.seek(0)
                text, errors = out.read(), err.read()
                out.close()
                err.close()
                check(proc.returncode == 0,
                      f"examples: {name} exited {proc.returncode}: "
                      f"{errors[-3000:]}")
                lines = text.strip().splitlines()
                info = json.loads(lines[-1])
                shown = "\n".join(lines[:-1])
                for line, least in EX_SUCCESS[name]:
                    check(shown.count(line) >= least,
                          f"examples: {name} printed {line!r} "
                          f"{shown.count(line)} times (at least {least}): "
                          f"{shown[-2000:]}")
                done[name] = info
                launched = {k: v for k, v in info["launches"].items() if v}
                log(f"examples: {name}: exit 0 and its success lines in "
                    f"{info['seconds']:.2f} s of main() "
                    f"({time.perf_counter() - t0:.2f} s of its process); "
                    f"kernel launches {launched or 'none'}; on {card}")
    finally:
        for proc, *_ in running.values():
            proc.kill()
            proc.wait()
    k2 = done["fused_adam_unmixing"]["launches"]["K2"]
    check(k2 >= EX_K2_ITERS,
          f"examples: fused_adam_unmixing launched K2 {k2} times in its "
          f"{EX_K2_ITERS} cuda iterations: it ran another engine")
    log(f"examples: the eleven examples ran {EX_PARALLEL} at once in "
        f"{time.perf_counter() - t_phase:.1f} s; fused_adam_unmixing "
        f"launched K2 {k2} times in {EX_K2_ITERS} iterations of "
        f"engine='cuda'; on {card}")
    return {name: info["launches"] for name, info in done.items()}


def example_k2_check(card):
    """K2 at fused_adam_unmixing's own operands: the example's ``main()``
    (N = 20 000, bfloat16 moments) in this process, with the wrapper that
    ``nmf`` calls wrapped to keep a copy of each call's operands; then K2
    on the first and the last call of the first solve and on the first of
    the continuation (warm-started from the returned M and V), each against
    its plain version on the same tensors (``hold_adaprox_step``). Returns
    ``(S' max abs err, kernel ms, plain ms, bound)``, timed at the
    warm-started call, for the kernels line."""
    import contextlib
    import io

    from proxmin_tpu_torch import nmf as tnmf
    from proxmin_tpu_torch.examples import fused_adam_unmixing as ex
    from proxmin_tpu_torch.ops import nmf_kernels as kk

    real, calls = tnmf.fused_nmf_adaprox_step, []

    def keep(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def recording(*args, **kw):
        calls.append((tuple(map(keep, args)),
                      {k: keep(v) for k, v in kw.items()}))
        return real(*args, **kw)

    tnmf.fused_nmf_adaprox_step = recording
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            result = ex.main()
    finally:
        tnmf.fused_nmf_adaprox_step = real
    n1 = result["fused_iters"]
    check(len(calls) == EX_K2_ITERS and n1 == EX_K2_ITERS // 2,
          f"examples: fused_adam_unmixing called K2 {len(calls)} times, "
          f"its first solve {n1}, in this process")
    check(bool(calls[n1][0][2].float().abs().max() > 0),
          "examples: fused_adam_unmixing's continuation started K2 from "
          "zero moments, not from the returned M and V")
    errs = []
    for at, what in ((0, "first call"), (n1 - 1, "last call"),
                     (n1, "warm-started call")):
        args, kw = calls[at]
        check(args[2].dtype == torch.bfloat16,
              f"examples: K2's moments are {args[2].dtype}")
        errs.append(hold_adaprox_step(
            kk, f"fused_adam_unmixing, {what}, bf16 moments", args, kw))
    args, kw = calls[n1]
    del calls
    C_, K_ = args[0].shape
    N_ = args[1].shape[1]
    k_ms = min(cuda_ms(lambda: kk.fused_nmf_adaprox_step(*args, **kw))
               for _ in range(2))
    p_ms = min(cuda_ms(lambda: kk.fused_nmf_adaprox_step_reference(
        *args, **{k: v for k, v in kw.items() if k != "tile_n"}))
        for _ in range(2))
    moved = tensor_bytes(*args[:5]) + tensor_bytes(
        *kk.fused_nmf_adaprox_step(*args, **kw))
    bound = bound_of(moved, adaprox_ops(C_, K_, N_))
    log(f"K2 time [fused_adam_unmixing, C={C_} K={K_} N={N_}, bf16 "
        f"moments, warm-started call] on {card}: kernel {k_ms:.4f} ms "
        f"({moved / k_ms / 1e6:.0f} GB/s of {moved / 1e6:.2f} MB), plain "
        f"version {p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return max(errs), k_ms, p_ms, bound


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has nothing to run without one", file=sys.stderr)
        return 2
    # the solvers warn at every max_iter stop, which every run here is
    logging.getLogger("proxmin").setLevel(logging.ERROR)
    from proxmin_tpu_torch import algorithms, linop
    from proxmin_tpu_torch import nmf as tnmf
    from proxmin_tpu_torch import operators as top
    from proxmin_tpu_torch import ops as tops
    from proxmin_tpu_torch.ops import _build as kb
    from proxmin_tpu_torch.ops import nmf_kernels as kk
    from proxmin_tpu_torch.ops import stream_merge as sm

    wrappers = kernel_wrappers()
    k1_fn, k2_fn, k3_fn, k5_fn = (wrappers[k] for k in ("K1", "K2", "K3",
                                                         "K5"))
    k4_fns = {op: wrappers[f"K4 {op}"] for op in
              ("plus", "soft", "hard", "unity")}
    every_kernel = tuple(wrappers.values())

    # 1. probe
    global T0
    T0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    nvcc = subprocess.run([kb._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    nvcc_line = next((ln for ln in nvcc.splitlines() if "release" in ln),
                     nvcc.strip().splitlines()[-1])
    log(f"probe: torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, device {name}, count "
        f"{torch.cuda.device_count()}")
    log(f"probe: nvidia-smi {card}")
    log(f"probe: nvcc {nvcc_line.strip()}")

    # 2. build every kernel source of the checkout, one nvcc each, at once
    log(f"phase 2 starts at {time.perf_counter() - T0:.0f} s")
    t0 = time.perf_counter()
    built = kb.build_kernels()
    check(set(built) == {"nmf_pgm_step", "nmf_pgm_wide", "nmf_adaprox_step",
                         "nmf_adaprox_wide", "nmf_adaprox_kwide",
                         "nmf_adaprox_vwide", "nmf_grad", "prox_elementwise"},
          f"built {sorted(built)}")
    root = kb._BUILD_DIR.parents[1]
    for kname, (path, seconds, build_log) in built.items():
        kb._library(kname)
        log(f"build: {kb._SOURCES[kname].relative_to(root)} -> "
            f"{path.relative_to(root)} "
            + (f"compiled in {seconds:.1f} s" if seconds else
               "already built"))
        for ln in ptxas_summary(build_log):
            log(f"build: ptxas {ln}")
        spilled = [n for n, _, spill in ptxas_instances(build_log)
                   if n.startswith(RING_KERNELS) and spill]
        check(not spilled, f"ptxas: spill stores in {spilled}")
    log(f"build: all {len(built)} kernel libraries ready in "
        f"{time.perf_counter() - t0:.1f} s")
    if sys.argv[1:] == ["--profile"]:
        profile_paths(tnmf, algorithms, linop, top, tops, card)
        log(card)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    # 3. K1 against its plain version
    log(f"phase 3 starts at {time.perf_counter() - T0:.0f} s")
    (Y, A0, S0, sS), k1_abs = compare_step(kk, "flagship", C, K, N, False)
    compare_step(kk, "flagship+W", C, K, N, True)
    compare_step(kk, "ragged", 8, 4, N + 37, False)
    compare_step(kk, "C <= 16 instance, W", 16, 8, N_WIDE, True)
    k1_ms = min(cuda_ms(lambda: kk.fused_nmf_pgm_step(A0, S0, Y, sS))
                for _ in range(2))
    k1_plain = min(cuda_ms(lambda: kk.fused_nmf_pgm_step_reference(
        A0, S0, Y, sS)) for _ in range(2))
    naive = (C + 2 * K) * N * 4
    log(f"K1 time [flagship] on {card}: kernel {k1_ms:.4f} ms "
        f"({naive / k1_ms / 1e6:.0f} GB/s of {naive / 1e6:.0f} MB naive), "
        f"plain version {k1_plain:.4f} ms")
    k1_bound = bound_of(tensor_bytes(A0, S0, Y) + tensor_bytes(
        *kk.fused_nmf_pgm_step(A0, S0, Y, sS)), pgm_ops(C, K, N))
    # K1's bfloat16 store, and K1 with W in either store, as the weighted
    # path runs it
    k1b_args, k1b_abs = compare_step_bf16(kk, "flagship", C, K, N, False)
    k1bw_args, k1bw_abs = compare_step_bf16(kk, "flagship+W", C, K, N,
                                            True)
    compare_step_bf16(kk, "ragged", 8, 4, N + 37, False)
    compare_step_bf16(kk, "C <= 16 instance, W", 16, 8, N_WIDE, True)
    k1_times = {}
    for label, (A_, S_, Y_, s_, W_) in (
            ("f32 store, W", (A0, S0, Y, sS, make_problem(C, K, N, True)[3])),
            ("bf16 store", k1b_args), ("bf16 store, W", k1bw_args)):
        out = kk.fused_nmf_pgm_step(A_, S_, Y_, s_, W=W_)
        moved = tensor_bytes(A_, S_, Y_, W_) + tensor_bytes(*out)
        k_ms = min(cuda_ms(lambda: kk.fused_nmf_pgm_step(A_, S_, Y_, s_,
                                                         W=W_))
                   for _ in range(2))
        p_ms = min(cuda_ms(lambda: kk.fused_nmf_pgm_step_reference(
            A_, S_, Y_, s_, W=W_)) for _ in range(2))
        k1_times[label] = (k_ms, p_ms, bound_of(moved, pgm_ops(C, K, N)))
        log(f"K1 time [flagship, {label}] on {card}: kernel {k_ms:.4f} ms "
            f"({moved / k_ms / 1e6:.0f} GB/s of {moved / 1e6:.0f} MB), "
            f"plain version {p_ms:.4f} ms; f32 store {k1_ms:.4f} ms")

    # 4. K2 against its plain version
    log(f"phase 4 starts at {time.perf_counter() - T0:.0f} s")
    k2_args, k2_abs = compare_adaprox_step(kk, "flagship", C, K, N)
    k2b_args, _ = compare_adaprox_step(kk, "flagship bf16 moments", C, K, N,
                                       mdt=torch.bfloat16)
    compare_adaprox_step(kk, "flagship+W", C, K, N, weighted=True)
    compare_adaprox_step(kk, "ragged", 8, 4, N + 37)
    compare_adaprox_step(kk, "prox id", C, K, N, prox_S=top.prox_id)
    k2_times = {}
    for label, args, nbytes in (
            ("f32 moments", k2_args, (C + 6 * K) * N * 4),
            ("bf16 moments", k2b_args, (C + 2 * K) * N * 4 + 4 * K * N * 2)):
        k_ms = min(cuda_ms(lambda: kk.fused_nmf_adaprox_step(*args))
                   for _ in range(2))
        p_ms = min(cuda_ms(lambda: kk.fused_nmf_adaprox_step_reference(
            *args)) for _ in range(2))
        k2_times[label] = (k_ms, p_ms)
        log(f"K2 time [flagship, {label}] on {card}: kernel {k_ms:.4f} ms "
            f"({nbytes / k_ms / 1e6:.0f} GB/s of {nbytes / 1e6:.0f} MB "
            f"naive), plain version {p_ms:.4f} ms")
    k2_bound = bound_of(tensor_bytes(*k2_args[:5]) + tensor_bytes(
        *kk.fused_nmf_adaprox_step(*k2_args)), adaprox_ops(C, K, N))
    # K2's device-scalar entry (the exported programs' route): bit for bit
    # its by-value entry on the same scalars, against the plain version,
    # timed beside it
    k2d_abs = {}
    for m_label, args in (("f32 moments", k2_args), ("bf16 moments",
                                                     k2b_args)):
        sc_dev = torch.tensor([float(v) for v in args[6]],
                              dtype=torch.float32, device=DEVICE)
        dev_args = args[:6] + (sc_dev,)
        got = kk.fused_nmf_adaprox_step(*dev_args)
        want = kk.fused_nmf_adaprox_step(*args)
        ref = kk.fused_nmf_adaprox_step_reference(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"K2 device scalars [{m_label}]: differs from the by-value "
              "entry on the same scalars")
        k2d_abs[m_label] = float((got[1] - ref[1]).abs().max())
        if m_label == "f32 moments":
            k2d_args = dev_args
    k2d_ms = min(cuda_ms(lambda: kk.fused_nmf_adaprox_step(*k2d_args))
                 for _ in range(2))
    log(f"K2 device scalars [flagship]: bit for bit the by-value entry "
        f"(f32 and bf16 moments); S_new max abs err against the plain "
        f"version {k2d_abs['f32 moments']:.3e}; kernel {k2d_ms:.4f} ms, "
        f"by value {k2_times['f32 moments'][0]:.4f} ms; on {card}")
    # K2's bfloat16 store (S, Y, W), with both moment types, timed beside
    # the float32 store
    k2s_args, k2s_abs, k2s_times = {}, {}, {}
    for m_label, mdt in (("bf16 moments", torch.bfloat16),
                         ("f32 moments", torch.float32)):
        k2s_args[m_label], k2s_abs[m_label] = compare_adaprox_bf16(
            kk, f"flagship, {m_label}", C, K, N, mdt=mdt)
        compare_adaprox_bf16(kk, f"flagship+W, {m_label}", C, K, N,
                             weighted=True, mdt=mdt)
        compare_adaprox_bf16(kk, f"ragged, {m_label}", 8, 4, N + 37, mdt=mdt)
    for m_label, args in k2s_args.items():
        moved = tensor_bytes(*args[:5]) + tensor_bytes(
            *kk.fused_nmf_adaprox_step(*args))
        k_ms = min(cuda_ms(lambda: kk.fused_nmf_adaprox_step(*args))
                   for _ in range(2))
        p_ms = min(cuda_ms(lambda: kk.fused_nmf_adaprox_step_reference(
            *args)) for _ in range(2))
        k2s_times[m_label] = (k_ms, p_ms,
                              bound_of(moved, adaprox_ops(C, K, N)))
        f_ms = k2_times[m_label][0]
        f_bytes = (tensor_bytes(*(k2_args if m_label == "f32 moments"
                                  else k2b_args)[:5]) + tensor_bytes(
            *kk.fused_nmf_adaprox_step(*(k2_args if m_label == "f32 moments"
                                         else k2b_args))))
        log(f"K2 time [flagship, bf16 store, {m_label}] on {card}: kernel "
            f"{k_ms:.4f} ms ({moved / k_ms / 1e6:.0f} GB/s of "
            f"{moved / 1e6:.0f} MB), plain version {p_ms:.4f} ms; f32 store "
            f"{f_ms:.4f} ms ({f_bytes / f_ms / 1e6:.0f} GB/s of "
            f"{f_bytes / 1e6:.0f} MB)")

    # K5 against its plain version and K2; its time beside K2's on the same
    # inputs, in turns (K2, K5, K5, K2)
    k5_times, k5_abs = {}, {}
    for layout in ("smv", "mv"):
        args, kw, unpacked, k5_abs[layout] = compare_packed(sm, kk, layout,
                                                             C, K, N)
        moved = tensor_bytes(*args[:4], *kw.values()) + tensor_bytes(
            *sm.packed_step(*args, **kw))

        def k5_call():
            return sm.packed_step(*args, **kw)

        def k2_call():
            return kk.fused_nmf_adaprox_step(*unpacked)

        t_k2a, t_k5a, t_k5b, t_k2b = (min(cuda_ms(f) for _ in range(2))
                                      for f in (k2_call, k5_call, k5_call,
                                                k2_call))
        p_ms = min(cuda_ms(lambda: sm.packed_step_reference(*args, **kw))
                   for _ in range(2))
        k5_ms, k2_ms_ = min(t_k5a, t_k5b), min(t_k2a, t_k2b)
        k5_times[layout] = (k5_ms, p_ms, bound_of(moved, adaprox_ops(C, K, N)))
        log(f"K5 time [flagship, {layout}] on {card}: kernel {k5_ms:.4f} ms "
            f"({t_k5a:.4f}, {t_k5b:.4f}; {moved / k5_ms / 1e6:.0f} GB/s of "
            f"{moved / 1e6:.0f} MB), K2 on the same inputs {k2_ms_:.4f} ms "
            f"({t_k2a:.4f}, {t_k2b:.4f}; {moved / k2_ms_ / 1e6:.0f} GB/s), "
            f"plain version {p_ms:.4f} ms; order K2, K5, K5, K2")

    # the stream-merge loops: K5's own path, launch-counted, packed equal
    # to base bit for bit
    base, packed_smv, packed_mv = sm.build_loops()
    A_, S_, M_, V_, Y_, al_, _, _ = adaprox_inputs(C, K, N, False,
                                                   torch.float32)
    Mb_, Vb_ = M_.to(torch.bfloat16), V_.to(torch.bfloat16)
    SMV_, MV_ = torch.cat([S_, M_, V_]), torch.cat([Mb_, Vb_])
    reset_counts(every_kernel)
    SMV_n = packed_smv(A_, SMV_, Y_, al_, ITERS)
    k5_launches = {"smv": k5_fn.launches}
    S_mv, MV_n = packed_mv(A_, S_, MV_, Y_, al_, ITERS)
    torch.cuda.synchronize()
    k5_launches["mv"] = k5_fn.launches - k5_launches["smv"]
    counts = {f.__name__: f.launches for f in every_kernel}
    check(k5_launches == {"smv": ITERS, "mv": ITERS}
          and sum(counts.values()) == 2 * ITERS,
          f"stream-merge loops: launches {counts} for 2 x {ITERS} "
          "iterations")
    S_b, M_b, V_b = base(A_, S_, M_, V_, Y_, al_, ITERS)
    S_bb, M_bb, V_bb = base(A_, S_, Mb_, Vb_, Y_, al_, ITERS)
    torch.cuda.synchronize()
    check(torch.equal(SMV_n, torch.cat([S_b, M_b, V_b]))
          and torch.equal(S_mv, S_bb)
          and torch.equal(MV_n, torch.cat([M_bb, V_bb]))
          and bool(torch.isfinite(SMV_n).all()),
          "stream-merge loops: packed and base differ after "
          f"{ITERS} iterations")
    log(f"K5 path [stream-merge loops]: packed_f32_smv and packed_bf16m_mv "
        f"{ITERS} iterations each, K5 launches {k5_launches}, no other "
        "kernel; each equals its base loop (K2) bit for bit")
    loop_variants = (
        ("base_f32", lambda n: base(A_, S_, M_, V_, Y_, al_, n),
         (C + 6 * K) * N * 4),
        ("packed_f32_smv", lambda n: packed_smv(A_, SMV_, Y_, al_, n),
         (C + 6 * K) * N * 4),
        ("base_bf16m", lambda n: base(A_, S_, Mb_, Vb_, Y_, al_, n),
         (C + 2 * K) * N * 4 + 4 * K * N * 2),
        ("packed_bf16m_mv", lambda n: packed_mv(A_, S_, MV_, Y_, al_, n),
         (C + 2 * K) * N * 4 + 4 * K * N * 2),
    )

    # 5. K3 against its plain version
    log(f"phase 5 starts at {time.perf_counter() - T0:.0f} s")
    k3_args, k3_abs = compare_grad(tops, "flagship", C, K, N, False)
    k3w_args, _ = compare_grad(tops, "flagship+W", C, K, N, True)
    compare_grad(tops, "ragged", 8, 4, N + 37, False)
    compare_grad(tops, "C <= 16 instance, W", 16, 8, N_WIDE, True)
    k3_times = {}
    for label, (A_, S_, Y_, W_), nbytes in (
            ("unweighted", k3_args, naive),
            ("with W", k3w_args, naive + C * N * 4)):
        k_ms = min(cuda_ms(lambda: tops.fused_nmf_grad(A_, S_, Y_, W=W_))
                   for _ in range(2))
        p_ms = min(cuda_ms(lambda: tops.fused_nmf_grad_reference(
            A_, S_, Y_, W=W_)) for _ in range(2))
        k3_times[label] = (k_ms, p_ms, bound_of(
            tensor_bytes(A_, S_, Y_, W_)
            + tensor_bytes(*tops.fused_nmf_grad(A_, S_, Y_, W=W_)),
            pgm_ops(C, K, N)))
        log(f"K3 time [flagship, {label}] on {card}: kernel {k_ms:.4f} ms "
            f"({nbytes / k_ms / 1e6:.0f} GB/s of {nbytes / 1e6:.0f} MB "
            f"naive), plain version {p_ms:.4f} ms")

    # 6. K4 against its plain versions, on S's shape and on odd shapes, with
    log(f"phase 6 starts at {time.perf_counter() - T0:.0f} s")
    # the step on the card as the solvers pass it
    step = torch.tensor(0.37, device=DEVICE)
    rng = np.random.default_rng(SEED + 2)
    X32 = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
                           ).to(DEVICE)
    k4_abs = {}
    for dt in (torch.float32, torch.float64):
        errs = compare_prox(tops, f"{K}x{N} {str(dt)[6:]}", X32.to(dt), step)
        if dt == torch.float32:
            k4_abs = errs
        log(f"K4 vs plain [{K}x{N} {str(dt)[6:]}, step on the card]: max "
            "abs err " + ", ".join(f"{c} {e:.2e}" for c, e in errs.items())
            + f" (plus/soft/hard bitwise, unity rel "
            f"{UNITY_RTOL[dt]:g}); two launches bitwise equal")
    for shape in ODD_SHAPES:
        for dt in (torch.float32, torch.float64):
            Xo = torch.from_numpy(rng.standard_normal(shape)).to(DEVICE, dt)
            compare_prox(tops, f"{shape} {str(dt)[6:]}", Xo, step)
    log(f"K4 vs plain at {', '.join(map(str, ODD_SHAPES))} in float32 and "
        "float64: every case within its tolerance")
    check_prox_nan(tops, X32, step)
    log("K4: NaN propagates as in the plain versions (a NaN column or row "
        "through unity)")
    P32 = X32.abs() + 0.1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for case, op, kw in PROX_CASES:
            prox_pair(tops, op)[0](P32, step, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("K4: every case ran under torch.cuda.set_sync_debug_mode('error') "
        "with the step on the card (no host sync)")
    k4_times = {}
    for dt in (torch.float32, torch.float64):
        Xd = X32.to(dt)
        Pd = Xd.abs() + 0.1
        nbytes = 2 * Xd.numel() * Xd.element_size()
        for case, op, kw in PROX_CASES:
            if "absolute" in case:
                continue
            kernel, plain = prox_pair(tops, op)
            Z = Pd if op == "unity" else Xd
            k_ms = min(cuda_ms(lambda: kernel(Z, step, **kw))
                       for _ in range(2))
            p_ms = min(cuda_ms(lambda: plain(Z, step, **kw))
                       for _ in range(2))
            lib = library_prox(op, Z, step, kw)
            l_ms = (None if lib is None else
                    min(cuda_ms(lib) for _ in range(2)))
            k4_times[case, dt] = (k_ms, p_ms, bound_of(nbytes, Z.numel()),
                                  l_ms)
            log(f"K4 time [{case}, {K}x{N} {str(dt)[6:]}] on {card}: "
                f"kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.0f} GB/s of "
                f"{nbytes / 1e6:.0f} MB), plain version {p_ms:.4f} ms, "
                + ("no library call computes it" if l_ms is None else
                   f"library call {l_ms:.4f} ms"))

    # one CUDA kernel per K4 call (for unity along axis 1 too: the chunk
    # sums and the divide in one launch), by the profiler, with the step on
    # the card; and each
    # wrapper's host cost per call
    from pathlib import Path
    prof_dir = Path(__file__).resolve().parent / "build" / "profile"
    prof_dir.mkdir(parents=True, exist_ok=True)
    k4_kernels, k4_host = {}, {}
    for dt in (torch.float32, torch.float64):
        Xd = X32.to(dt)
        Pd = Xd.abs() + 0.1
        for case, op, kw in PROX_CASES:
            kernel = prox_pair(tops, op)[0]
            Z = Pd if op == "unity" else Xd
            names = kernels_of(lambda: kernel(Z, step, **kw),
                               prof_dir / "k4_call.json")
            check(len(names) == 1, f"K4 {case} {str(dt)[6:]}: "
                  f"{len(names)} CUDA kernels in one call ({names})")
            k4_kernels[case, dt] = len(names)
            if dt == torch.float32:
                k4_host[case] = host_us(lambda: kernel(Z, step, **kw))
    log("K4 CUDA kernels per call (torch.profiler, step on the card, float32 "
        "and float64): " + ", ".join(
            f"{case} {k4_kernels[case, torch.float32]}"
            for case, _, _ in PROX_CASES))
    log(f"K4 host us per call (1000 calls, stream held by a sleep kernel) on "
        f"{card}: " + ", ".join(f"{c} {v:.2f}" for c, v in k4_host.items()))

    # 7. the PGM main path
    log(f"phase 7 starts at {time.perf_counter() - T0:.0f} s")
    reset_counts(every_kernel)
    res_c = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=ITERS, engine="cuda")
    torch.cuda.synchronize()
    k1_launches = k1_fn.launches
    res_t = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=ITERS, engine="torch")
    torch.cuda.synchronize()
    check(res_c.iterations == ITERS and res_t.iterations == ITERS,
          f"iterations {res_c.iterations}, {res_t.iterations}")
    check(k1_launches == res_c.iterations,
          f"K1 launched {k1_launches} times in {res_c.iterations} "
          "iterations")
    for a in (*res_c.x, *res_t.x):
        check(bool(torch.isfinite(a).all()), "non-finite iterate")
    check(tuple(res_c.x[0].shape) == (C, K)
          and tuple(res_c.x[1].shape) == (K, N), "iterate shapes")
    e_A = rel_err(res_c.x[0], res_t.x[0])
    e_S = rel_err(res_c.x[1], res_t.x[1])
    check(e_A <= ENGINE_RTOL and e_S <= ENGINE_RTOL,
          f"engines disagree after {ITERS} iterations: A {e_A:.2e}, "
          f"S {e_S:.2e} > {ENGINE_RTOL:g}")
    loss0 = float(tnmf.log_likelihood(A0, S0, Y=Y))
    loss_c = float(tnmf.log_likelihood(*res_c.x, Y=Y))
    loss_t = float(tnmf.log_likelihood(*res_t.x, Y=Y))
    check(np.isfinite([loss0, loss_c, loss_t]).all()
          and loss_c < loss0 and loss_t < loss0, "loss did not decrease")
    log(f"PGM main path: nmf engine=cuda vs engine=torch, {ITERS} "
        f"iterations at e_rel=0: A rel err {e_A:.2e}, S rel err {e_S:.2e} "
        f"(tol {ENGINE_RTOL:g}); loss {loss0:.6e} -> cuda {loss_c:.6e}, "
        f"torch {loss_t:.6e}; K1 launches {k1_launches} = iterations "
        f"{res_c.iterations}")
    # the same 200 iterations as four resumed segments: bit for bit, and the
    # loss decreases from segment to segment
    A, S, state, losses = A0, S0, None, []
    for _ in range(4):
        seg = tnmf.nmf(Y, A, S, e_rel=0, max_iter=ITERS // 4,
                       engine="cuda", state=state)
        A, S, state = seg.x[0], seg.x[1], seg.state
        losses.append(seg.loss)
    check(all(np.isfinite(losses)) and all(
        b < a for a, b in zip(losses, losses[1:])),
        f"segment losses not decreasing: {losses}")
    check(torch.equal(A, res_c.x[0]) and torch.equal(S, res_c.x[1]),
          "4 x 50 resumed iterations differ from 200 straight ones")
    log(f"PGM main path: 4 x {ITERS // 4} resumed cuda iterations equal "
        f"{ITERS} straight ones bit for bit; segment losses "
        + ", ".join(f"{v:.6e}" for v in losses))

    # the weighted and strided PGM paths: bench.py's weighted flagship (W
    # in [0.5, 1.5)) with step_stride=10, fixed and adaptive, and the
    # unweighted adaptive solve, each on both engines
    Ww = make_problem(C, K, N, True)[3]
    lw0 = wloss(A0, S0, Y, Ww)
    strided_paths = (
        ("weighted stride 10", dict(W=Ww, step_stride=STRIDE), Ww),
        ("weighted adaptive", dict(W=Ww, step_stride=STRIDE,
                                   step_adapt=True), Ww),
        ("unweighted adaptive", dict(step_adapt=True), None),
    )
    strided_c = {}
    for label, kw, W_ in strided_paths:
        reset_counts(every_kernel)
        r_c = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=ITERS, engine="cuda",
                       **kw)
        torch.cuda.synchronize()
        counts = {f.__name__: f.launches for f in every_kernel}
        r_t = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=ITERS, engine="torch",
                       **kw)
        torch.cuda.synchronize()
        check(r_c.iterations == ITERS == r_t.iterations,
              f"{label}: iterations {r_c.iterations}, {r_t.iterations}")
        check(k1_fn.launches == ITERS
              and sum(counts.values()) == k1_fn.launches,
              f"{label}: launches {counts} in {ITERS} iterations")
        for a in (*r_c.x, *r_t.x):
            check(bool(torch.isfinite(a).all()), f"{label}: non-finite "
                  "iterate")
        n_A, n_S = (norm_err(r_c.x[i], r_t.x[i]) for i in (0, 1))
        check(n_A <= ENGINE_RTOL and n_S <= ENGINE_RTOL,
              f"{label}: engines disagree after {ITERS} iterations: "
              f"normwise A {n_A:.2e}, S {n_S:.2e} > {ENGINE_RTOL:g}")
        l0_, l_c, l_t = (wloss(A0, S0, Y, W_), wloss(*r_c.x, Y, W_),
                         wloss(*r_t.x, Y, W_))
        check(np.isfinite([l_c, l_t]).all() and l_c < l0_ and l_t < l0_,
              f"{label}: loss did not decrease")
        steps = r_c.state["steps"]
        strided_c[label] = r_c
        log(f"PGM {label}: nmf engine=cuda vs engine=torch, {ITERS} "
            f"iterations at e_rel=0: normwise rel err A {n_A:.2e}, S "
            f"{n_S:.2e} (tol {ENGINE_RTOL:g}); loss {l0_:.6e} -> cuda "
            f"{l_c:.6e}, torch {l_t:.6e}; K1 launches {k1_fn.launches} = "
            f"iterations, no other kernel; final stride {steps[3]}, next "
            f"refresh at {steps[4]}")
    # the bfloat16 store on the weighted adaptive path
    label, kw, _ = strided_paths[1]
    reset_counts(every_kernel)
    r16 = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=ITERS, engine="cuda",
                   store_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    k1b_launches = k1_fn.launches
    check(r16.iterations == ITERS == k1b_launches
          and r16.state["store_dtype"] == "bfloat16"
          and r16.x[1].dtype == torch.float32,
          f"bf16 store: {r16.iterations} iterations, {k1b_launches} K1 "
          "launches")
    l16, l32 = wloss(*r16.x, Y, Ww), wloss(*strided_c[label].x, Y, Ww)
    check(np.isfinite(l16) and l16 < max(3 * l32, l32 + 1.0),
          f"bf16 store: loss {l16:.6e} against float32 {l32:.6e}")
    log(f"PGM {label}, bfloat16 store: loss {lw0:.6e} -> {l16:.6e} against "
        f"float32 {l32:.6e} (rule l16 < max(3 l32, l32 + 1)); K1 launches "
        f"{k1b_launches} = iterations")
    # a weighted adaptive cuda solve as 4 x 50 resumed iterations, and split
    # exactly on a refresh boundary (iteration 10 with stride 10)
    for splits in ((ITERS // 4,) * 4, (STRIDE, ITERS - STRIDE)):
        A, S, state = A0, S0, None
        for n in splits:
            seg = tnmf.nmf(Y, A, S, e_rel=0, max_iter=n, engine="cuda",
                           state=state, **kw)
            A, S, state = seg.x[0], seg.x[1], seg.state
        straight = strided_c[label]
        check(torch.equal(A, straight.x[0]) and torch.equal(S, straight.x[1])
              and state["steps"][3:] == straight.state["steps"][3:],
              f"{label}: resumed as {splits} differs from {ITERS} straight")
    log(f"PGM {label}: resumed as 4 x {ITERS // 4} and as {STRIDE} + "
        f"{ITERS - STRIDE} (a refresh boundary) equal {ITERS} straight "
        "iterations bit for bit")

    # 8. the AdaProx main path
    log(f"phase 8 starts at {time.perf_counter() - T0:.0f} s")
    ada = dict(algorithm="adaprox", e_rel=0)
    reset_counts(every_kernel)
    ada_c = tnmf.nmf(Y, A0, S0, max_iter=ITERS, engine="cuda", **ada)
    torch.cuda.synchronize()
    k2_launches = k2_fn.launches
    check(ada_c.iterations == ITERS
          and k2_launches == ada_c.iterations,
          f"K2 launched {k2_launches} times in {ada_c.iterations} "
          "iterations")
    errs = {}
    for n in (50, ADAPROX_AT, ITERS):
        r_c = (ada_c if n == ITERS else
               tnmf.nmf(Y, A0, S0, max_iter=n, engine="cuda", **ada))
        r_t = tnmf.nmf(Y, A0, S0, max_iter=n, engine="torch",
                       separable_prox="auto", **ada)
        check(r_c.iterations == n and r_t.iterations == n,
              f"adaprox iterations {r_c.iterations}, {r_t.iterations}")
        for a in (*r_c.x, *r_t.x):
            check(bool(torch.isfinite(a).all()), "non-finite iterate")
        errs[n] = (rel_err(r_c.x[0], r_t.x[0]), rel_err(r_c.x[1], r_t.x[1]))
    ada_t = r_t
    log("AdaProx main path: nmf(algorithm='adaprox') engine=cuda vs "
        "engine=torch separable_prox='auto', e_rel=0, rel err (A, S) "
        + "; ".join(f"{n} it: {a:.2e}, {b:.2e}" for n, (a, b) in
                    errs.items()) + f" (tol {ENGINE_RTOL:g} at "
        f"{ADAPROX_AT}, {ADAPROX_RTOL_200:g} at {ITERS})")
    check(max(errs[ADAPROX_AT]) <= ENGINE_RTOL,
          f"adaprox engines disagree after {ADAPROX_AT} iterations: "
          f"{errs[ADAPROX_AT]} > {ENGINE_RTOL:g}")
    check(max(errs[ITERS]) <= ADAPROX_RTOL_200,
          f"adaprox engines disagree after {ITERS} iterations: "
          f"{errs[ITERS]} > {ADAPROX_RTOL_200:g}")
    check(tuple(ada_c.x[1].shape) == (K, N), "adaprox iterate shape")
    la_c = float(tnmf.log_likelihood(*ada_c.x, Y=Y))
    la_t = float(tnmf.log_likelihood(*ada_t.x, Y=Y))
    check(np.isfinite([la_c, la_t]).all() and la_c < loss0 and la_t < loss0,
          "adaprox loss did not decrease")
    ada_b = tnmf.nmf(Y, A0, S0, max_iter=ITERS, engine="cuda",
                     moment_dtype=torch.bfloat16, **ada)
    check(ada_b.state["M"][1].dtype == torch.bfloat16
          and ada_b.x[1].dtype == torch.float32, "bf16 moment dtypes")
    bf_err = float((ada_b.x[1] - ada_c.x[1]).abs().max())
    check(bf_err <= BF16_ATOL,
          f"bf16 moments: S differs from f32 by {bf_err:.3e}")
    log(f"AdaProx main path: loss {loss0:.6e} -> cuda {la_c:.6e}, torch "
        f"{la_t:.6e}; K2 launches {k2_launches} = iterations "
        f"{ada_c.iterations}; bf16 moments vs f32 after {ITERS} "
        f"iterations: S max abs diff {bf_err:.3e} (atol {BF16_ATOL:g})")
    A, S, state, losses = A0, S0, None, []
    for _ in range(4):
        seg = tnmf.nmf(Y, A, S, max_iter=ITERS // 4, engine="cuda",
                       state=state, **ada)
        A, S, state = seg.x[0], seg.x[1], seg.state
        losses.append(seg.loss)
    check(all(np.isfinite(losses)), f"segment losses {losses}")
    check(torch.equal(A, ada_c.x[0]) and torch.equal(S, ada_c.x[1]),
          "4 x 50 resumed adaprox iterations differ from 200 straight ones")
    log(f"AdaProx main path: 4 x {ITERS // 4} resumed cuda iterations "
        f"equal {ITERS} straight ones bit for bit; segment losses "
        + ", ".join(f"{v:.6e}" for v in losses))
    # K2's bfloat16 store on the AdaProx path, unweighted and weighted, with
    # float32 and bfloat16 moments, each beside the float32 store run in the
    # same 4 x 50 segments: one K2 launch per iteration, the resumed
    # segments equal 200 straight iterations bit for bit, the loss rule at
    # BF16_RULE_AT iterations and, at 200, a loss below its own at
    # BF16_RULE_AT (see BF16_RULE_AT)
    k2s_launches = None
    for m_label, mdt in (("f32 moments", None), ("bf16 moments",
                                                  torch.bfloat16)):
        for w_label, W_ in (("unweighted", None), ("weighted", Ww)):
            kw = dict(ada, engine="cuda", moment_dtype=mdt,
                      **({} if W_ is None else {"W": W_}))
            reset_counts(every_kernel)
            r16 = tnmf.nmf(Y, A0, S0, max_iter=ITERS,
                           store_dtype=torch.bfloat16, **kw)
            torch.cuda.synchronize()
            counts = {f.__name__: f.launches for f in every_kernel}
            check(r16.iterations == ITERS == k2_fn.launches
                  and sum(counts.values()) == ITERS
                  and r16.state["fused_config"]["store_dtype"] == "bfloat16"
                  and r16.x[1].dtype == torch.float32,
                  f"AdaProx bf16 store [{w_label}, {m_label}]: "
                  f"{r16.iterations} iterations, launches {counts}")
            if (mdt, W_) == (torch.bfloat16, None):
                k2s_launches = k2_fn.launches
            seg_loss = {}
            for sdt in (None, torch.bfloat16):
                A, S, state = A0, S0, None
                for i in range(4):
                    seg = tnmf.nmf(Y, A, S, max_iter=ITERS // 4, state=state,
                                   store_dtype=sdt, **kw)
                    A, S, state = seg.x[0], seg.x[1], seg.state
                    seg_loss[sdt, (i + 1) * ITERS // 4] = wloss(A, S, Y, W_)
            check(torch.equal(A, r16.x[0]) and torch.equal(S, r16.x[1]),
                  f"AdaProx bf16 store [{w_label}, {m_label}]: 4 x "
                  f"{ITERS // 4} resumed iterations differ from {ITERS} "
                  "straight ones")
            l16, l32 = (seg_loss[d, BF16_RULE_AT] for d in (torch.bfloat16,
                                                            None))
            l16_end = seg_loss[torch.bfloat16, ITERS]
            check(np.isfinite(l16) and l16 < max(3 * l32, l32 + 1.0),
                  f"AdaProx bf16 store [{w_label}, {m_label}]: loss "
                  f"{l16:.6e} against float32 {l32:.6e} at {BF16_RULE_AT} "
                  "iterations")
            check(np.isfinite(l16_end) and l16_end < l16,
                  f"AdaProx bf16 store [{w_label}, {m_label}]: loss "
                  f"{l16_end:.6e} at {ITERS} iterations, {l16:.6e} at "
                  f"{BF16_RULE_AT}")
            log(f"AdaProx bf16 store [{w_label}, {m_label}]: loss "
                f"{wloss(A0, S0, Y, W_):.6e} -> " + ", ".join(
                    f"{n} it {seg_loss[torch.bfloat16, n]:.6e} (float32 "
                    f"store {seg_loss[None, n]:.6e}, ratio "
                    f"{seg_loss[torch.bfloat16, n] / seg_loss[None, n]:.3f})"
                    for n in range(ITERS // 4, ITERS + 1, ITERS // 4))
                + f"; rule l16 < max(3 l32, l32 + 1) at {BF16_RULE_AT}; K2 "
                f"launches {counts['fused_nmf_adaprox_step']} = iterations; "
                f"4 x {ITERS // 4} resumed equal {ITERS} straight bit for "
                "bit")
    # the default adaprox: torch engine with the prox sub-iterations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ada_d = tnmf.nmf(Y, A0, S0, algorithm="adaprox", max_iter=10)
    torch.cuda.synchronize()
    d_ms = (time.perf_counter() - t0) / max(ada_d.iterations, 1) * 1e3
    for a in ada_d.x:
        check(bool(torch.isfinite(a).all()), "non-finite iterate")
    log(f"AdaProx default (engine=torch, prox sub-iterations, e_rel=1e-3): "
        f"{ada_d.iterations} iterations, sub-iterations "
        f"{ada_d.sub_iterations}, {d_ms:.3f} ms/iter (one run, host clock) "
        f"on {card}")

    # 9. the ops paths: K4 inside AlternatingProjections as nmf's S
    log(f"phase 9 starts at {time.perf_counter() - T0:.0f} s")
    # constraint, and K3 as pgm's gradient, each against its plain twin
    AP = top.AlternatingProjections
    prox_paths = (
        ("sum-to-one", AP([tops.prox_unity_pallas, tops.prox_plus_pallas]),
         top.prox_unity_plus, ("unity", "plus")),
        ("sparse L1", AP([tops.prox_plus_pallas, partial(
            tops.prox_soft_pallas, thresh=L1_THRESH)]),
         partial(top.prox_soft_plus, thresh=L1_THRESH), ("plus", "soft")),
        ("sparse L0", AP([tops.prox_plus_pallas, partial(
            tops.prox_hard_pallas, thresh=L0_THRESH)]),
         partial(top.prox_hard_plus, thresh=L0_THRESH), ("plus", "hard")),
    )
    k4_launches = dict.fromkeys(k4_fns, 0)
    for label, prox, twin, ops in prox_paths:
        reset_counts(every_kernel)
        r = tnmf.nmf(Y, A0, S0, prox_S=prox, e_rel=0, max_iter=ITERS)
        torch.cuda.synchronize()
        counts = {f: f.launches for f in every_kernel}
        check(r.iterations == ITERS, f"{label}: {r.iterations} iterations")
        for op in ops:
            check(counts[k4_fns[op]] == r.iterations,
                  f"{label}: K4 {op} launched {counts[k4_fns[op]]} times in "
                  f"{r.iterations} iterations")
            k4_launches[op] += counts[k4_fns[op]]
        check(sum(counts.values()) == len(ops) * r.iterations,
              f"{label}: other kernels launched: {counts}")
        rp = tnmf.nmf(Y, A0, S0, prox_S=twin, e_rel=0, max_iter=ITERS)
        torch.cuda.synchronize()
        for a in (*r.x, *rp.x):
            check(bool(torch.isfinite(a).all()), f"{label}: non-finite "
                  "iterate")
        check(tuple(r.x[1].shape) == (K, N), f"{label}: S shape")
        e_A, e_S = rel_err(r.x[0], rp.x[0]), rel_err(r.x[1], rp.x[1])
        n_A, n_S = norm_err(r.x[0], rp.x[0]), norm_err(r.x[1], rp.x[1])
        bound = UNITY_PATH_MAXABS if label == "sum-to-one" else ENGINE_RTOL
        check(n_A <= ENGINE_RTOL and n_S <= ENGINE_RTOL,
              f"{label}: K4 and plain operators disagree after {ITERS} "
              f"iterations: normwise A {n_A:.2e}, S {n_S:.2e} > "
              f"{ENGINE_RTOL:g}")
        check(e_A <= bound and e_S <= bound,
              f"{label}: K4 and plain operators disagree after {ITERS} "
              f"iterations: elementwise A {e_A:.2e}, S {e_S:.2e} > "
              f"{bound:g}")
        S_ = r.x[1]
        if label == "sum-to-one":
            dev1 = float((S_.sum(0) - 1).abs().max())
            check(dev1 <= UNITY_SUM_ATOL and bool((S_ >= 0).all()),
                  f"{label}: columns of S sum to 1 within {dev1:.2e}, or S "
                  "has a negative element")
            what = f"columns of S sum to 1 within {dev1:.2e}"
        else:
            zero = float((S_ == 0).float().mean())
            check(0.0 < zero < 1.0, f"{label}: zero fraction {zero}")
            what = f"zero fraction of S {zero:.4f}"
        loss_r = float(tnmf.log_likelihood(*r.x, Y=Y))
        log(f"ops path [{label}]: nmf(prox_S=AlternatingProjections(K4 "
            f"{' + '.join(ops[::-1])})) vs the plain operators, {ITERS} "
            f"iterations at e_rel=0: normwise rel err A {n_A:.2e}, S "
            f"{n_S:.2e} (tol {ENGINE_RTOL:g}); elementwise A {e_A:.2e}, S "
            f"{e_S:.2e} (tol {bound:g}); {what}; loss {loss_r:.6e}; "
            + ", ".join(f"K4 {op} launches {counts[k4_fns[op]]}"
                        for op in ops) + f" = iterations {r.iterations}")

    def pgm_k3(n):
        return algorithms.pgm(
            [A0, S0], lambda A_, S_: tops.fused_nmf_grad(A_, S_, Y)[:2],
            tnmf.step_pgm, prox=[top.prox_plus] * 2, e_rel=0, max_iter=n)

    reset_counts(every_kernel)
    rg = pgm_k3(ITERS)
    torch.cuda.synchronize()
    k3_launches = k3_fn.launches
    # once per iteration, and once for the final gradient pgm reports
    check(rg.iterations == ITERS and k3_launches == rg.iterations + 1,
          f"K3 launched {k3_launches} times in {rg.iterations} iterations")
    for a in rg.x:
        check(bool(torch.isfinite(a).all()), "K3 path: non-finite iterate")
    e_A, e_S = rel_err(rg.x[0], res_t.x[0]), rel_err(rg.x[1], res_t.x[1])
    check(e_A <= ENGINE_RTOL and e_S <= ENGINE_RTOL,
          f"K3 path and nmf(engine='torch') disagree after {ITERS} "
          f"iterations: A {e_A:.2e}, S {e_S:.2e} > {ENGINE_RTOL:g}")
    loss_g = float(tnmf.log_likelihood(*rg.x, Y=Y))
    check(np.isfinite(loss_g) and loss_g < loss0, "K3 path: loss did not "
          "decrease")
    log(f"ops path [K3 gradient]: pgm(grad=fused_nmf_grad) vs nmf(engine="
        f"'torch'), {ITERS} iterations at e_rel=0: A rel err {e_A:.2e}, S "
        f"rel err {e_S:.2e} (tol {ENGINE_RTOL:g}); loss {loss0:.6e} -> "
        f"{loss_g:.6e}; K3 launches {k3_launches} = iterations "
        f"{rg.iterations} + the final gradient")

    # 10. marginal time per iteration
    log(f"phase 10 starts at {time.perf_counter() - T0:.0f} s")
    def run(n, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    variants = (
        ("pgm engine=torch", dict(engine="torch"), naive),
        ("pgm engine=cuda", dict(engine="cuda"), naive),
        ("adaprox engine=torch separable", dict(
            engine="torch", algorithm="adaprox", separable_prox="auto"),
         (C + 6 * K) * N * 4),
        ("adaprox engine=cuda f32 moments", dict(
            engine="cuda", algorithm="adaprox"), (C + 6 * K) * N * 4),
        ("adaprox engine=cuda bf16 moments", dict(
            engine="cuda", algorithm="adaprox",
            moment_dtype=torch.bfloat16), (C + 2 * K) * N * 4 + 4 * K * N * 2),
        # bench.py's bench_tpu_weighted and bench_tpu_unweighted_strided
        # variants on this card
        ("pgm weighted engine=torch stride 10", dict(
            engine="torch", W=Ww, step_stride=STRIDE),
         (2 * C + 2 * K) * N * 4),
        ("pgm weighted engine=torch adaptive", dict(
            engine="torch", W=Ww, step_stride=STRIDE, step_adapt=True),
         (2 * C + 2 * K) * N * 4),
        ("pgm weighted engine=cuda stride 10", dict(
            engine="cuda", W=Ww, step_stride=STRIDE), (2 * C + 2 * K) * N * 4),
        ("pgm weighted engine=cuda adaptive", dict(
            engine="cuda", W=Ww, step_stride=STRIDE, step_adapt=True),
         (2 * C + 2 * K) * N * 4),
        ("pgm weighted engine=cuda adaptive bf16 store", dict(
            engine="cuda", W=Ww, step_stride=STRIDE, step_adapt=True,
            store_dtype=torch.bfloat16), (2 * C + 2 * K) * N * 2),
        ("pgm unweighted engine=torch adaptive", dict(
            engine="torch", step_adapt=True), naive),
        ("pgm unweighted engine=cuda adaptive", dict(
            engine="cuda", step_adapt=True), naive),
    )
    for _, kw, _ in variants:
        run(5, **kw)
    for label, kw, nbytes in variants:
        t_lo = min(run(LO, **kw) for _ in range(2))
        t_hi = min(run(HI, **kw) for _ in range(2))
        ms = (t_hi - t_lo) / (HI - LO) * 1e3
        log(f"{label}: {ms:.4f} ms/iter marginal ({LO}->{HI} iterations), "
            f"{nbytes / ms / 1e6:.1f} GB/s of {nbytes / 1e6:.0f} MB naive "
            f"per iteration, on {card}")

    marginal = partial(marginal_ms, lo=LO, hi=HI)

    def solve(prox_S):
        return lambda n: tnmf.nmf(Y, A0, S0, prox_S=prox_S, e_rel=0,
                                  max_iter=n)

    path_pairs = [(label, solve(prox), solve(twin))
                  for label, prox, twin, _ in prox_paths]
    path_pairs.append(("K3 gradient", pgm_k3, lambda n: tnmf.nmf(
        Y, A0, S0, e_rel=0, max_iter=n)))
    for _, fn, twin in path_pairs:
        timed(fn, 5)
        timed(twin, 5)
    for label, fn, twin in path_pairs:
        ms_t, ms_k, ms_k2, ms_t2 = (marginal(f) for f in (twin, fn, fn, twin))
        log(f"ops path [{label}]: {min(ms_k, ms_k2):.4f} ms/iter marginal "
            f"with the kernels ({ms_k:.4f}, {ms_k2:.4f}), plain twin "
            f"{min(ms_t, ms_t2):.4f} ({ms_t:.4f}, {ms_t2:.4f}); runs in the "
            f"order twin, kernels, kernels, twin; on {card}")
    # the adaptive refresh against the exact steps on one engine, in turns
    # (exact, adaptive, adaptive, exact): what taking the eigensolves off
    # most iterations buys end to end
    for engine in ("cuda", "torch"):
        def exact(n, e=engine):
            return tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n, engine=e)

        def adaptive(n, e=engine):
            return tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n, engine=e,
                            step_adapt=True)

        ms_e, ms_a, ms_a2, ms_e2 = (marginal(f) for f in (exact, adaptive,
                                                          adaptive, exact))
        log(f"pgm engine={engine}: adaptive refresh {min(ms_a, ms_a2):.4f} "
            f"ms/iter marginal ({ms_a:.4f}, {ms_a2:.4f}), exact steps "
            f"{min(ms_e, ms_e2):.4f} ({ms_e:.4f}, {ms_e2:.4f}); order exact, "
            f"adaptive, adaptive, exact; on {card}")
    # the AdaProx cuda path with the bfloat16 store against the float32
    # store, bfloat16 moments on both, in turns (f32, bf16, bf16, f32)
    def adaprox_store(sdt):
        return lambda n: tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n,
                                  algorithm="adaprox", engine="cuda",
                                  moment_dtype=torch.bfloat16,
                                  store_dtype=sdt)

    f32_store, bf16_store = adaprox_store(None), adaprox_store(torch.bfloat16)
    timed(f32_store, 5)
    timed(bf16_store, 5)
    ms_f, ms_b, ms_b2, ms_f2 = (marginal(f) for f in (f32_store, bf16_store,
                                                      bf16_store, f32_store))
    nb16 = (C + 2 * K) * N * 2 + 4 * K * N * 2
    log(f"adaprox engine=cuda bf16 store, bf16 moments: "
        f"{min(ms_b, ms_b2):.4f} ms/iter marginal ({ms_b:.4f}, {ms_b2:.4f}; "
        f"{nb16 / min(ms_b, ms_b2) / 1e6:.1f} GB/s of {nb16 / 1e6:.0f} MB "
        f"naive), f32 store {min(ms_f, ms_f2):.4f} ({ms_f:.4f}, "
        f"{ms_f2:.4f}); order f32, bf16, bf16, f32; on {card}")
    # the stream-merge loops, each packed loop beside its base loop in
    # turns (base, packed, packed, base)
    for (b_label, b_fn, nb), (p_label, p_fn, _) in (loop_variants[:2],
                                                     loop_variants[2:]):
        timed(b_fn, 5)
        timed(p_fn, 5)
        ms_b, ms_p, ms_p2, ms_b2 = (marginal(f)
                                    for f in (b_fn, p_fn, p_fn, b_fn))
        log(f"stream-merge loops: {p_label} {min(ms_p, ms_p2):.4f} ms/iter "
            f"marginal ({ms_p:.4f}, {ms_p2:.4f}; "
            f"{nb / min(ms_p, ms_p2) / 1e6:.0f} GB/s of {nb / 1e6:.0f} MB), "
            f"{b_label} {min(ms_b, ms_b2):.4f} ({ms_b:.4f}, {ms_b2:.4f}; "
            f"{nb / min(ms_b, ms_b2) / 1e6:.0f} GB/s); order base, packed, "
            f"packed, base; on {card}")

    # 11. the ADMM family
    log(f"phase 11 starts at {time.perf_counter() - T0:.0f} s")
    k4_launches["soft"] += admm_family_phase(
        (algorithms, linop, tnmf, top, tops), (Y, A0, S0, Ww), loss_t, card,
        every_kernel, k4_fns["soft"])

    # 12. the solvers' options and the checkpoint
    log(f"phase 12 starts at {time.perf_counter() - T0:.0f} s")
    ck_launches = driver_options_phase(
        (algorithms, linop, tnmf, top, tops), (Y, A0, S0, Ww), card,
        every_kernel, (k1_fn, k2_fn, k4_fns["soft"]), prof_dir)
    k1_launches += ck_launches["K1"]
    k1b_launches += ck_launches["K1 bf16 store"]
    k2s_launches += ck_launches["K2 bf16 store"]
    k4_launches["soft"] += ck_launches["K4 soft"]

    # 13. the functional factories
    log(f"phase 13 starts at {time.perf_counter() - T0:.0f} s")
    fn_launches = functional_phase(
        (algorithms, linop, tnmf, top, tops), (Y, A0, S0, Ww), card,
        every_kernel, (k3_fn, k4_fns["soft"]))
    k3_launches += fn_launches["K3"]
    k4_launches["soft"] += fn_launches["K4 soft"]

    # 14. whole solves exported with torch.export
    log(f"phase 14 starts at {time.perf_counter() - T0:.0f} s")
    ex_launches = export_phase(
        (algorithms, linop, tnmf, top, tops), (Y, A0, S0, Ww), card,
        every_kernel, (k1_fn, k2_fn, k3_fn, k4_fns["soft"]), prof_dir)
    k1_launches += ex_launches["K1"]
    k1b_launches += ex_launches["K1 bf16 store"]
    k2d_launches = ex_launches["K2 device scalars"]
    k3_launches += ex_launches["K3"]
    k4_launches["soft"] += ex_launches["K4 soft"]

    # 15. the full-width path: C=128, K=32 and the prox modes
    log(f"phase 15 starts at {time.perf_counter() - T0:.0f} s")
    w_times, w_err, w_routes = wide_phase(
        (algorithms, tnmf, top, tops, kk), card, prof_dir)

    # 16. the sharded path on a one-rank NCCL group
    log(f"phase 16 starts at {time.perf_counter() - T0:.0f} s")
    from proxmin_tpu_torch import checkpoint, parallel

    sharded_phase((tnmf, parallel, checkpoint), (Y, A0, S0, Ww), card)

    # 17. nmf(engine="auto"): the H100 routing table, calibration, the
    # engine-equivalence check
    log(f"phase 17 starts at {time.perf_counter() - T0:.0f} s")
    from proxmin_tpu_torch import calibrate

    rt_launches = routing_phase((tnmf, top, kk, calibrate), card)
    k1_launches += rt_launches["K1"]
    k1b_launches += rt_launches["K1 bf16 store"]
    k2_launches += rt_launches["K2"]
    w_routes["fused_nmf_pgm_step"]["wide"] += rt_launches["K1 wide"]
    w_routes["fused_nmf_adaprox_step"]["wide"] += rt_launches["K2 wide"]

    # 18. the very-wide path: AVIRIS-NG's 425 channels, K > 32 and K5
    # beyond C, K <= 8
    log(f"phase 18 starts at {time.perf_counter() - T0:.0f} s")
    v_times, v_err, v_launched = very_wide_phase(
        (algorithms, tnmf, top, tops, kk, sm, calibrate), card)

    # 19. the eleven examples at their default arguments
    log(f"phase 19 starts at {time.perf_counter() - T0:.0f} s")
    ex_runs = examples_phase(card)
    ex_k2 = example_k2_check(card)
    log(f"phase 19 ends at {time.perf_counter() - T0:.0f} s")

    k2_ms, k2_plain = k2_times["f32 moments"]
    k1b_ms, k1b_plain, k1b_bound = k1_times["bf16 store, W"]

    def entry(name, source, replaces, launches, max_abs_err, ms, plain_ms,
              bound, library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"proxmin_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

    log(json.dumps({"kernels": [
        entry("fused_nmf_pgm_step", "nmf_pgm_step.cu",
              "proxmin_tpu/ops/nmf_kernels.py:311", k1_launches, k1_abs,
              k1_ms, k1_plain, k1_bound),
        entry("fused_nmf_pgm_step[bfloat16 store]", "nmf_pgm_step.cu",
              "proxmin_tpu/ops/nmf_kernels.py:311", k1b_launches, k1bw_abs,
              k1b_ms, k1b_plain, k1b_bound),
        entry("fused_nmf_adaprox_step", "nmf_adaprox_step.cu",
              "proxmin_tpu/ops/nmf_kernels.py:525", k2_launches, k2_abs,
              k2_ms, k2_plain, k2_bound),
        entry("fused_nmf_adaprox_step[device scalars]", "nmf_adaprox_step.cu",
              "proxmin_tpu/ops/nmf_kernels.py:525", k2d_launches,
              k2d_abs["f32 moments"], k2d_ms, k2_plain, k2_bound),
        entry("fused_nmf_adaprox_step[bfloat16 store]", "nmf_adaprox_step.cu",
              "proxmin_tpu/ops/nmf_kernels.py:525", k2s_launches,
              k2s_abs["bf16 moments"], *k2s_times["bf16 moments"]),
        entry("fused_nmf_adaprox_step[fused_adam_unmixing, bf16 moments, "
              "C=6 K=4 N=20000]", "nmf_adaprox_step.cu",
              "proxmin_tpu/ops/nmf_kernels.py:525",
              ex_runs["fused_adam_unmixing"]["K2"], *ex_k2),
        entry("fused_nmf_grad", "nmf_grad.cu",
              "proxmin_tpu/ops/nmf_kernels.py:653", k3_launches, k3_abs,
              *k3_times["unweighted"]),
        *(entry(f"prox_{op}_pallas", "prox_elementwise.cu",
                f"proxmin_tpu/ops/prox_kernels.py:{line}", k4_launches[op],
                k4_abs[case], *k4_times[case, torch.float32])
          for op, case, line in (("plus", "plus", 126),
                                 ("soft", "soft relative", 131),
                                 ("hard", "hard relative", 139),
                                 ("unity", "unity axis 0", 161))),
        *(entry(f"packed_step[{layout}]", "nmf_adaprox_step.cu",
                "benchmarks/stream_merge.py:105", k5_launches[layout],
                k5_abs[layout], *k5_times[layout])
          for layout in ("smv", "mv")),
        *(entry(f"{kname}[{route}]", source, replaces,
                w_routes[kname][r_key], w_err[err_key], *w_times[t_key])
          for kname, route, source, replaces, r_key, err_key, t_key in (
              ("fused_nmf_pgm_step", "wide", "nmf_pgm_wide.cu",
               "proxmin_tpu/ops/nmf_kernels.py:311", "wide",
               ("K1", "chain", "full width", ""), "K1 chain"),
              ("fused_nmf_pgm_step", "split pass 1", "nmf_pgm_wide.cu",
               "proxmin_tpu/ops/nmf_kernels.py:311", "split pass 1",
               ("K1", "split", "full width", ""), "K1 split pass 1"),
              ("fused_nmf_pgm_step", "split pass 2", "nmf_pgm_wide.cu",
               "proxmin_tpu/ops/nmf_kernels.py:311", "split pass 2",
               ("K1", "split", "full width", ""), "K1 split pass 2"),
              ("fused_nmf_pgm_step", "chain", "nmf_pgm_step.cu",
               "proxmin_tpu/ops/nmf_kernels.py:311", "narrow",
               "K1 narrow", "K1 narrow chain"),
              ("fused_nmf_adaprox_step", "wide", "nmf_adaprox_wide.cu",
               "proxmin_tpu/ops/nmf_kernels.py:525", "wide",
               ("K2", "chain", "full width", "f32 moments"), "K2 chain"),
              ("fused_nmf_adaprox_step", "split pass 1",
               "nmf_adaprox_wide.cu", "proxmin_tpu/ops/nmf_kernels.py:525",
               "split pass 1", ("K2", "split", "full width", "f32 moments"),
               "K2 split pass 1"),
              ("fused_nmf_adaprox_step", "split pass 2",
               "nmf_adaprox_wide.cu", "proxmin_tpu/ops/nmf_kernels.py:525",
               "split pass 2", ("K2", "split", "full width", "f32 moments"),
               "K2 split pass 2"),
              ("fused_nmf_grad", "wide", "nmf_grad.cu",
               "proxmin_tpu/ops/nmf_kernels.py:653", "wide",
               ("K3", "full width", ""), "K3 wide"))),
        entry("fused_nmf_adaprox_step[wide, flagship chain]",
              "nmf_adaprox_wide.cu", "proxmin_tpu/ops/nmf_kernels.py:525",
              w_err["K2 flagship launches"], w_err["K2 flagship"],
              *w_times["K2 chain, flagship"]),
        *(entry(f"{kname}[{route}, C={shape[0]} K={shape[1]}]", source,
                replaces, v_launched.get((label, kname, r_key), 0),
                v_err[err_key], *v_times[f"{t_key} [{label}]"])
          for label, shape in VWIDE_LABELS
          for kname, route, source, replaces, r_key, err_key, t_key in (
              ("fused_nmf_pgm_step", "very wide", "nmf_pgm_wide.cu", K1_AT,
               "very wide", ("K1", "chain", label, ""), "K1 chain"),
              ("fused_nmf_pgm_step", "very wide split pass 1",
               "nmf_pgm_wide.cu", K1_AT, "split pass 1",
               ("K1", "split", label, ""), "K1 split pass 1"),
              # pass 2 has no C: at K <= 32 the wide body runs it
              ("fused_nmf_pgm_step", "split pass 2" if shape[1] <= 32
               else "very wide split pass 2", "nmf_pgm_wide.cu", K1_AT,
               "split pass 2", ("K1", "split", label, ""),
               "K1 split pass 2"),
              ("fused_nmf_adaprox_step", "very wide", "nmf_adaprox_wide.cu",
               K2_AT, "very wide", ("K2", "chain", label, "f32 moments"),
               "K2 chain"),
              ("fused_nmf_adaprox_step", "very wide split pass 1",
               "nmf_adaprox_wide.cu", K2_AT, "split pass 1",
               ("K2", "split", label, "f32 moments"), "K2 split pass 1"),
              ("fused_nmf_adaprox_step", "split pass 2" if shape[1] <= 32
               else "very wide split pass 2", "nmf_adaprox_wide.cu", K2_AT,
               "split pass 2", ("K2", "split", label, "f32 moments"),
               "K2 split pass 2"),
              ("fused_nmf_grad", "very wide", "nmf_grad.cu", K3_AT,
               "very wide", ("K3", label, ""), "K3"))),
        *(entry(f"packed_step[{layout}, K2's wide body]",
                "nmf_adaprox_wide.cu", "benchmarks/stream_merge.py:105",
                v_launched.get(("K5", "packed_step", "wide"), 0) // 2,
                v_err["K5", layout], *v_times[f"K5 {layout}"])
          for layout in ("smv", "mv"))]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
