#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It drives the port's main paths on the flagship problem (C=5 channels,
K=7 components, N=1e6 pixels, float32, data made from seed 101 as in
bench.py): PGM-NMF and AdaProx-NMF through ``proxmin_tpu_torch.nmf.nmf``,
and the ``proxmin_tpu_torch.ops`` entry point the way its users drive it
(the prox kernels inside ``AlternatingProjections`` as ``nmf``'s S
constraint, ``fused_nmf_grad`` as ``pgm``'s gradient). It exits non-zero
when any phase fails. Phases:

1. probe: CUDA/driver/compiler versions, the card and its power limit;
2. build K1, K2, K3 and K4 from proxmin_tpu_torch/csrc/ with nvcc, all at
   once, and print ptxas's registers and spills for every kernel instance;
3. K1 against its plain PyTorch version at the flagship shape, with W, and
   at a ragged shape, plus its time beside the plain version's;
4. K2 against its plain version at the flagship with float32 and with
   bfloat16 moments, with W, at a ragged shape and with the identity prox,
   plus its times beside the plain version's;
5. K3 (fused_nmf_grad) against its plain version at the flagship, with W,
   and at a ragged shape, plus its times beside the plain version's;
6. K4 (prox_plus/soft/hard/unity_pallas) against their plain versions on
   an S-shaped (7, 1e6) tensor in float32 and float64 and at odd shapes,
   with relative and absolute thresholds from a step on the card (no host
   sync), NaN, unity along both axes, plus their times;
7. PGM: nmf(engine="cuda") and nmf(engine="torch") for 200 iterations:
   iterates agree, the loss decreases, every iteration launched K1 once,
   and a resumed run reproduces the straight run bit for bit;
8. AdaProx: nmf(algorithm="adaprox", engine="cuda") against
   engine="torch" with separable_prox="auto" at 50, 100 and 200
   iterations, with the same checks for K2, bfloat16 moments against
   float32 ones, and the default nmf(algorithm="adaprox") (torch engine,
   prox sub-iterations) for 10 iterations;
9. the ops paths for 200 iterations, each against its plain-operator twin:
   sum-to-one abundances, L1- and L0-sparse sources (K4 inside
   AlternatingProjections as prox_S), and pgm with K3's gradient; each
   launched its kernels once per iteration;
10. marginal ms/iter of every engine and path, and GB/s against the naive
   bytes.

The last two lines are the card (``nvidia-smi`` name and power limit)
after a JSON object describing the kernels, and then the result object
``{"ok": true, "device": {...}}``. With no CUDA device it fails at once.
"""

import json
import logging
import re
import subprocess
import sys
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
LO, HI = 50, 250  # iteration counts for the marginal ms/iter
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


def make_problem(C, K, N, weighted, seed=SEED):
    """bench.py's flagship problem on the card: Y = A_true S_true + noise,
    random A0, S0 (and W in [0.5, 1.5))."""
    rng = np.random.default_rng(seed)
    A_true = rng.random((C, K)).astype(np.float32)
    S_true = rng.random((K, N)).astype(np.float32)
    Y = (A_true @ S_true
         + 0.02 * rng.standard_normal((C, N))).astype(np.float32)
    A0 = rng.random((C, K)).astype(np.float32)
    S0 = rng.random((K, N)).astype(np.float32)
    W = (0.5 + rng.random((C, N))).astype(np.float32) if weighted else None
    return tuple(None if a is None else torch.from_numpy(a).to(DEVICE)
                 for a in (Y, A0, S0, W))


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def norm_err(got, ref):
    """Normwise (Frobenius) relative difference."""
    return float(torch.linalg.norm(got - ref)
                 / torch.linalg.norm(ref).clamp_min(1e-30))


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
                "unity_cols_kernel", "unity_rows_partials",
                "unity_rows_divide")
MANGLED_TYPES = (("f", "float"), ("d", "double"),
                 ("13__nv_bfloat16", "bfloat16"))
PROX_OPS = ("plus", "soft", "hard")


def kernel_name(mangled):
    """``base<args>`` from a mangled kernel instance name: int template
    arguments and the float, double and bfloat16 types."""
    for base in KERNEL_NAMES:
        key = f"{len(base)}{base}I"
        i = mangled.find(key)
        if i < 0:
            continue
        rest, args = mangled[i + len(key):], []
        while rest and rest[0] != "E":
            m = re.match(r"Li(\d+)E", rest)
            if m:
                args.append(m.group(1))
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
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                       "spill stores")
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
    got = k2.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc, W=W,
                                    prox_S=prox_S)
    again = k2.fused_nmf_adaprox_step(A, S, M, V, Y, alpha, sc, W=W,
                                      prox_S=prox_S)
    ref = k2.fused_nmf_adaprox_step_reference(A, S, M, V, Y, alpha, sc, W=W,
                                              prox_S=prox_S)
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
    return (A, S, M, V, Y, alpha, sc), max_abs


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


def reset_counts(kernels):
    for k in kernels:
        k.launches = 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has nothing to run without one", file=sys.stderr)
        return 2
    # the solvers warn at every max_iter stop, which every run here is
    logging.getLogger("proxmin").setLevel(logging.ERROR)
    from proxmin_tpu_torch import algorithms
    from proxmin_tpu_torch import nmf as tnmf
    from proxmin_tpu_torch import operators as top
    from proxmin_tpu_torch import ops as tops
    from proxmin_tpu_torch.ops import _build as kb
    from proxmin_tpu_torch.ops import nmf_kernels as kk

    k1_fn, k2_fn = kk.fused_nmf_pgm_step, kk.fused_nmf_adaprox_step
    k3_fn = tops.fused_nmf_grad
    k4_fns = {op: prox_pair(tops, op)[0] for op in
              ("plus", "soft", "hard", "unity")}
    every_kernel = (k1_fn, k2_fn, k3_fn, *k4_fns.values())

    # 1. probe
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
    t0 = time.perf_counter()
    built = kb.build_kernels()
    check(set(built) == {"nmf_pgm_step", "nmf_adaprox_step", "nmf_grad",
                         "prox_elementwise"}, f"built {sorted(built)}")
    root = kb._BUILD_DIR.parents[1]
    for kname, (path, seconds, build_log) in built.items():
        kb._library(kname)
        log(f"build: {kb._SOURCES[kname].relative_to(root)} -> "
            f"{path.relative_to(root)} "
            + (f"compiled in {seconds:.1f} s" if seconds else
               "already built"))
        for ln in ptxas_summary(build_log):
            log(f"build: ptxas {ln}")
    log(f"build: all {len(built)} kernel sources ready in "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. K1 against its plain version
    (Y, A0, S0, sS), k1_abs = compare_step(kk, "flagship", C, K, N, False)
    compare_step(kk, "flagship+W", C, K, N, True)
    compare_step(kk, "ragged", 8, 4, N + 37, False)
    k1_ms = min(cuda_ms(lambda: kk.fused_nmf_pgm_step(A0, S0, Y, sS))
                for _ in range(2))
    k1_plain = min(cuda_ms(lambda: kk.fused_nmf_pgm_step_reference(
        A0, S0, Y, sS)) for _ in range(2))
    naive = (C + 2 * K) * N * 4
    log(f"K1 time [flagship] on {card}: kernel {k1_ms:.4f} ms "
        f"({naive / k1_ms / 1e6:.0f} GB/s of {naive / 1e6:.0f} MB naive), "
        f"plain version {k1_plain:.4f} ms")

    # 4. K2 against its plain version
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

    # 5. K3 against its plain version
    k3_args, k3_abs = compare_grad(tops, "flagship", C, K, N, False)
    k3w_args, _ = compare_grad(tops, "flagship+W", C, K, N, True)
    compare_grad(tops, "ragged", 8, 4, N + 37, False)
    k3_times = {}
    for label, (A_, S_, Y_, W_), nbytes in (
            ("unweighted", k3_args, naive),
            ("with W", k3w_args, naive + C * N * 4)):
        k_ms = min(cuda_ms(lambda: tops.fused_nmf_grad(A_, S_, Y_, W=W_))
                   for _ in range(2))
        p_ms = min(cuda_ms(lambda: tops.fused_nmf_grad_reference(
            A_, S_, Y_, W=W_)) for _ in range(2))
        k3_times[label] = (k_ms, p_ms)
        log(f"K3 time [flagship, {label}] on {card}: kernel {k_ms:.4f} ms "
            f"({nbytes / k_ms / 1e6:.0f} GB/s of {nbytes / 1e6:.0f} MB "
            f"naive), plain version {p_ms:.4f} ms")

    # 6. K4 against its plain versions, on S's shape and on odd shapes, with
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
            k4_times[case, dt] = (k_ms, p_ms)
            log(f"K4 time [{case}, {K}x{N} {str(dt)[6:]}] on {card}: "
                f"kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.0f} GB/s of "
                f"{nbytes / 1e6:.0f} MB), plain version {p_ms:.4f} ms")

    # 7. the PGM main path
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

    # 8. the AdaProx main path
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

    def run_fn(n, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def marginal(fn):
        t_lo = min(run_fn(LO, fn) for _ in range(2))
        t_hi = min(run_fn(HI, fn) for _ in range(2))
        return (t_hi - t_lo) / (HI - LO) * 1e3

    def solve(prox_S):
        return lambda n: tnmf.nmf(Y, A0, S0, prox_S=prox_S, e_rel=0,
                                  max_iter=n)

    path_pairs = [(label, solve(prox), solve(twin))
                  for label, prox, twin, _ in prox_paths]
    path_pairs.append(("K3 gradient", pgm_k3, lambda n: tnmf.nmf(
        Y, A0, S0, e_rel=0, max_iter=n)))
    for _, fn, twin in path_pairs:
        run_fn(5, fn)
        run_fn(5, twin)
    for label, fn, twin in path_pairs:
        ms_t, ms_k, ms_k2, ms_t2 = (marginal(f) for f in (twin, fn, fn, twin))
        log(f"ops path [{label}]: {min(ms_k, ms_k2):.4f} ms/iter marginal "
            f"with the kernels ({ms_k:.4f}, {ms_k2:.4f}), plain twin "
            f"{min(ms_t, ms_t2):.4f} ({ms_t:.4f}, {ms_t2:.4f}); runs in the "
            f"order twin, kernels, kernels, twin; on {card}")

    k2_ms, k2_plain = k2_times["f32 moments"]
    log(json.dumps({"kernels": [
        {"name": "fused_nmf_pgm_step", "route": "cuda",
         "source": "proxmin_tpu_torch/csrc/nmf_pgm_step.cu",
         "replaces": "proxmin_tpu/ops/nmf_kernels.py:311",
         "launches": k1_launches, "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "fused_nmf_adaprox_step", "route": "cuda",
         "source": "proxmin_tpu_torch/csrc/nmf_adaprox_step.cu",
         "replaces": "proxmin_tpu/ops/nmf_kernels.py:525",
         "launches": k2_launches, "max_abs_err": k2_abs,
         "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "fused_nmf_grad", "route": "cuda",
         "source": "proxmin_tpu_torch/csrc/nmf_grad.cu",
         "replaces": "proxmin_tpu/ops/nmf_kernels.py:653",
         "launches": k3_launches, "max_abs_err": k3_abs,
         "ms": k3_times["unweighted"][0],
         "plain_ms": k3_times["unweighted"][1]},
        *({"name": f"prox_{op}_pallas", "route": "cuda",
           "source": "proxmin_tpu_torch/csrc/prox_elementwise.cu",
           "replaces": f"proxmin_tpu/ops/prox_kernels.py:{line}",
           "launches": k4_launches[op], "max_abs_err": k4_abs[case],
           "ms": k4_times[case, torch.float32][0],
           "plain_ms": k4_times[case, torch.float32][1]}
          for op, case, line in (("plus", "plus", 126),
                                 ("soft", "soft relative", 131),
                                 ("hard", "hard relative", 139),
                                 ("unity", "unity axis 0", 161)))]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
