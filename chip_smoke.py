#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It drives the port's two main paths on the flagship problem (C=5
channels, K=7 components, N=1e6 pixels, float32, non-negativity on both
factors, data made from seed 101 as in bench.py): PGM-NMF and
AdaProx-NMF through ``proxmin_tpu_torch.nmf.nmf``. It exits non-zero when
any phase fails. Phases:

1. probe: CUDA/driver/compiler versions, the card and its power limit;
2. build K1 and K2 from proxmin_tpu_torch/csrc/ with nvcc, both at once,
   and print ptxas's registers and spills for every kernel instance;
3. K1 against its plain PyTorch version at the flagship shape, with W, and
   at a ragged shape, plus its time beside the plain version's;
4. K2 against its plain version at the flagship with float32 and with
   bfloat16 moments, with W, at a ragged shape and with the identity prox,
   plus its times beside the plain version's;
5. PGM: nmf(engine="cuda") and nmf(engine="torch") for 200 iterations:
   iterates agree, the loss decreases, every iteration launched K1 once,
   and a resumed run reproduces the straight run bit for bit;
6. AdaProx: nmf(algorithm="adaprox", engine="cuda") against
   engine="torch" with separable_prox="auto" at 50, 100 and 200
   iterations, with the same checks for K2, bfloat16 moments against
   float32 ones, and the default nmf(algorithm="adaprox") (torch engine,
   prox sub-iterations) for 10 iterations;
7. marginal ms/iter of every engine and GB/s against the naive bytes.

The last two lines are the card (``nvidia-smi`` name and power limit)
after a JSON object describing the kernels, and then the result object
``{"ok": true, "device": {...}}``. With no CUDA device it fails at once.
"""

import json
import re
import subprocess
import sys
import time

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
    dev = torch.device("cuda", 0)
    return tuple(None if a is None else torch.from_numpy(a).to(dev)
                 for a in (Y, A0, S0, W))


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def cuda_ms(fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    a warm-up, with CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ptxas_summary(log_text):
    """One line per compiled kernel instance: its name with the template
    arguments, registers and spill stores, from ``nvcc -Xptxas -v``."""
    out, name = [], None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            base = next((b for b in ("pgm_step_kernel", "pgm_step_finalize",
                                     "adaprox_step_kernel",
                                     "adaprox_step_finalize")
                         if b + "ILi" in mangled), mangled)
            t = re.search(re.escape(base)
                          + r"ILi(\d+)ELi(\d+)E(f|13__nv_bfloat16)?E",
                          mangled)
            args = [t.group(1), t.group(2)] if t else []
            if t and t.group(3):
                args.append("float" if t.group(3) == "f" else "bfloat16")
            name = f"{base}<{','.join(args)}>"
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


def reset_counts(kernels):
    for k in kernels:
        k.launches = 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has nothing to run without one", file=sys.stderr)
        return 2
    from proxmin_tpu_torch import nmf as tnmf
    from proxmin_tpu_torch import operators as top
    from proxmin_tpu_torch.ops import nmf_kernels as kk

    k1_fn, k2_fn = kk.fused_nmf_pgm_step, kk.fused_nmf_adaprox_step

    # 1. probe
    name = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    nvcc = subprocess.run([kk._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    nvcc_line = next((ln for ln in nvcc.splitlines() if "release" in ln),
                     nvcc.strip().splitlines()[-1])
    log(f"probe: torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, device {name}, count "
        f"{torch.cuda.device_count()}")
    log(f"probe: nvidia-smi {card}")
    log(f"probe: nvcc {nvcc_line.strip()}")

    # 2. build K1 and K2 from the checkout's sources, one nvcc each, at once
    t0 = time.perf_counter()
    built = kk.build_kernels()
    root = kk._BUILD_DIR.parents[1]
    for kname, (path, seconds, build_log) in built.items():
        kk._library(kname)
        log(f"build: {kk._SOURCES[kname].relative_to(root)} -> "
            f"{path.relative_to(root)} "
            + (f"compiled in {seconds:.1f} s" if seconds else
               "already built"))
        for ln in ptxas_summary(build_log):
            log(f"build: ptxas {ln}")
    log(f"build: both kernels ready in {time.perf_counter() - t0:.1f} s")

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

    # 5. the PGM main path
    reset_counts((k1_fn, k2_fn))
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

    # 6. the AdaProx main path
    ada = dict(algorithm="adaprox", e_rel=0)
    reset_counts((k1_fn, k2_fn))
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

    # 7. marginal time per iteration
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
         "ms": k2_ms, "plain_ms": k2_plain}]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
