#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It drives the port's main path, unweighted PGM-NMF through
``proxmin_tpu_torch.nmf.nmf`` on the flagship problem (C=5 channels, K=7
components, N=1e6 pixels, float32, non-negativity on both factors, data
made from seed 101 as in bench.py), and exits non-zero when any phase
fails. Phases:

1. probe: CUDA/driver/compiler versions, the card and its power limit;
2. build the K1 kernel from proxmin_tpu_torch/csrc/ with nvcc;
3. K1 against its plain PyTorch version at the flagship shape, with W, and
   at a ragged shape, plus its time beside the plain version's;
4. nmf(engine="cuda") and nmf(engine="torch") for 200 iterations: iterates
   agree, the loss is finite and decreases, every iteration launched K1
   once, and a resumed run reproduces the straight run bit for bit;
5. marginal ms/iter of both engines and GB/s against the naive bytes.

The last two lines are the card (``nvidia-smi`` name and power limit)
after a JSON object describing the kernels, and then the result object
``{"ok": true, "device": {...}}``. With no CUDA device it fails at once.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

C, K, N = 5, 7, 1_000_000
SEED = 101
ITERS = 200
# K1 vs its plain version: max |kernel - plain| / max |plain| per output.
# Both are float32; they sum the pixel-axis reductions in other orders.
# |S' - S|^2 cancels (S' - S is small against S), so it gets more room.
STEP_RTOL = 2e-4
DS_RTOL = 1e-3
# The two engines after 200 iterations, normwise per factor: float32 sums
# in other orders (cuBLAS split-K vs the kernel's tree), compounded.
ENGINE_RTOL = 1e-3
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has nothing to run without one", file=sys.stderr)
        return 2
    from proxmin_tpu_torch import nmf as tnmf
    from proxmin_tpu_torch.ops import nmf_kernels as k1

    # 1. probe
    name = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    nvcc = subprocess.run([k1._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    nvcc_line = next((ln for ln in nvcc.splitlines() if "release" in ln),
                     nvcc.strip().splitlines()[-1])
    log(f"probe: torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, device {name}, count "
        f"{torch.cuda.device_count()}")
    log(f"probe: nvidia-smi {card}")
    log(f"probe: nvcc {nvcc_line.strip()}")

    # 2. build K1 from the checkout's source
    path, seconds, build_log = k1.build_kernel()
    k1._library()
    ptxas = [ln.strip() for ln in build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"build: {k1._SOURCE.relative_to(k1._BUILD_DIR.parents[1])} -> "
        f"{path.relative_to(k1._BUILD_DIR.parents[1])} "
        + (f"compiled in {seconds:.1f} s" if seconds else "already built"))
    for ln in ptxas:
        log(f"build: ptxas {ln}")

    # 3. K1 against its plain version
    (Y, A0, S0, sS), max_abs = compare_step(k1, "flagship", C, K, N, False)
    compare_step(k1, "flagship+W", C, K, N, True)
    compare_step(k1, "ragged", 8, 4, N + 37, False)
    k_ms = min(cuda_ms(lambda: k1.fused_nmf_pgm_step(A0, S0, Y, sS))
               for _ in range(2))
    p_ms = min(cuda_ms(lambda: k1.fused_nmf_pgm_step_reference(A0, S0, Y,
                                                               sS))
               for _ in range(2))
    naive = (C + 2 * K) * N * 4
    log(f"K1 time [flagship] on {card}: kernel {k_ms:.4f} ms "
        f"({naive / k_ms / 1e6:.0f} GB/s of {naive / 1e6:.0f} MB naive), "
        f"plain version {p_ms:.4f} ms")

    # 4. the main path
    k1.fused_nmf_pgm_step.launches = 0
    res_c = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=ITERS, engine="cuda")
    torch.cuda.synchronize()
    launches = k1.fused_nmf_pgm_step.launches
    res_t = tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=ITERS, engine="torch")
    torch.cuda.synchronize()
    check(res_c.iterations == ITERS and res_t.iterations == ITERS,
          f"iterations {res_c.iterations}, {res_t.iterations}")
    check(launches == res_c.iterations,
          f"K1 launched {launches} times in {res_c.iterations} iterations")
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
    log(f"main path: nmf engine=cuda vs engine=torch, {ITERS} iterations "
        f"at e_rel=0: A rel err {e_A:.2e}, S rel err {e_S:.2e} "
        f"(tol {ENGINE_RTOL:g}); loss {loss0:.6e} -> cuda {loss_c:.6e}, "
        f"torch {loss_t:.6e}; K1 launches {launches} = iterations "
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
    log(f"main path: 4 x {ITERS // 4} resumed cuda iterations equal "
        f"{ITERS} straight ones bit for bit; segment losses "
        + ", ".join(f"{v:.6e}" for v in losses))

    # 5. marginal time per iteration
    def run(engine, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tnmf.nmf(Y, A0, S0, e_rel=0, max_iter=n, engine=engine)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for engine in ("cuda", "torch", "cuda", "torch"):
        run(engine, 5)
    for engine in ("torch", "cuda"):
        t_lo = min(run(engine, LO) for _ in range(2))
        t_hi = min(run(engine, HI) for _ in range(2))
        ms = (t_hi - t_lo) / (HI - LO) * 1e3
        log(f"engine={engine}: {ms:.4f} ms/iter marginal ({LO}->{HI} "
            f"iterations), {naive / ms / 1e6:.1f} GB/s of "
            f"{naive / 1e6:.0f} MB naive per iteration, on {card}")

    log(json.dumps({"kernels": [{
        "name": "fused_nmf_pgm_step", "route": "cuda",
        "source": "proxmin_tpu_torch/csrc/nmf_pgm_step.cu",
        "replaces": "proxmin_tpu/ops/nmf_kernels.py:311",
        "launches": launches, "max_abs_err": max_abs,
        "ms": k_ms, "plain_ms": p_ms}]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
