"""Device times of K1 (``fused_nmf_pgm_step``), K3 (``fused_nmf_grad``) and,
with ``--wide``, of the wide body (K1, K2, K3 and the split passes), with
``--vwide`` of the very-wide tier, of one checkout of the port, on a CUDA
card.

    python3 tools/k13_times.py [--repo DIR] [--label NAME] [--wide | --vwide]
                               [--shapes C,K,N ...]

imports ``proxmin_tpu_torch`` from ``DIR`` (default: this checkout), so that
two checkouts, e.g. a parent commit unpacked with ``git archive``, are
compared by running this script on each, in turns, on one card (each builds
its kernels into its own ``build/kernels/``). The operands are this
checkout's ``chip_smoke.make_problem`` (C=5, K=7, N=1e6, seed 101; W in
[0.5, 1.5)), K1 also with the simplex on S (its narrow chain kernel); with ``--wide`` its ``chip_smoke.make_unmixing`` at
``chip_smoke.WIDE`` (128, 32, 1e6) and ``WIDE_SWEEP`` (64, 16, 250 000), the
simplex on S for K1, the relative L1 threshold for K2 (both also the
identity), and K2's wide body at the flagship with the same threshold,
without and with W. With ``--vwide``, at ``chip_smoke.VWIDE`` (425, 32,
1e6), ``VWIDE_K64`` (128, 64, 250 000), (300, 8, 1e6) and (128, 128,
250 000) from ``make_unmixing``: K1 with the simplex on S (float32
without and with W, the bfloat16 store with W) and both split passes
(pass 2 in both stores), K2 with the relative L1 threshold (float32 and
bfloat16 moments, the bfloat16 store, the device-scalar entry) and both
split passes, K3; and the plain PyTorch versions of K1, K2, K3 and of the
split passes (timed, not hashed). ``--shapes`` replaces the very-wide
shapes by the ones given, e.g. ``--shapes 425,64,250000`` (C past 160, where
the instance of 64 components keeps gA's last chunks in the group's row).
Each case is timed as ``chip_smoke.py`` times it, the least of two
``chip_smoke.cuda_ms`` means (20 calls; 10 with ``--wide``). Prints one
JSON object ``{"label": ..., "ms": {case: ms}, "sha256": {case: [digest
of each output's bytes]}}``, so that two checkouts' outputs can be
compared bit for bit.
"""

import argparse
import hashlib
import importlib.util
import json
import sys
from functools import partial
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def digest(t):
    """SHA-256 of a tensor's bytes, as the card holds them."""
    import torch

    b = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(b.tobytes()).hexdigest()[:16]


def flagship_cases(cs, kk, top):
    Y, A, S, W = cs.make_problem(cs.C, cs.K, cs.N, True)
    import torch

    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    bf = torch.bfloat16
    Sb, Yb, Wb = S.to(bf), Y.to(bf), W.to(bf)
    return {
        "K1 f32": lambda: kk.fused_nmf_pgm_step(A, S, Y, sS),
        "K1 f32 W": lambda: kk.fused_nmf_pgm_step(A, S, Y, sS, W=W),
        "K1 bf16": lambda: kk.fused_nmf_pgm_step(A, Sb, Yb, sS),
        "K1 bf16 W": lambda: kk.fused_nmf_pgm_step(A, Sb, Yb, sS, W=Wb),
        "K3": lambda: kk.fused_nmf_grad(A, S, Y),
        "K3 W": lambda: kk.fused_nmf_grad(A, S, Y, W=W),
        "K1 chain": partial(kk.fused_nmf_pgm_step, A, S, Y, sS,
                            prox_S=partial(top.prox_unity_plus, axis=0)),
    }


def wide_cases(cs, kk, nmf, top):
    """The wide body's calls of chip_smoke.py's phase 15, at both widths,
    and K2's wide body at the flagship."""
    import torch

    simplex = partial(top.prox_unity_plus, axis=0)
    l1 = partial(top.prox_soft_plus, thresh=cs.WIDE_L1, type="relative")
    tile = kk.DEFAULT_TILE_N
    cases = {}
    for label, (C, K, N) in (("", cs.WIDE), (" sweep", cs.WIDE_SWEEP)):
        Y, A, S, W = cs.make_unmixing(C, K, N)
        sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
        M = torch.zeros_like(S)
        al = S.sum(1, keepdim=True) / N / 10
        sc = nmf._bias_corrections(0.9, 0.999, 3)
        X = kk._pgm_pass1_cuda(A, S, Y, sS, None, tile)[0]
        P1 = simplex(X, sS)
        pre = kk._adaprox_pass1_cuda(A, S, M, M, Y, al, sc, None, 0.999,
                                     1e-8, tile)
        P2 = partial(top.prox_soft_plus, thresh=cs.WIDE_L1,
                     type="relative")(pre[0], pre[1])
        cases.update({
            f"K1 wide{label}": partial(kk.fused_nmf_pgm_step, A, S, Y, sS,
                                       prox_S=simplex),
            f"K1 wide W{label}": partial(kk.fused_nmf_pgm_step, A, S, Y, sS,
                                         W=W, prox_S=simplex),
            f"K1 wide id{label}": partial(kk.fused_nmf_pgm_step, A, S, Y, sS,
                                          prox_S=top.prox_id),
            f"K1 split pass 1{label}": partial(kk._pgm_pass1_cuda, A, S, Y,
                                               sS, None, tile),
            f"K1 split pass 2{label}": partial(kk._pgm_pass2_cuda, S, P1,
                                               tile),
            f"K2 wide{label}": partial(kk.fused_nmf_adaprox_step, A, S, M,
                                       M, Y, al, sc, prox_S=l1),
            f"K2 wide id{label}": partial(
                kk.fused_nmf_adaprox_step, A, S, M, M, Y, al, sc,
                prox_S=kk.describe_prox(top.prox_id, "adaprox", True)),
            f"K2 split pass 1{label}": partial(kk._adaprox_pass1_cuda, A, S,
                                               M, M, Y, al, sc, None, 0.999,
                                               1e-8, tile),
            f"K2 split pass 2{label}": partial(kk._adaprox_pass2_cuda, S, P2,
                                               tile),
            f"K3 wide{label}": partial(kk.fused_nmf_grad, A, S, Y),
        })
    Y, A, S, W = cs.make_problem(cs.C, cs.K, cs.N, True)
    import numpy as np

    rng = np.random.default_rng(cs.SEED + 4)
    M = torch.from_numpy(0.1 * rng.standard_normal(
        (cs.K, cs.N), dtype=np.float32)).to(cs.DEVICE)
    V = torch.from_numpy(0.01 * rng.random(
        (cs.K, cs.N), dtype=np.float32)).to(cs.DEVICE)
    al = S.sum(1, keepdim=True) / cs.N / 10
    sc = nmf._bias_corrections(0.9, 0.999, 3)
    cases["K2 wide flagship"] = partial(kk.fused_nmf_adaprox_step, A, S, M,
                                        V, Y, al, sc, prox_S=l1)
    cases["K2 wide flagship W"] = partial(kk.fused_nmf_adaprox_step, A, S, M,
                                          V, Y, al, sc, W=W, prox_S=l1)
    return cases


VWIDE_SHAPES_EXTRA = ((300, 8, 1_000_000), (128, 128, 250_000))


def vwide_cases(cs, kk, nmf, top, tops, shapes=None):
    """The very-wide tier's modes at its four shapes (or at ``shapes``);
    ``(cases, plain)``, the plain versions' calls apart (timed, not
    hashed)."""
    import torch

    simplex = partial(top.prox_unity_plus, axis=0)
    l1 = partial(top.prox_soft_plus, thresh=cs.WIDE_L1, type="relative")
    tile = kk.DEFAULT_TILE_N
    bf = torch.bfloat16
    cases, plain = {}, {}
    for C, K, N in shapes or (cs.VWIDE, cs.VWIDE_K64) + VWIDE_SHAPES_EXTRA:
        tag = f" ({C}, {K})"
        Y, A, S, W = cs.make_unmixing(C, K, N)
        sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
        Sb, Yb, Wb = S.to(bf), Y.to(bf), W.to(bf)
        M = torch.zeros_like(S)
        Mb = M.to(bf)
        al = S.sum(1, keepdim=True) / N / 10
        sc = nmf._bias_corrections(0.9, 0.999, 3)
        dsc = torch.tensor([float(v) for v in sc], dtype=torch.float32,
                           device=S.device)
        X = kk._pgm_pass1_cuda(A, S, Y, sS, None, tile)[0]
        P1 = simplex(X, sS).contiguous()
        pre = kk._adaprox_pass1_cuda(A, S, M, M, Y, al, sc, None, 0.999,
                                     1e-8, tile)
        P2 = l1(pre[0], pre[1]).contiguous()
        cases.update({
            f"K1 vwide{tag}": partial(kk.fused_nmf_pgm_step, A, S, Y, sS,
                                      prox_S=simplex),
            f"K1 vwide W{tag}": partial(kk.fused_nmf_pgm_step, A, S, Y, sS,
                                        W=W, prox_S=simplex),
            f"K1 vwide bf16 W{tag}": partial(kk.fused_nmf_pgm_step, A, Sb,
                                             Yb, sS, W=Wb, prox_S=simplex),
            f"K1 pass 1{tag}": partial(kk._pgm_pass1_cuda, A, S, Y, sS,
                                       None, tile),
            f"K1 pass 2{tag}": partial(kk._pgm_pass2_cuda, S, P1, tile),
            f"K1 pass 2 bf16{tag}": partial(kk._pgm_pass2_cuda, Sb, P1,
                                            tile),
            f"K2 vwide{tag}": partial(kk.fused_nmf_adaprox_step, A, S, M, M,
                                      Y, al, sc, prox_S=l1),
            f"K2 vwide bf16m{tag}": partial(kk.fused_nmf_adaprox_step, A, S,
                                            Mb, Mb, Y, al, sc, prox_S=l1),
            f"K2 vwide bf16{tag}": partial(kk.fused_nmf_adaprox_step, A, Sb,
                                           Mb, Mb, Yb, al, sc, prox_S=l1),
            f"K2 vwide dsc{tag}": partial(kk.fused_nmf_adaprox_step, A, S, M,
                                          M, Y, al, dsc, prox_S=l1),
            f"K2 pass 1{tag}": partial(kk._adaprox_pass1_cuda, A, S, M, M, Y,
                                       al, sc, None, 0.999, 1e-8, tile),
            f"K2 pass 2{tag}": partial(kk._adaprox_pass2_cuda, S, P2, tile),
            f"K3 vwide{tag}": partial(tops.fused_nmf_grad, A, S, Y),
        })
        plain.update({
            f"K1 plain{tag}": partial(kk.fused_nmf_pgm_step_reference, A, S,
                                      Y, sS, prox_S=simplex),
            f"K1 pass 1 plain{tag}": partial(kk._pgm_pass1_reference, A, S,
                                             Y, sS),
            f"K1 pass 2 plain{tag}": partial(kk._pgm_pass2_reference, S, P1,
                                             torch.float32),
            f"K2 plain{tag}": partial(
                kk.fused_nmf_adaprox_step_reference, A, S, M, M, Y, al, sc,
                prox_S=kk.describe_prox(l1, "adaprox", True)),
            f"K2 pass 1 plain{tag}": partial(
                kk._adaprox_pass1_reference, A, S, M, M, Y, al, sc),
            f"K2 pass 2 plain{tag}": partial(kk._adaprox_pass2_reference, S,
                                             P2, torch.float32),
            f"K3 plain{tag}": partial(tops.fused_nmf_grad_reference, A, S,
                                      Y),
        })
    return cases, plain


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--label", default=None)
    ap.add_argument("--wide", action="store_true",
                    help="time the wide body and hash its outputs")
    ap.add_argument("--vwide", action="store_true",
                    help="time the very-wide tier and hash its outputs")
    ap.add_argument("--shapes", nargs="+", default=None, metavar="C,K,N",
                    help="with --vwide: the shapes to time instead")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch
    from proxmin_tpu_torch import nmf, operators
    from proxmin_tpu_torch import ops as tops
    from proxmin_tpu_torch.ops import nmf_kernels as kk

    # this checkout's chip_smoke, whichever checkout the kernels come from
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    out = {"label": args.label or args.repo}
    if args.vwide:
        shapes = args.shapes and [tuple(int(v) for v in sh.split(","))
                                  for sh in args.shapes]
        cases, plain = vwide_cases(cs, kk, nmf, operators, tops, shapes)
        out["ms"] = {case: min(cs.cuda_ms(fn, reps=10) for _ in range(2))
                     for case, fn in {**cases, **plain}.items()}
    elif args.wide:
        cases = wide_cases(cs, kk, nmf, operators)
        out["ms"] = {case: min(cs.cuda_ms(fn, reps=10) for _ in range(2))
                     for case, fn in cases.items()}
    else:
        cases = flagship_cases(cs, kk, operators)
        out["ms"] = {case: min(cs.cuda_ms(fn) for _ in range(2))
                     for case, fn in cases.items()}
    out["sha256"] = {}
    for case, fn in cases.items():
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        out["sha256"][case] = [digest(g) for g in got
                               if isinstance(g, torch.Tensor)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
