"""Device times of K1 (``fused_nmf_pgm_step``) and K3 (``fused_nmf_grad``)
of one checkout of the port, at the flagship, on a CUDA card.

    python3 tools/k13_times.py [--repo DIR] [--label NAME]

imports ``proxmin_tpu_torch`` from ``DIR`` (default: this checkout), so that
two checkouts, e.g. a parent commit unpacked with ``git archive``, are
compared by running this script on each, in turns, on one card (each builds
its kernels into its own ``build/kernels/``). The operands are this
checkout's ``chip_smoke.make_problem`` (C=5, K=7, N=1e6, seed 101; W in
[0.5, 1.5)); each case is timed as ``chip_smoke.py`` times it, the least of
two ``chip_smoke.cuda_ms`` means of 20 calls. Prints one JSON object
``{"label": ..., "ms": {case: ms}}``.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch
    from proxmin_tpu_torch.ops import nmf_kernels as kk

    # this checkout's chip_smoke, whichever checkout the kernels come from
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    Y, A, S, W = cs.make_problem(cs.C, cs.K, cs.N, True)
    sS = 1.0 / torch.linalg.eigvalsh(A.T @ A)[-1]
    bf = torch.bfloat16
    Sb, Yb, Wb = S.to(bf), Y.to(bf), W.to(bf)
    cases = {
        "K1 f32": lambda: kk.fused_nmf_pgm_step(A, S, Y, sS),
        "K1 f32 W": lambda: kk.fused_nmf_pgm_step(A, S, Y, sS, W=W),
        "K1 bf16": lambda: kk.fused_nmf_pgm_step(A, Sb, Yb, sS),
        "K1 bf16 W": lambda: kk.fused_nmf_pgm_step(A, Sb, Yb, sS, W=Wb),
        "K3": lambda: kk.fused_nmf_grad(A, S, Y),
        "K3 W": lambda: kk.fused_nmf_grad(A, S, Y, W=W),
    }
    out = {case: min(cs.cuda_ms(fn) for _ in range(2))
           for case, fn in cases.items()}
    print(json.dumps({"label": args.label or args.repo, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
