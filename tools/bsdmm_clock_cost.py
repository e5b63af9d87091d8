"""The bsdmm driver's sweep on its host clock against the same sweep on the
tensor clock of the exported bsdmm programs, run eagerly in the driver's
loop: do they end bit for bit equal, and what does each sweep cost?

    python3 tools/bsdmm_clock_cost.py [--cpu] [--n N]

For each case of ``chip_smoke.EX_BSDMM`` (the weighted ``nmf(algorithm=
"bsdmm", W=...)`` on the ``WeightedBSDMMStepper`` at stride 10, fixed and
adaptive, the unweighted ``steps_f_stride=3`` and a ``steps_g_update=
"relative"`` sum-to-one S) on ``chip_smoke``'s flagship problem (C 5, K 7,
N 1e6 on the card; ``--n`` pixels instead), it runs

- the driver as a user calls it (the sweep clock a host int), and
- the driver's loop on the tensor clock: the carry of
  ``solvers.bsdmm._Program.init_traced``, a 0-d int32 sweep counter on the
  blocks' device as ``export.export_bsdmm_solver``'s loop has it, each
  sweep's flags read once as the driver reads them, ``torch.cond`` and
  ``while_loop`` run eagerly,

checks that both end bit for bit equal after ``TURN_HI`` sweeps, and
prints one JSON line: per case, the seconds of the tensor clock's first
call (eager ``torch.cond`` and ``while_loop`` compile their bodies on first
use) and both forms' marginal ms/sweep between ``TURN_LO`` and ``TURN_HI``
sweeps, one run per count, in turns (driver, tensor, tensor, driver), on
the host clock after a device synchronize.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def tensor_clock_solver(x_shapes, proxs_f, steps_f_cb, proxs_g=None,
                        steps_g=None, Ls=None, update_order=None,
                        steps_g_update="steps_f", e_rel=1e-6, e_abs=0,
                        max_iter=1000, steps_f_stride=None, dtype=None,
                        device=None):
    """``export.export_bsdmm_solver``'s arguments; returns ``run(*xs) ->
    (x_blocks, sweeps)``, the driver's loop over the program's sweep."""
    import torch

    from proxmin_tpu_torch.solvers.bsdmm import _Program

    def run(*xs):
        dev = xs[0].device
        prog = _Program(len(xs), dev, proxs_f, steps_f_cb, proxs_g=proxs_g,
                        steps_g=steps_g, Ls=Ls, update_order=update_order,
                        steps_g_update=steps_g_update, e_rel=e_rel,
                        e_abs=e_abs, steps_f_stride=steps_f_stride)
        st = prog.init_traced(list(xs))
        k = 0
        while k < max_iter:
            flags, _ = prog.sweep(
                st, torch.tensor(k, dtype=torch.int32, device=dev))
            k += 1
            flags = flags.tolist()
            if all(flags[:-1]) or flags[-1]:
                break
        return tuple(st["x"]), k
    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import logging

    import torch

    import chip_smoke as cs
    from proxmin_tpu_torch import export as tex
    from proxmin_tpu_torch import nmf as tnmf
    from proxmin_tpu_torch import operators as top

    logging.getLogger("proxmin").setLevel(logging.ERROR)
    if args.cpu:
        cs.DEVICE = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("no CUDA device; pass --cpu", file=sys.stderr)
        return 1

    def sync():
        if cs.DEVICE.type == "cuda":
            torch.cuda.synchronize()

    def seconds(fn, n):
        sync()
        t0 = time.perf_counter()
        fn(n)
        sync()
        return time.perf_counter() - t0

    def turn_ms(fn):
        return (seconds(fn, cs.TURN_HI) - seconds(fn, cs.TURN_LO)) / (
            cs.TURN_HI - cs.TURN_LO) * 1e3

    Y, A0, S0, Ww = cs.make_problem(cs.C, cs.K, args.n or cs.N, True)
    out = {}
    for name in cs.EX_BSDMM:
        real = tex.export_bsdmm_solver
        tex.export_bsdmm_solver = tensor_clock_solver
        try:
            make, driver = cs.bsdmm_program_case(name, tnmf, top, Y, A0, S0,
                                                 Ww)
            solvers = {n: make(n) for n in (cs.TURN_LO, cs.TURN_HI)}
        finally:
            tex.export_bsdmm_solver = real

        def tensor(n, solvers=solvers):
            return solvers[n](A0, S0)
        first = seconds(tensor, cs.TURN_HI)
        xs_t, k_t = tensor(cs.TURN_HI)
        res = driver(cs.TURN_HI)
        equal = k_t == res.iterations and all(
            torch.equal(a, b) for a, b in zip(xs_t, res.x))
        seconds(driver, cs.TURN_LO)
        d1, t1, t2, d2 = (turn_ms(f) for f in (driver, tensor, tensor,
                                                driver))
        out[name] = {"bit_for_bit": equal, "tensor_first_call_s": first,
                     "driver_ms_per_sweep": [d1, d2],
                     "tensor_ms_per_sweep": [t1, t2]}
    print(json.dumps({"device": str(cs.DEVICE), "C": cs.C, "K": cs.K,
                      "N": int(S0.shape[1]), "sweeps": [cs.TURN_LO,
                                                        cs.TURN_HI],
                      "cases": out}))
    return 0 if all(c["bit_for_bit"] for c in out.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
