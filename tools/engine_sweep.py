"""The sweep that ``nmf(engine="auto")``'s routing table comes from: the
marginal ms per iteration of the ``torch`` and ``cuda`` engines over factor
shapes, pixel counts and solver paths, on one CUDA card.

    python3 tools/engine_sweep.py [--out FILE] [--budget SECONDS]
                                  [--shapes C,K ...] [--ns N ...]
    python3 tools/engine_sweep.py --table FILE

Each point is one (C, K, N) and one path, solved through
``proxmin_tpu_torch.nmf.nmf`` with ``e_rel=0`` on
``chip_smoke.route_problem``'s data (seed 101, W in [0.5, 1.5): below
C = 64 ``make_problem``'s from its planted start, from C = 64 on
``make_unmixing``'s) with ``prox_plus`` on A and on S, and the simplex on
S (``prox_unity_plus`` along the components) for PGM at C >= 64
(``chip_smoke.route_solver``). Its marginal ms/iter per engine is the
slope between ``LO`` and ``HI`` iterations, from the least host time of
each count over ``PAIRS`` pairs; the engines alternate within a pair
(torch first in even pairs, cuda first in odd ones), and each engine's
first solve, which builds and warms it, is not timed. Beside it stand
each pair's own slope (the spread), the device's busy µs per iteration
(the CUDA kernel time of a ``PROF_HI``-iteration solve less that of a
``PROF_LO`` one, from ``torch.profiler``) and the fewest iterations a
timed ``HI`` solve ran: a point whose solves stopped early (a divergence)
is marked ``"valid": false``.

The paths (``chip_smoke.ROUTE_PATHS``): PGM unweighted exact; unweighted
``step_stride=10``; weighted ``step_stride=10``; weighted
``step_stride=10, step_adapt=True``; weighted stride 10 with the bfloat16
store on the cuda engine (the torch engine has no store option: it runs
the same solve in float32); AdaProx with float32 moments and
``separable_prox="auto"``; AdaProx with bfloat16 moments. The grid is
``SHAPES`` at every N of ``NS`` and the very-wide body's ``VWIDE_SHAPES``
at ``VWIDE_NS``; ``--shapes`` and ``--ns`` take a part of it.

Prints the card's name and power limit, then one JSON line per point
(also appended to ``--out``), then a summary line. Points are taken in
the order of N, then of the shapes, so that ``--budget`` (seconds), once
spent, drops the largest ones; the dropped points are listed in the
summary. ``--table FILE`` reads such a file instead (no card needed) and
prints the routing regions that ``nmf``'s ``engine="auto"`` takes from it
(``regions``), then every point as a Markdown table: torch/cuda ms/iter,
(torch/cuda busy µs/iter), verdict.
"""

import argparse
import json
import logging
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402

LO, HI = 50, 250
PAIRS = 3
PROF_LO, PROF_HI = 20, 60
SHAPES = ((5, 7), (16, 8), (32, 16), (64, 16), (128, 32), (256, 32))
NS = (10_000, 100_000, 1_000_000, 10_000_000)
#: The very-wide body's shapes (C > 256 or K > 32): past C = 256 with few
#: components, AVIRIS-NG's 425 channels, its instances of 64 and of 128
#: components.
VWIDE_SHAPES = ((300, 8), (425, 32), (128, 64), (128, 128))
VWIDE_NS = (100_000, 1_000_000)
#: Left out: the torch engine alone would take minutes a point.
DROP = ((128, 32, 10_000_000), (256, 32, 10_000_000))


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(solve, n):
    """Host seconds of ``solve(n)`` and the iterations it ran."""
    sync()
    t0 = time.perf_counter()
    res = solve(n)
    sync()
    return time.perf_counter() - t0, res.iterations


def busy_us(solve, n):
    """Device µs of ``solve(n)``: its CUDA kernel events, summed."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve(n)
        sync()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    return sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel")


def measure(solves, pairs, lo=LO, hi=HI):
    """Marginal ms/iter of each engine's ``solve``, each pair's own slope
    and the fewest iterations a timed ``hi`` solve ran (a solve that stops
    early measures nothing), the engines alternating within a pair."""
    for s in solves.values():
        s(lo)  # build and warm, untimed
    times = {e: {lo: [], hi: []} for e in solves}
    ran = {e: hi for e in solves}
    names = list(solves)
    for p in range(pairs):
        for e in (names if p % 2 == 0 else names[::-1]):
            for n in (lo, hi):
                t, it = timed(solves[e], n)
                times[e][n].append(t)
                if n == hi:
                    ran[e] = min(ran[e], it)
    out = {}
    for e, t in times.items():
        out[e] = {
            "ms": (min(t[hi]) - min(t[lo])) / (hi - lo) * 1e3,
            "pair_ms": [(b - a) / (hi - lo) * 1e3
                        for a, b in zip(t[lo], t[hi])],
            "iterations": ran[e],
        }
    return out


def point(tnmf, top, problem, path):
    C, K = problem[1].shape
    N = problem[2].shape[1]
    engines = ("torch", "cuda")
    solves = {e: cs.route_solver(tnmf, top, problem, path, e)
              for e in engines}
    res = measure(solves, PAIRS)
    row = {"C": C, "K": K, "N": N, "path": path}
    for e in engines:
        busy = (busy_us(solves[e], PROF_HI) - busy_us(solves[e], PROF_LO))
        row[f"{e}_ms"] = res[e]["ms"]
        row[f"{e}_pair_ms"] = res[e]["pair_ms"]
        row[f"{e}_busy_us"] = busy / (PROF_HI - PROF_LO)
        row[f"{e}_iterations"] = res[e]["iterations"]
    row["valid"] = all(res[e]["iterations"] == HI for e in engines)
    row["winner"] = min(engines, key=lambda e: row[f"{e}_ms"])
    row["torch_over_cuda"] = row["torch_ms"] / row["cuda_ms"]
    return row


def classify(row):
    """``"cuda"`` or ``"torch"`` when one engine's slowest pair is faster
    than the other's fastest (the sweep's own spread separates them),
    ``"tie"`` when the two ranges of pair slopes overlap."""
    t, c = row["torch_pair_ms"], row["cuda_pair_ms"]
    if max(c) < min(t):
        return "cuda"
    if max(t) < min(c):
        return "torch"
    return "tie"


def regions(rows):
    """The routing table from a sweep's points: ``{path: {(C, K): (n_x,
    gray)}}``. ``n_x`` is the least swept N from which on the cuda engine's
    marginal was the smaller at every larger swept N (None: at none, 0:
    at every one swept); ``gray`` is None where the sweep found no
    crossover (one engine the faster at every N), else the inclusive N
    range ``(lo, hi)`` from the crossover's interval (the swept N below
    n_x, exclusive, to n_x, exclusive) widened by the ties next to it."""
    table = {}
    for row in rows:
        if "cuda_ms" not in row or not row.get("valid", True):
            continue
        key = (row["C"], row["K"])
        table.setdefault(row["path"], {}).setdefault(key, []).append(row)
    out = {}
    for path, shapes in table.items():
        out[path] = {}
        for key, pts in sorted(shapes.items()):
            pts.sort(key=lambda r: r["N"])
            ns = [r["N"] for r in pts]
            wins = [r["cuda_ms"] < r["torch_ms"] for r in pts]
            kind = [classify(r) for r in pts]
            i = len(pts)
            while i > 0 and wins[i - 1]:
                i -= 1
            if i == 0:
                out[path][key] = (0, None)
                continue
            if i == len(pts):
                out[path][key] = (None, None)
                continue
            lo_i, hi_i = i - 1, i
            lo, hi = ns[lo_i] + 1, ns[hi_i] - 1
            while lo_i >= 0 and kind[lo_i] == "tie":
                lo = ns[lo_i]
                lo_i -= 1
            while hi_i < len(pts) and kind[hi_i] == "tie":
                hi = ns[hi_i]
                hi_i += 1
            out[path][key] = (ns[i], (lo, hi))
    return out


def table_main(path):
    """Print the routing regions of a sweep's JSONL, then every point as
    Markdown rows, one per path and N: for each (C, K), the torch and cuda
    engines' marginal ms/iter and busy µs/iter, and the verdict (``cuda``,
    ``torch``, ``tie``; ``stopped`` for a solve that ended early). No card
    needed."""
    rows = [json.loads(line) for line in open(path) if line.strip()]
    rows = [r for r in rows if "path" in r]
    for p, t in regions(rows).items():
        print(f"{p!r}: " + repr(t) + ",")
    shapes = sorted({(r["C"], r["K"]) for r in rows if "cuda_ms" in r})
    print("| path | N | " + " | ".join(f"{c}×{k}" for c, k in shapes)
          + " |")
    print("| --- | --- |" + " --- |" * len(shapes))
    cells = {}
    for r in rows:
        if "cuda_ms" not in r:
            continue
        verdict = classify(r) if r.get("valid", True) else "stopped"
        cells.setdefault((r["path"], r["N"]), {})[r["C"], r["K"]] = (
            f"{r['torch_ms']:.4f}/{r['cuda_ms']:.4f} "
            f"({r['torch_busy_us']:.0f}/{r['cuda_busy_us']:.0f}) {verdict}")
    for (p, n), by_shape in sorted(cells.items(),
                                   key=lambda kv: (list(regions(rows)).index(
                                       kv[0][0]), kv[0][1])):
        print(f"| {p} | {n:.0e} | "
              + " | ".join(by_shape.get(ck, "-") for ck in shapes) + " |")
    return 0


def grid(shapes=None, ns=None):
    """The sweep's (C, K, N) points in the order they are taken: by N, then
    by shape; ``shapes`` and ``ns`` keep a part of the grid."""
    pts = [(c, k, n) for c, k in SHAPES for n in NS]
    pts += [(c, k, n) for c, k in VWIDE_SHAPES for n in VWIDE_NS]
    pts = [p for p in pts if p not in DROP
           and (shapes is None or p[:2] in shapes)
           and (ns is None or p[2] in ns)]
    return sorted(pts, key=lambda p: (p[2], pts.index(p)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="append each point's JSON line to this file")
    ap.add_argument("--budget", type=float, default=float("inf"),
                    help="seconds; points not started by then are dropped")
    ap.add_argument("--table", metavar="JSONL", default=None,
                    help="print the routing regions of a finished sweep "
                         "(no card needed) and exit")
    ap.add_argument("--shapes", nargs="+", default=None, metavar="C,K",
                    help="sweep only these (C, K) of the grid")
    ap.add_argument("--ns", nargs="+", type=int, default=None, metavar="N",
                    help="sweep only these N of the grid")
    args = ap.parse_args(argv)
    if args.table:
        return table_main(args.table)
    if not torch.cuda.is_available():
        print("engine_sweep: no CUDA device; the sweep times the card",
              file=sys.stderr)
        return 2
    logging.getLogger("proxmin").setLevel(logging.ERROR)
    from proxmin_tpu_torch import nmf as tnmf
    from proxmin_tpu_torch import operators as top
    from proxmin_tpu_torch.ops import _build

    t_start = time.perf_counter()
    info = card()
    print(f"engine_sweep: {torch.cuda.get_device_name(0)}; nvidia-smi "
          f"{info}; torch {torch.__version__}", flush=True)
    _build.build_kernels()
    print(f"engine_sweep: kernels built in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    out = open(args.out, "a") if args.out else None
    dropped = [{"C": c, "K": k, "N": n, "why": "left out (DROP)"}
               for c, k, n in DROP]

    def emit(row):
        row["card"] = info
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    shapes = (None if args.shapes is None else
              {tuple(int(v) for v in s.split(",")) for s in args.shapes})
    n_points = 0
    for C, K, N in grid(shapes, args.ns):
        if time.perf_counter() - t_start > args.budget:
            dropped += [{"C": C, "K": K, "N": N, "why": "budget"}]
            continue
        t0 = time.perf_counter()
        problem = cs.route_problem(C, K, N)
        setup = time.perf_counter() - t0
        for path in cs.ROUTE_PATHS:
            row = point(tnmf, top, problem, path)
            row["setup_s"] = setup
            emit(row)
            n_points += 1
        del problem
        torch.cuda.empty_cache()
    print(json.dumps({"points": n_points, "dropped": dropped,
                      "seconds": time.perf_counter() - t_start,
                      "card": info}), flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
