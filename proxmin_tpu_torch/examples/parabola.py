"""Constrained 2-D quadratic: every solver on one tiny problem.

The port of ``examples/parabola.py``. Minimizes f(x) = ||x - (1, 0.5)||^2 / 2
under a circle constraint (the radius 0.5 disk) or a half-plane, with every
driver of the port: PGM, FISTA, PGM with backtracking, the six AdaProx
schemes, ADMM (two variants) and SDMM with two constraints at once. The
constrained optimum on the disk is r c / ||c||, so every solver is checked
against the analytic answer.

Run:  python -m proxmin_tpu_torch.examples.parabola [--cpu] [--plot]
"""

import sys

import numpy as np
import torch

import proxmin_tpu_torch as ptt
from proxmin_tpu_torch import utils
from proxmin_tpu_torch.examples import example_device

CENTER = np.array([1.0, 0.5])
RADIUS = 0.5
X0 = np.array([-1.0, -1.0])
DISK_OPT = RADIUS * CENTER / np.linalg.norm(CENTER)
# every solve stops at e_rel 1e-8 from a start 1.8 away: its distance to
# the analytic optimum is held to this (the JAX script prints the same
# distances, 6e-9 to 3.5e-7, and backtracking's 2e-5)
OPT_ATOL = 1e-4


def main(cpu=False, plot=False):
    dev = example_device(cpu)
    center = torch.tensor(CENTER, device=dev)

    def f(x):
        return 0.5 * torch.sum((x - center) ** 2)

    def grad_f(x):
        return x - center

    def prox_circle(x, step, r=RADIUS):
        """Projection onto the disk of radius r."""
        nrm = torch.sqrt(torch.sum(x ** 2))
        return torch.where(nrm > r, x * (r / nrm), x)

    def prox_line(x, step, b=0.15):
        """Projection onto the half-plane x_1 >= b."""
        return torch.stack([x[0], torch.clamp_min(x[1], b)])

    def prox_f(v, step):
        """Proximal operator of f itself (for the ADMM family)."""
        return (v + step * center) / (1.0 + step)

    traces, results = {}, {}

    def run(label, fn):
        tb = utils.Traceback()
        res = fn(tb)
        x = res.x.cpu().numpy()
        err = float(np.linalg.norm(x - DISK_OPT))
        traces[label] = [t[0] for t in tb.trace]
        results[label] = {"x": x.tolist(), "err": err,
                          "iters": int(res.iterations)}
        print(f"{label:18s} x = ({x[0]: .5f}, {x[1]: .5f})  "
              f"|x - x*| = {err:.2e}  iters = {res.iterations}")
        assert err < OPT_ATOL, f"{label} missed the optimum"

    def x0():
        return torch.tensor(X0, device=dev)

    run("PGM", lambda cb: ptt.pgm(
        x0(), grad_f, 0.5, prox=prox_circle, e_rel=1e-8, max_iter=1000,
        callback=cb))
    run("FISTA", lambda cb: ptt.pgm(
        x0(), grad_f, 0.5, prox=prox_circle, accelerated=True,
        e_rel=1e-8, max_iter=1000, callback=cb))
    run("PGM backtrack", lambda cb: ptt.pgm(
        x0(), grad_f, 10.0, prox=prox_circle, backtracking=True, f=f,
        e_rel=1e-8, max_iter=1000, callback=cb))

    for scheme in ["adam", "nadam", "amsgrad", "padam", "adamx", "radam"]:
        run(f"AdaProx {scheme}", lambda cb, s=scheme: ptt.adaprox(
            x0(), grad_f, 0.1, prox=prox_circle, scheme=s,
            e_rel=1e-8, max_iter=3000, callback=cb))

    run("ADMM", lambda cb: ptt.admm(
        x0(), prox_f, 0.5, prox_g=prox_circle,
        e_rel=1e-8, max_iter=3000, callback=cb))
    run("ADMM direct", lambda cb: ptt.admm(
        x0(), lambda v, s: prox_circle(prox_f(v, s), s), 0.5,
        e_rel=1e-8, e_abs=1e-8, max_iter=3000, callback=cb))
    run("SDMM (M=2)", lambda cb: ptt.sdmm(
        x0(), prox_f, 0.5, proxs_g=[prox_circle, prox_line],
        e_rel=1e-8, max_iter=3000, callback=cb))

    if plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib not available; skipping plot")
            return results
        fig, ax = plt.subplots(figsize=(6, 6))
        theta = np.linspace(0, 2 * np.pi, 200)
        ax.plot(RADIUS * np.cos(theta), RADIUS * np.sin(theta), "k--",
                lw=0.8)
        for label, tr in traces.items():
            xy = np.stack(tr)
            ax.plot(xy[:, 0], xy[:, 1], ".-", ms=2, lw=0.6, label=label)
        ax.plot(*CENTER, "k*", ms=12)
        ax.plot(*DISK_OPT, "rx", ms=10)
        ax.legend(fontsize=6)
        ax.set_aspect("equal")
        fig.savefig("parabola_trajectories.png", dpi=150)
        print("wrote parabola_trajectories.png")
    return results


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv, plot="--plot" in sys.argv)
