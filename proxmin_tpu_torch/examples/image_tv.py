"""Anisotropic 2-D total-variation image denoising with SDMM.

The port of ``examples/image_tv.py``. Solves

    min_x  0.5 ||x - y||_F^2 + lam (||D_h x||_1 + ||D_v x||_1)

over an H x W image with two matrix-free constraints at once, the
horizontal and the vertical difference operators, by SDMM. Each operator
is a :class:`~proxmin_tpu_torch.linop.FunctionOperator` acting on the 2-D
tensor (``in_shape=(H, W)``): nothing is flattened or materialized.

Run:  python -m proxmin_tpu_torch.examples.image_tv [H] [--cpu] [--plot]
"""

import sys
import time
from functools import partial

import numpy as np
import torch

from proxmin_tpu_torch import operators, sdmm
from proxmin_tpu_torch.examples import example_device, positional
from proxmin_tpu_torch.linop import FunctionOperator


def dh(x):                       # horizontal differences (H, W-1)
    return x[:, 1:] - x[:, :-1]


def dh_T(v):
    return torch.cat([-v[:, :1], v[:, :-1] - v[:, 1:], v[:, -1:]], dim=1)


def dv(x):                       # vertical differences (H-1, W)
    return x[1:, :] - x[:-1, :]


def dv_T(v):
    return torch.cat([-v[:1, :], v[:-1, :] - v[1:, :], v[-1:, :]], dim=0)


def _prox_quad(x, step, *, y):
    return (x + step * y) / (1.0 + step)


def _prox_l1(z, step, *, lam):
    return operators.prox_soft(z, step, thresh=lam)


def make_image(H, W):
    """Piecewise-constant cartoon: rectangles and a disk."""
    img = np.zeros((H, W), np.float32)
    img[H // 8: H // 2, W // 6: W // 2] = 1.0
    img[5 * H // 8: 7 * H // 8, W // 3: 5 * W // 6] = -0.6
    yy, xx = np.mgrid[:H, :W]
    img[(yy - H // 3) ** 2 + (xx - 2 * W // 3) ** 2 < (H // 6) ** 2] = 0.7
    return img


def main(H=512, cpu=False, plot=False):
    dev = example_device(cpu)
    W = H
    lam = 0.4
    rng = np.random.default_rng(11)

    truth = make_image(H, W)
    y = truth + 0.3 * rng.standard_normal((H, W)).astype(np.float32)
    yt = torch.from_numpy(y).to(dev)

    # lambda_max(D^T D) < 4 per axis analytically
    Dh = FunctionOperator(dh, dh_T, (H, W), dtype=torch.float32,
                          norm_sq=4.0, device=dev)
    Dv = FunctionOperator(dv, dv_T, (H, W), dtype=torch.float32,
                          norm_sq=4.0, device=dev)

    t0 = time.perf_counter()
    res = sdmm(torch.zeros((H, W), dtype=torch.float32, device=dev),
               partial(_prox_quad, y=yt), 0.5,
               proxs_g=[partial(_prox_l1, lam=lam)] * 2,
               Ls=[Dh, Dv], e_rel=1e-4, max_iter=400)
    x = res.x.cpu().numpy()
    dt = time.perf_counter() - t0

    def tv(v):
        return float(np.abs(np.diff(v, axis=0)).sum()
                     + np.abs(np.diff(v, axis=1)).sum())

    rmse_in = float(np.sqrt(np.mean((y - truth) ** 2)))
    rmse_out = float(np.sqrt(np.mean((x - truth) ** 2)))
    print(f"{H}x{W} image  iters={res.iterations}  wall={dt:.2f}s")
    print(f"TV:   noisy {tv(y):10.1f}  ->  denoised {tv(x):10.1f}")
    print(f"RMSE: noisy {rmse_in:10.4f}  ->  denoised {rmse_out:10.4f}")
    assert rmse_out < 0.4 * rmse_in, "denoising failed"

    if plot:
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, (im, title) in zip(axes, [(y, "noisy"), (x, "TV-denoised"),
                                          (truth, "truth")]):
            ax.imshow(im, cmap="gray", vmin=-1, vmax=1.2)
            ax.set_title(title)
            ax.axis("off")
        fig.savefig("image_tv.png", dpi=120, bbox_inches="tight")
        print("wrote image_tv.png")
    return {"H": H, "iters": int(res.iterations), "wall": dt,
            "tv_in": tv(y), "tv_out": tv(x), "rmse_in": rmse_in,
            "rmse_out": rmse_out}


if __name__ == "__main__":
    args = positional(sys.argv[1:])
    main(int(args[0]) if args else 512, cpu="--cpu" in sys.argv,
         plot="--plot" in sys.argv)
