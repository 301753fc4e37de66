"""Wavelet (DWT) feature visualisation (port of
spectre_tpu/repl/dwt_experiments.py).

A multi-level 2-D Haar decomposition of the test image with the port's
``ops/dwt.py``: the approximation and the horizontal, vertical and diagonal
subbands of each level, the level-J approximation beside the centred FFT
magnitude, and the perfect-reconstruction error of the inverse (the
property the DWT mixers rely on). matplotlib is imported where the figures
are drawn.

    python -m spectre_tpu_torch.repl.dwt_experiments [--out plots] [--levels 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from spectre_tpu_torch.ops import haar_dwt2d, haar_dwt2d_multilevel, haar_idwt2d
from spectre_tpu_torch.repl.fft_experiments import _pyplot, _test_image
from spectre_tpu_torch.utils import cli_device


def reconstruction_error(img: torch.Tensor, levels: int) -> float:
    """max |idwt(dwt(img)) - img| over ``levels`` levels."""
    cur, stack = img, []
    for _ in range(levels):
        cur, h = haar_dwt2d(cur)
        stack.append(h)
    for h in reversed(stack):
        cur = haar_idwt2d(cur, h)
    return float((cur - img).abs().max())


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="plots")
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = cli_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    img_np = _test_image(64)
    img = torch.from_numpy(img_np).to(device)
    ll, highs = haar_dwt2d_multilevel(img, args.levels)

    plt = _pyplot()
    fig, axes = plt.subplots(args.levels, 4, figsize=(12, 3 * args.levels), squeeze=False)
    approx = img
    for lvl in range(args.levels):
        lh, hl, hh = highs[lvl]
        approx, _ = haar_dwt2d(approx)
        for col, (name, band) in enumerate([("Approx", approx), ("H", lh), ("V", hl),
                                            ("D", hh)]):
            ax = axes[lvl][col]
            ax.imshow(band.cpu().numpy(), cmap="gray")
            ax.set_title(f"L{lvl + 1} {name}")
            ax.axis("off")
    fig.tight_layout()
    fig.savefig(f"{args.out}/dwt_subbands.png", dpi=100)
    plt.close(fig)

    spec = np.fft.fftshift(np.abs(np.fft.fft2(img_np)))
    fig, ax = plt.subplots(1, 3, figsize=(12, 4))
    ax[0].imshow(img_np, cmap="gray")
    ax[0].set_title("image")
    ax[1].imshow(ll.cpu().numpy(), cmap="gray")
    ax[1].set_title(f"DWT approx (J={args.levels})")
    ax[2].imshow(np.log1p(spec), cmap="magma")
    ax[2].set_title("log1p|FFT| (shifted)")
    for a in ax:
        a.axis("off")
    fig.tight_layout()
    fig.savefig(f"{args.out}/dwt_vs_fft.png", dpi=100)
    plt.close(fig)

    err = reconstruction_error(img, args.levels)
    print(f"perfect reconstruction max|err| = {err:.2e}", flush=True)
    print(f"figures in {args.out}/", flush=True)
    return err


if __name__ == "__main__":
    main()
