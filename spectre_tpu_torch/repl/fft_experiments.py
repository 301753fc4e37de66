"""FFT / Hadamard feature visualisation study (port of
spectre_tpu/repl/fft_experiments.py).

Writes to ``--out``: (a) the rFFT of a sine mix and its top-5 energy bins;
(b) the token-space FFT of an image patch-embedded with an all-ones
projection; (c) the Walsh-Hadamard transform of the image's rows
(``ops.fwht``: kernel 6 on a card); (d) the shifted-sigmoid threshold curve;
and prints (e) the rfft2 shape checks. matplotlib is imported where the
figures are drawn.

    python -m spectre_tpu_torch.repl.fft_experiments [--out plots] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from spectre_tpu_torch.ops import fwht, next_pow2, rfft_real
from spectre_tpu_torch.utils import cli_device


def _pyplot():
    try:
        import matplotlib
    except ImportError:
        raise ImportError("the figures need matplotlib, which is not installed") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _test_image(size: int = 64) -> np.ndarray:
    """Deterministic synthetic picture: gradients, a disc and seeded noise."""
    y, x = np.mgrid[0:size, 0:size] / size
    img = 0.5 + 0.3 * np.sin(8 * np.pi * x) * np.cos(6 * np.pi * y)
    img += 0.2 * (((x - 0.5) ** 2 + (y - 0.5) ** 2) < 0.1)
    rng = np.random.default_rng(0)
    img += 0.05 * rng.standard_normal((size, size))
    return np.clip(img, 0, 1).astype(np.float32)


def sine_fft(out: str, device: torch.device) -> list[int]:
    t = np.linspace(0, 1, 512, endpoint=False).astype(np.float32)
    sig = (np.sin(2 * np.pi * 5 * t) + 0.5 * np.sin(2 * np.pi * 23 * t)
           + 0.25 * np.sin(2 * np.pi * 57 * t))
    spec = torch.fft.rfft(torch.from_numpy(sig).to(device)).abs().cpu().numpy()
    top = sorted(np.argsort(spec)[::-1][:5].tolist())
    print(f"top-5 energy bins: {top} (expected around 5, 23, 57)", flush=True)
    plt = _pyplot()
    fig, ax = plt.subplots(2, 1, figsize=(8, 5))
    ax[0].plot(t, sig)
    ax[0].set_title("signal")
    ax[1].stem(spec)
    ax[1].set_title("|rfft|")
    fig.tight_layout()
    fig.savefig(f"{out}/sine_fft.png", dpi=100)
    plt.close(fig)
    return top


def token_space_fft(out: str, device: torch.device) -> None:
    """Patch-embed an image with an all-ones projection and take the rFFT of
    the token sequence."""
    img = _test_image(64)
    P = 8
    patches = img.reshape(8, P, 8, P).transpose(0, 2, 1, 3).reshape(64, P * P)
    tokens = patches.sum(-1)  # the all-ones projection
    spec = rfft_real(torch.from_numpy(tokens).to(device)).cpu().numpy()
    plt = _pyplot()
    fig, ax = plt.subplots(1, 3, figsize=(12, 4))
    ax[0].imshow(img, cmap="gray")
    ax[0].set_title("image")
    ax[1].plot(tokens)
    ax[1].set_title("token sequence (1.0-proj)")
    ax[2].plot(spec)
    ax[2].set_title("Re rfft(tokens)")
    fig.tight_layout()
    fig.savefig(f"{out}/token_example.png", dpi=100)
    plt.close(fig)


def hadamard_image(out: str, device: torch.device) -> None:
    img = _test_image(64)
    row_len = next_pow2(img.shape[-1])
    x = torch.from_numpy(np.pad(img, ((0, 0), (0, row_len - img.shape[-1])))).to(device)
    h = fwht(x).cpu().numpy()
    plt = _pyplot()
    fig, ax = plt.subplots(1, 2, figsize=(9, 4))
    ax[0].imshow(img, cmap="gray")
    ax[0].set_title("image")
    ax[1].imshow(np.log1p(np.abs(h)), cmap="magma")
    ax[1].set_title("log1p|FWHT(rows)|")
    fig.tight_layout()
    fig.savefig(f"{out}/hadamard_image.png", dpi=100)
    plt.close(fig)


def shifted_sigmoid(out: str) -> None:
    """The sharp learned-threshold gate curve (``LearnedSigmoid``)."""
    x = np.linspace(-2, 2, 500)
    t, sharp = 0.5, 5000.0
    y = 1.0 / (1.0 + np.exp((x + t) / np.sqrt(t * t / sharp)))
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.plot(x, y)
    ax.set_title(f"shifted sigmoid (t={t}, sharpness={sharp})")
    fig.tight_layout()
    fig.savefig(f"{out}/shifted_sigmoid.png", dpi=100)
    plt.close(fig)


def rfft2_shapes(device: torch.device) -> None:
    x = torch.zeros(2, 3, 16, 16, device=device)
    print("rfft2 shape checks:")
    print("  rfft2(16x16) ->", tuple(torch.fft.rfft2(x).shape), "(last dim 16//2+1)")
    print("  fft2(16x16)  ->", tuple(torch.fft.fft2(x).shape), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="plots")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = cli_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    sine_fft(args.out, device)
    token_space_fft(args.out, device)
    hadamard_image(args.out, device)
    shifted_sigmoid(args.out)
    rfft2_shapes(device)
    print(f"figures in {args.out}/", flush=True)


if __name__ == "__main__":
    main()
