"""Dataset spectrum analysis (port of spectre_tpu/repl/dataset_spectre.py).

The grayscale 2-D FFT of dataset images, reduced to the mean magnitude by
frequency radius, and a histogram of the spectrum's magnitudes, in
``<out>/dataset_spectrum.png``; prints the share of the energy below radius
8. With ``--data-root`` it reads nuScenes ``samples/CAM_FRONT/*.jpg`` (with
cv2) or, if there are none, the CIFAR-100 files under that root; without one
it runs on the synthetic CIFAR-100 set. matplotlib is imported where the
figure is drawn.

    python -m spectre_tpu_torch.repl.dataset_spectre [--data-root <dir>] [--limit 32]
        [--out plots] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from spectre_tpu_torch.data import load_dataset, synthetic_dataset
from spectre_tpu_torch.repl.fft_experiments import _pyplot
from spectre_tpu_torch.utils import cli_device


def _load_images(data_root: str | None, limit: int) -> list[np.ndarray]:
    if data_root:
        paths = sorted(glob.glob(os.path.join(data_root, "samples", "CAM_FRONT", "*.jpg")))
        if paths:
            import cv2

            return [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2GRAY) / 255.0
                    for p in paths[:limit]]
        x, _ = load_dataset("cifar100", "train", data_dir=data_root)
    else:
        x, _ = synthetic_dataset("cifar100", "train")
    return [img.mean(0) for img in x[:limit]]  # grayscale


def radial_profile(spec: np.ndarray) -> np.ndarray:
    """Mean of ``spec`` over each integer radius from the centre."""
    h, w = spec.shape
    y, x = np.mgrid[0:h, 0:w]
    r = np.sqrt((y - h // 2) ** 2 + (x - w // 2) ** 2).astype(np.int32)
    mags = np.zeros(r.max() + 1)
    np.add.at(mags, r.ravel(), spec.ravel())
    return mags / np.maximum(np.bincount(r.ravel()), 1)


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-root", default=None)
    p.add_argument("--limit", type=int, default=32)
    p.add_argument("--out", default="plots")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = cli_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    images = _load_images(args.data_root, args.limit)
    profiles, all_mags = [], []
    for img in images:
        spec = torch.fft.fft2(torch.as_tensor(img, dtype=torch.float32, device=device))
        spec = np.fft.fftshift(spec.abs().cpu().numpy())
        profiles.append(radial_profile(spec))
        all_mags.append(spec.ravel())
    mean_profile = np.zeros(max(len(pr) for pr in profiles))
    for pr in profiles:
        mean_profile[: len(pr)] += pr
    mean_profile /= len(profiles)

    plt = _pyplot()
    fig, ax = plt.subplots(1, 2, figsize=(11, 4))
    ax[0].semilogy(mean_profile)
    ax[0].set_xlabel("frequency radius")
    ax[0].set_ylabel("mean |FFT|")
    ax[0].set_title(f"radial spectrum, {len(images)} images")
    ax[1].hist(np.log1p(np.concatenate(all_mags)), bins=80)
    ax[1].set_title("log1p|FFT| histogram")
    fig.tight_layout()
    fig.savefig(f"{args.out}/dataset_spectrum.png", dpi=100)
    plt.close(fig)
    share = mean_profile[:8].sum() / mean_profile.sum()
    print(f"analyzed {len(images)} images -> {args.out}/dataset_spectrum.png", flush=True)
    print(f"energy below radius 8: {share * 100:.1f}%", flush=True)
    return share


if __name__ == "__main__":
    main()
