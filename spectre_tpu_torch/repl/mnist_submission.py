"""MNIST Kaggle pipeline (port of spectre_tpu/repl/mnist_submission.py):
train, predict the unlabelled ``submission`` split, write the Kaggle CSV
and a 4 x 8 grid of predictions.

    python -m spectre_tpu_torch.repl.mnist_submission \\
        [--config spectre_tpu_torch/configs/spectre_vit_mnist.py] [--data-dir data] \\
        [--steps N] [--synthetic] [--out submission.csv] [--grid plots/mnist_predictions.png] \\
        [--device cuda] [--set key=value ...]

``write_submission`` trains and writes the CSV only; the grid is drawn by
``main`` with matplotlib, imported where it draws (it refuses by name
without it). The prediction is the eval forward through the port's kernels
on the card (the CPU runs their plain versions with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import numpy as np
import torch

from spectre_tpu_torch.configs import CONFIG_DIR, apply_overrides, parse_config
from spectre_tpu_torch.data import DATASET_STATS, BatchIterator, make_eval_transform
from spectre_tpu_torch.data.pipeline import prefetch_to_device
from spectre_tpu_torch.train import train_from_config
from spectre_tpu_torch.train.loop import load_sized_dataset
from spectre_tpu_torch.utils import cli_device

MNIST_CONFIG = os.path.join(CONFIG_DIR, "spectre_vit_mnist.py")


@dataclass
class Submission:
    images: np.ndarray      # the submission split, [N, 1, 28, 28]
    logits: torch.Tensor    # [N, classes], float32, on the host
    labels: np.ndarray      # argmax of the logits, [N]
    model: torch.nn.Module  # the trained model, in eval mode


def write_submission(config, out: str, *, device: torch.device | str = "cuda",
                     steps: int | None = None, synthetic: bool = False) -> Submission:
    """Train ``config``, predict its ``submission`` split (the unlabelled Kaggle
    test.csv, or the synthetic set) and write ``ImageId,Label`` rows to
    ``out``."""
    device = torch.device(device)
    result = train_from_config(config, device=device, max_steps=steps, synthetic=synthetic,
                               checkpoint=False, write_metrics=False)
    model = result.state.model.eval()
    # "submission" is the unlabelled Kaggle test.csv; the labelled "test"
    # split is a holdout of train.csv used for validation (data/datasets.py)
    test_x, _ = load_sized_dataset(config, "submission", synthetic=synthetic)
    transform = make_eval_transform(*DATASET_STATS["mnist"])
    batches = BatchIterator(test_x, np.zeros(len(test_x), np.int32),
                            int(getattr(config, "val_batch_size", 256)), shuffle=False)
    logits = []
    with torch.no_grad():
        for batch in prefetch_to_device(batches, device):
            logits.append(model(transform(batch["image"]))[: int(batch["valid"])])
    logits = torch.cat(logits).float().cpu()
    labels = logits.argmax(-1).numpy()
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write("ImageId,Label\n")
        for i, label in enumerate(labels, start=1):
            f.write(f"{i},{int(label)}\n")
    print(f"wrote {out} ({len(labels)} rows)", flush=True)
    return Submission(test_x, logits, labels, model)


def draw_grid(images: np.ndarray, labels: np.ndarray, path: str) -> None:
    """The first 32 images with their predicted labels, 4 x 8."""
    try:
        import matplotlib
    except ImportError:
        raise ImportError("the prediction grid needs matplotlib, which is not installed; "
                          "write_submission writes the CSV without it") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, axes = plt.subplots(4, 8, figsize=(12, 6))
    for i, ax in enumerate(axes.ravel()[: len(images)]):
        ax.imshow(images[i, 0], cmap="gray")
        ax.set_title(str(int(labels[i])), fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    print(f"wrote {path}", flush=True)


def main(argv=None) -> Submission:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=MNIST_CONFIG)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", default="submission.csv")
    p.add_argument("--grid", default="plots/mnist_predictions.png")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--set", nargs="*", default=[])
    args = p.parse_args(argv)
    device = cli_device(args.device)
    config = apply_overrides(parse_config(args.config), args.set)
    if args.data_dir:
        config.data_dir = args.data_dir
    sub = write_submission(config, args.out, device=device, steps=args.steps,
                           synthetic=args.synthetic)
    draw_grid(sub.images, sub.labels, args.grid)
    return sub


if __name__ == "__main__":
    main()
