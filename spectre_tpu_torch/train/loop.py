"""Config-driven training (port of spectre_tpu/train/loop.py): epochs of
train steps on one device, a validation pass per epoch, one host sync per
epoch for the metrics.

Not ported yet (ROADMAP.md, queue A7): device-side augmentation, checkpoints
and resume, the save on SIGTERM, metric files, dataset files. Inputs are
normalised with the dataset's statistics on the device, for training and
validation alike.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from spectre_tpu_torch.data import DATASET_STATS, BatchIterator, synthetic_dataset
from spectre_tpu_torch.models import build_model
from spectre_tpu_torch.train.optim import make_optimizer
from spectre_tpu_torch.train.state import TrainState, create_train_state, param_count
from spectre_tpu_torch.train.step import make_eval_step, make_train_step


@dataclass
class TrainResult:
    state: TrainState
    best_val_accuracy: float
    last_val_accuracy: float
    train_losses: list[float]  # mean train loss of each epoch run
    steps_per_sec: float
    images_per_sec: float


def load_sized_dataset(config: SimpleNamespace, split: str,
                       synthetic: bool) -> tuple[np.ndarray, np.ndarray]:
    """The configured dataset at the model's input size."""
    if not synthetic:
        raise NotImplementedError(
            "only the synthetic datasets are ported (ROADMAP.md, queue A7): pass "
            "synthetic=True (--synthetic)")
    x, y = synthetic_dataset(getattr(config, "dataset", "mnist"), split)
    size = int(config.img_size)
    if x.shape[-2:] != (size, size):
        x = F.interpolate(torch.from_numpy(x), size=(size, size), mode="bilinear",
                          antialias=True).numpy()
    return x, y


def make_normalize(dataset: str, device: torch.device):
    mean, std = DATASET_STATS.get(dataset, ((0.5,), (0.5,)))
    m = torch.tensor(mean, device=device).reshape(1, -1, 1, 1)
    s = torch.tensor(std, device=device).reshape(1, -1, 1, 1)
    return lambda x: (x - m) / s


def create_trainer(config: SimpleNamespace, device: torch.device | str,
                   steps_per_epoch: int) -> TrainState:
    """The configured model in train mode with its optimizer, schedule and
    dropout generator, all seeded from ``config.random_seed``."""
    model = build_model(config, device, train=True)
    optimizer, scheduler = make_optimizer(config, model.parameters(), steps_per_epoch)
    return create_train_state(model, optimizer, scheduler,
                              seed=int(getattr(config, "random_seed", 42)))


def train_from_config(config: SimpleNamespace, *, device: torch.device | str = "cuda",
                      max_steps: int | None = None, synthetic: bool = False) -> TrainResult:
    """Train the configured model. ``max_steps`` caps the total number of
    steps; the epoch in which the cap falls still runs its validation pass."""
    device = torch.device(device)
    dataset = getattr(config, "dataset", "mnist")
    train_x, train_y = load_sized_dataset(config, "train", synthetic)
    val_x, val_y = load_sized_dataset(config, "test", synthetic)
    batch_size = int(config.batch_size)
    seed = int(getattr(config, "random_seed", 42))
    train_iter = BatchIterator(train_x, train_y, batch_size, shuffle=True, seed=seed)
    steps_per_epoch = max(1, len(train_iter))
    state = create_trainer(config, device, steps_per_epoch)
    model = state.model
    train_step = make_train_step(
        grad_accum_steps=int(getattr(config, "grad_accum_steps", 1)),
        grad_clip_norm=getattr(config, "grad_clip_norm", None))
    eval_step = make_eval_step(model)
    normalize = make_normalize(dataset, device)
    val_batch = int(getattr(config, "val_batch_size", batch_size))
    print(f"model={getattr(config, 'model', '?')} params={param_count(model):,} "
          f"device={device} batch={batch_size} steps/epoch={steps_per_epoch}", flush=True)

    def staged(batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    best_val = last_val = -1.0
    train_losses: list[float] = []
    images_seen = 0
    epochs = int(config.epochs)
    t0 = time.perf_counter()
    for epoch in range(epochs):
        model.train()
        epoch_metrics = []
        for batch in map(staged, train_iter):
            epoch_metrics.append(train_step(state, normalize(batch["image"]), batch["label"]))
            images_seen += batch_size
            if max_steps is not None and state.step >= max_steps:
                break
        # one host sync per epoch
        tr_loss = float(torch.stack([m["loss"] for m in epoch_metrics]).mean())
        tr_acc = float(torch.stack([m["accuracy"] for m in epoch_metrics]).mean())
        train_losses.append(tr_loss)

        model.eval()
        sums = None
        for batch in map(staged, BatchIterator(val_x, val_y, val_batch, shuffle=False)):
            out = eval_step(normalize(batch["image"]), batch["label"], batch["mask"])
            sums = out if sums is None else {k: sums[k] + v for k, v in out.items()}
        count = max(float(sums["count"]), 1.0)
        val_loss, last_val = float(sums["loss_sum"]) / count, float(sums["correct"]) / count
        best_val = max(best_val, last_val)
        print(f"epoch {epoch + 1}/{epochs} step {state.step} train loss {tr_loss:.4f} "
              f"acc {tr_acc:.4f} | val loss {val_loss:.4f} acc {last_val:.4f}", flush=True)
        if max_steps is not None and state.step >= max_steps:
            break
    model.train()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    return TrainResult(state, best_val, last_val, train_losses,
                       state.step / elapsed, images_seen / elapsed)
