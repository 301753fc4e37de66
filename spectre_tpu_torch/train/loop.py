"""Config-driven training (port of spectre_tpu/train/loop.py): one train step
on one device with the augmentation inside it, a prefetch queue onto the
device, a validation pass per epoch, named metric files, best and latest
checkpoints, exact resume, and a save on SIGTERM/SIGINT.

The multi-host, mesh, FSDP and tensor-parallel parts of the JAX loop are not
ported (ROADMAP.md, queue A12). The block-route registration has no
counterpart, as each mix derives its block tables from its own buffers; the
config's ``mix_routed`` (with ``mix_routed_impl``, default ``"mxu"``) routes
the mix backward through its Clos route, as the JAX loop does, read after
the restore (``ops.register_mix_routes``).
"""

from __future__ import annotations

import itertools
import signal
import time
from collections.abc import Callable
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from spectre_tpu_torch.data import (
    DATASET_STATS,
    BatchIterator,
    load_dataset,
    make_eval_transform,
    make_train_augment,
    prefetch_to_device,
    synthetic_dataset,
)
from spectre_tpu_torch.models import build_model
from spectre_tpu_torch.ops import clear_mix_routes, register_mix_routes
from spectre_tpu_torch.train.checkpoint import CheckpointManager
from spectre_tpu_torch.train.optim import make_optimizer
from spectre_tpu_torch.train.state import TrainState, create_train_state, param_count
from spectre_tpu_torch.train.step import make_eval_step, make_train_step
from spectre_tpu_torch.utils import MetricsWriter, experiment_name


@dataclass
class TrainResult:
    state: TrainState
    best_val_accuracy: float
    last_val_accuracy: float
    train_losses: list[float]  # mean train loss of each epoch this call finished
    steps_per_sec: float       # of the steps this call ran
    images_per_sec: float
    logdir: str


def dataset_stats(name: str) -> tuple[tuple, tuple]:
    return DATASET_STATS.get(name, ((0.5,), (0.5,)))


def load_sized_dataset(config: SimpleNamespace, split: str,
                       synthetic: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """The configured dataset at the model's input size, shared by training
    and evaluation. ``synthetic=True`` is hermetic: it does not search the
    disk at all (a missing ``data_dir`` would still fall through to
    ``$SPECTRE_DATA_DIR`` and ``./data`` and train on real data)."""
    dataset = getattr(config, "dataset", "mnist")
    if synthetic:
        x, y = synthetic_dataset(dataset, split)
    else:
        x, y = load_dataset(dataset, split, data_dir=getattr(config, "data_dir", None))
    size = int(config.img_size)
    if x.shape[-2:] != (size, size):
        x = F.interpolate(torch.from_numpy(x), size=(size, size), mode="bilinear",
                          antialias=True).numpy()
    return x, y


def default_augment(dataset: str, channels: int) -> Callable:
    """The training recipe of ``dataset``: MNIST is a rotation by up to 15
    degrees only; anything else takes the full CIFAR-100 pipeline, with the
    colour jitter only for 3 channels."""
    mean, std = dataset_stats(dataset)
    if dataset == "mnist":
        return make_train_augment(mean, std, hflip=False, jitter=False, grayscale_p=0.0,
                                  degrees=15.0, blur_p=0.0, erasing_p=0.0)
    return make_train_augment(mean, std, jitter=(channels == 3))


def create_trainer(config: SimpleNamespace, device: torch.device | str,
                   steps_per_epoch: int) -> TrainState:
    """The configured model in train mode with its optimizer, schedule and
    generator, all seeded from ``config.random_seed``."""
    model = build_model(config, device, train=True)
    optimizer, scheduler = make_optimizer(config, model.parameters(), steps_per_epoch)
    return create_train_state(model, optimizer, scheduler,
                              seed=int(getattr(config, "random_seed", 42)))


def set_mix_routes(model: torch.nn.Module, config: SimpleNamespace) -> int:
    """Route the folded mixes' backward through their Clos route tables when
    ``config.mix_routed`` is set (``config.mix_routed_impl``, default "mxu"),
    from the live (restored) permutation buffers; it takes precedence over
    the block tables of ``mix_block``. Otherwise clear any route. Returns
    the number of mixes routed. Call it after a restore."""
    if getattr(config, "mix_routed", False):
        return register_mix_routes(model, impl=getattr(config, "mix_routed_impl", "mxu"))
    clear_mix_routes(model)
    return 0


def build_step(config: SimpleNamespace, device: torch.device | str,
               steps_per_epoch: int = 16) -> tuple[TrainState, Callable]:
    """The configured trainer's state and train step as the loop runs them,
    for the bench and the profiler: the dataset's augmentation inside the
    step, the config's accumulation and clipping, the mix routes as the
    config asks."""
    state = create_trainer(config, device, steps_per_epoch)
    set_mix_routes(state.model, config)
    step = make_train_step(default_augment(config.dataset, config.in_channels),
                           grad_accum_steps=int(getattr(config, "grad_accum_steps", 1)),
                           grad_clip_norm=getattr(config, "grad_clip_norm", None))
    return state, step


def evaluate_state(state: TrainState, eval_step: Callable, transform: Callable,
                   batches: BatchIterator, device: torch.device) -> tuple[float, float, int]:
    """(mean loss, accuracy, examples) over ``batches`` in eval mode; the
    sums stay on the device until one read at the end."""
    was_training = state.model.training
    state.model.eval()
    sums = None
    for batch in prefetch_to_device(batches, device):
        out = eval_step(transform(batch["image"]), batch["label"], batch["mask"])
        sums = out if sums is None else {k: sums[k] + v for k, v in out.items()}
    state.model.train(was_training)
    if sums is None:
        return 0.0, 0.0, 0
    count = float(sums["count"])
    return (float(sums["loss_sum"]) / max(count, 1.0), float(sums["correct"]) / max(count, 1.0),
            int(count))


def train_from_config(config: SimpleNamespace, *, device: torch.device | str = "cuda",
                      max_steps: int | None = None, synthetic: bool = False,
                      resume: bool = False, write_metrics: bool = True,
                      checkpoint: bool = True,
                      augment_fn: Callable | None = None) -> TrainResult:
    """Train the configured model end to end. ``max_steps`` caps the total
    number of steps (the epoch in which the cap falls still runs its
    validation pass and its checkpoint); ``synthetic`` forces the hermetic
    synthetic dataset; ``resume`` continues from the latest checkpoint under
    ``<checkpoint_dir>/<experiment name>/ckpt``; ``augment_fn(generator,
    images)`` replaces the dataset's recipe."""
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

    augment = augment_fn if augment_fn is not None else default_augment(dataset,
                                                                       train_x.shape[1])
    eval_transform = make_eval_transform(*dataset_stats(dataset))
    # the augmentation runs inside the step: raw pixels cross to the device
    train_step = make_train_step(
        augment_fn=augment, grad_accum_steps=int(getattr(config, "grad_accum_steps", 1)),
        grad_clip_norm=getattr(config, "grad_clip_norm", None))
    eval_step = make_eval_step(model)

    logdir = f"{getattr(config, 'checkpoint_dir', 'runs')}/{experiment_name(config)}"
    writer = MetricsWriter(logdir) if write_metrics else None
    ckpt = CheckpointManager(f"{logdir}/ckpt",
                             max_to_keep=getattr(config, "keep_checkpoints", 3)) \
        if checkpoint else None
    if resume and ckpt and ckpt.latest_step is not None:
        ckpt.restore(state)
        print(f"resumed from step {state.step}", flush=True)
    routed = set_mix_routes(model, config)
    if routed:
        print(f"mix routes registered: {routed}", flush=True)
    print(f"model={getattr(config, 'model', '?')} params={param_count(model):,} "
          f"device={device} batch={batch_size} steps/epoch={steps_per_epoch}", flush=True)

    # on SIGTERM/SIGINT: finish the current step, checkpoint the whole state,
    # stop; a resumed run picks up exactly where this one stopped
    preempted = {"flag": False}

    def on_signal(signum, frame):
        preempted["flag"] = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:  # not the main thread
            pass

    best_val = last_val = -1.0
    train_losses: list[float] = []
    # a resumed run continues the epoch count from the restored step (running
    # all of config.epochs again would train past the end of the cosine
    # schedule): fast-forward the shuffle stream past the finished epochs and
    # skip the interrupted epoch's trained prefix
    start_step = state.step
    start_epoch = state.step // steps_per_epoch
    skip_batches = state.step % steps_per_epoch
    for _ in range(start_epoch):
        train_iter.skip_epoch()
    epochs = int(config.epochs)
    log_every = int(getattr(config, "log_every", 50))
    prefetch = int(getattr(config, "prefetch_depth", 2))
    val_batch = int(getattr(config, "val_batch_size", batch_size))
    images_seen = 0
    done = max_steps is not None and state.step >= max_steps
    t0 = time.perf_counter()

    for epoch in range(start_epoch, epochs):
        if done:
            break
        epoch_metrics = []
        src = iter(train_iter)
        if skip_batches:
            src = itertools.islice(src, skip_batches, None)
            skip_batches = 0
        for batch in prefetch_to_device(src, device, prefetch=prefetch):
            metrics = train_step(state, batch["image"], batch["label"])
            epoch_metrics.append(metrics)
            images_seen += batch_size
            if writer and state.step % log_every == 0:
                writer.scalar("Loss/Train", metrics["loss"], state.step)
                writer.scalar("Accuracy/Train", metrics["accuracy"], state.step)
            if preempted["flag"] or (max_steps is not None and state.step >= max_steps):
                done = True
                break

        if preempted["flag"]:
            # no validation pass: the grace window after a SIGTERM belongs to
            # the save below, which a SIGKILL during an eval sweep would lose
            break

        # one host sync per epoch
        tr_loss = float(torch.stack([m["loss"] for m in epoch_metrics]).mean())
        tr_acc = float(torch.stack([m["accuracy"] for m in epoch_metrics]).mean())
        train_losses.append(tr_loss)
        val_loss, last_val, _ = evaluate_state(
            state, eval_step, eval_transform,
            BatchIterator(val_x, val_y, val_batch, shuffle=False), device)
        best_val = max(best_val, last_val)

        if writer:
            writer.scalar("Loss/Validation", val_loss, state.step)
            writer.scalar("Accuracy/Validation", last_val, state.step)
            elapsed = time.perf_counter() - t0
            writer.scalar("Perf/steps_per_sec", (state.step - start_step) / elapsed, state.step)
            writer.scalar("Perf/images_per_sec_per_chip", images_seen / elapsed, state.step)
            writer.flush()
        if ckpt:
            ckpt.save(state, {"accuracy": last_val, "loss": val_loss})
        print(f"epoch {epoch + 1}/{epochs} step {state.step} train loss {tr_loss:.4f} "
              f"acc {tr_acc:.4f} | val loss {val_loss:.4f} acc {last_val:.4f}", flush=True)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    if writer:
        writer.scalar("Training time", elapsed, state.step)
        writer.close()
    if ckpt:
        if preempted["flag"]:
            ckpt.save(state, {"accuracy": last_val})
            print(f"preempted at step {state.step}: state checkpointed, resume with --resume",
                  flush=True)
        ckpt.wait()
        ckpt.close()
    for sig, handler in prev_handlers.items():
        signal.signal(sig, handler)
    model.train()
    return TrainResult(state, best_val, last_val, train_losses,
                       (state.step - start_step) / elapsed if elapsed > 0 else 0.0,
                       images_seen / elapsed if elapsed > 0 else 0.0, logdir)
