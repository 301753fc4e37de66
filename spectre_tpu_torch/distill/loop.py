"""Distillation training (port of spectre_tpu/distill/loop.py): a frozen DINO
teacher and the SpectreViT student on one device.

Dual views of one raw pixel batch: the teacher's view (``make_teacher_view``:
resized to the teacher's input size and normalised with the teacher's
statistics) and the student's (the trainer's augmentation, inside the step).
The loss is KD at temperature ``distill_temperature`` weighted
``distill_alpha`` plus CE weighted 1 - alpha (``train/step.py``), and the
``Batch Loss/{Train,Dist,CE}`` scalars are fetched from the device in
windows of ``log_every`` steps.

The teacher's view is deterministic and the teacher frozen, so its logits
for a sample never change: by default (``distill_cache_teacher``) one
pass over the training set at start-up (``precompute_teacher_logits``)
fills a [N, classes] float32 table on the device, and each batch takes its
rows by ``batch["index"]``; the hot loop then runs no teacher. A run that
never revisits a sample (``max_steps`` within the first epoch) recomputes
per step instead, unless ``cache_teacher=True`` asks for the table. Both
call the teacher on batches of the same shape, so the two give the same
logits and the same loss sequence, bit for bit.

Per-epoch validation of the student, best and latest checkpoints under
``<checkpoint_dir>/distill_<experiment>/ckpt`` (best on ``accuracy``), an
exact resume (the finished epochs' shuffles and the interrupted epoch's
trained prefix skipped) and a save on SIGTERM/SIGINT follow the train loop
(``train/loop.py``), as do the mix routes (``set_mix_routes``) and the
mesh: under a process group (or with ``fsdp=True``) the student takes the
train loop's layout (DDP, FSDP, tensor parallelism), each data rank loads
its own slice of the training and validation sets and fills the logit
table for its slice alone, the teacher runs whole on every rank, and
metrics come from rank 0.
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

from spectre_tpu_torch.data import (
    BatchIterator,
    center_crop,
    load_dataset,
    make_eval_transform,
    make_train_augment,
    normalize,
    prefetch_to_device,
    resize_bicubic_pil,
    resize_bilinear,
    synthetic_dataset,
)
from spectre_tpu_torch.distill.teacher import DinoClassifier, freeze, load_teacher
from spectre_tpu_torch.models.jax_import import load_flax_variables
from spectre_tpu_torch.models.registry import resolve_dtype
from spectre_tpu_torch.train.checkpoint import CheckpointManager
from spectre_tpu_torch.parallel import DATA_AXIS, axis_size
from spectre_tpu_torch.train.loop import (
    config_mesh,
    create_trainer,
    dataset_stats,
    end_own_group,
    evaluate_state,
    lay_out,
    load_sized_dataset,
    local_batch_size,
    set_mix_routes,
    slice_for_rank,
)
from spectre_tpu_torch.train.state import TrainState, param_count
from spectre_tpu_torch.train.step import make_distill_step, make_eval_step
from spectre_tpu_torch.utils import MetricsWriter, experiment_name

# ImageNet statistics, which DINO teachers were trained with
TEACHER_MEAN = (0.485, 0.456, 0.406)
TEACHER_STD = (0.229, 0.224, 0.225)
# the recipe's transform_dino normalisation (CIFAR-100 statistics)
REFERENCE_VIEW_MEAN = (0.5071, 0.4867, 0.4408)
REFERENCE_VIEW_STD = (0.2675, 0.2565, 0.2761)
TEACHER_VIEWS = ("imagenet", "reference")
# config keys that resize the teacher's backbone (ViT-S/16 when absent)
TEACHER_SIZE_KEYS = {"teacher_patch_size": "patch_size", "teacher_embed_dim": "embed_dim",
                     "teacher_depth": "depth", "teacher_num_heads": "num_heads",
                     "teacher_num_registers": "num_registers"}


def make_teacher_view(t_size: int, in_ch: int = 3, mode: str = "imagenet") -> Callable:
    """The teacher's view of a raw [B, C, H, W] batch in [0, 1].

    ``"imagenet"`` (the default): bilinear resize to ``t_size`` and the
    ImageNet statistics. ``"reference"``: the recipe's ``transform_dino``,
    a PIL-order bicubic resize to round(t_size * 256 / 224), a centre crop
    to ``t_size`` and the CIFAR-100 statistics; square inputs only (the
    recipe's aspect-keeping short-side resize is refused, not
    approximated). A grayscale batch is repeated to 3 channels after the
    resize."""
    if mode not in TEACHER_VIEWS:
        raise ValueError(f"teacher_view must be one of {TEACHER_VIEWS}, got {mode!r}")

    def view(x: torch.Tensor) -> torch.Tensor:
        if mode == "reference":
            h, w = x.shape[-2:]
            if h != w:
                raise ValueError(f"teacher_view='reference' takes square inputs only (got "
                                 f"{h}x{w}); the recipe's short-side resize is not ported")
            x = center_crop(resize_bicubic_pil(x, round(t_size * 256 / 224)), t_size)
            mean, std = REFERENCE_VIEW_MEAN, REFERENCE_VIEW_STD
        else:
            x = resize_bilinear(x, t_size)
            mean, std = TEACHER_MEAN, TEACHER_STD
        if in_ch == 1:
            x = x.repeat(1, 3, 1, 1)
        return normalize(x, mean, std)

    return view


def precompute_teacher_logits(teacher_logits_fn: Callable, images: np.ndarray,
                              batch_size: int, num_classes: int,
                              device: torch.device | str) -> torch.Tensor:
    """``teacher_logits_fn`` over ``images`` in chunks of ``batch_size``:
    [N, num_classes] float32 on ``device``. The last chunk is padded by
    repeating its last row, so that every call has the hot loop's shape."""
    n = len(images)
    out = torch.empty((n, num_classes), dtype=torch.float32, device=device)
    for start in range(0, n, batch_size):
        chunk = images[start:start + batch_size]
        valid = len(chunk)
        if valid < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - valid, axis=0)])
        logits = teacher_logits_fn(torch.from_numpy(np.ascontiguousarray(chunk)).to(device))
        out[start:start + valid] = logits[:valid]
    return out


@dataclass
class DistillResult:
    state: TrainState
    metrics: dict[str, float]  # the last step's
    batch_losses: list[tuple[int, float, float, float]]  # (step, loss, loss_dist, loss_ce)
    last_val_accuracy: float
    cache_seconds: float | None  # the teacher-logit table's pass, None without it
    logdir: str


def teacher_from_config(config: SimpleNamespace, img_size: int,
                        device: torch.device | str) -> DinoClassifier:
    """The configured frozen teacher: ``dinov2*`` names the v2 variant,
    anything else v3; weights from ``teacher_checkpoint`` or
    ``$SPECTRE_TEACHER_WEIGHTS``, else seeded from ``random_seed``; run in
    ``compute_dtype``; ``teacher_<size>`` keys override ViT-S/16's sizes."""
    variant = "v2" if str(getattr(config, "teacher", "dinov3_vits16")).startswith("dinov2") \
        else "v3"
    sizes = {arg: int(getattr(config, key)) for key, arg in TEACHER_SIZE_KEYS.items()
             if getattr(config, key, None) is not None}
    return load_teacher(int(config.num_classes), img_size=img_size,
                        seed=int(getattr(config, "random_seed", 42)), variant=variant,
                        weights_path=getattr(config, "teacher_checkpoint", None),
                        dtype=resolve_dtype(getattr(config, "compute_dtype", "float32")),
                        device=device, **sizes)


def distill_from_config(config: SimpleNamespace, *, device: torch.device | str = "cuda",
                        max_steps: int | None = None, synthetic: bool = False,
                        teacher: DinoClassifier | None = None, teacher_variables=None,
                        teacher_img_size: int = 224, write_metrics: bool = True,
                        checkpoint: bool = True, resume: bool = False,
                        cache_teacher: bool | None = None) -> DistillResult:
    """Distil the frozen teacher into the configured student. ``teacher`` (a
    ``DinoClassifier``) replaces the configured one, ``teacher_variables``
    (a flax variable tree of numpy arrays) is loaded into it through the
    weight bridge; ``cache_teacher`` forces the logit table on or off."""
    mesh, device, own_group = config_mesh(config, torch.device(device))
    dataset = getattr(config, "dataset", "cifar100")
    if synthetic:
        train_x, train_y = synthetic_dataset(dataset, "train")
    else:
        train_x, train_y = load_dataset(dataset, "train", data_dir=getattr(config, "data_dir",
                                                                           None))
    val_x, val_y = load_sized_dataset(config, "test", synthetic)
    dp = axis_size(mesh, DATA_AXIS)
    batch_size = local_batch_size(int(config.batch_size), mesh)  # this rank's
    (train_x, train_y), (val_x, val_y) = slice_for_rank(mesh, (train_x, train_y),
                                                        (val_x, val_y))
    if batch_size > len(train_x):
        raise ValueError(f"batch {batch_size} exceeds the training set ({len(train_x)} "
                         "examples): the drop-last iterator would yield no batch")
    seed = int(getattr(config, "random_seed", 42))
    train_iter = BatchIterator(train_x, train_y, batch_size, shuffle=True, seed=seed)
    steps_per_epoch = max(1, len(train_iter))
    state = lay_out(create_trainer(config, device, steps_per_epoch), config, mesh)
    model = state.model
    is_main = state.layout is None or state.layout.is_main

    if teacher is None:
        teacher = teacher_from_config(config, teacher_img_size, device)
    teacher = freeze(teacher.to(device))
    if teacher_variables is not None:
        load_flax_variables(teacher, teacher_variables)
    in_ch = int(getattr(config, "in_channels", 3))
    teacher_view = make_teacher_view(teacher.backbone.img_size, in_ch=in_ch,
                                     mode=str(getattr(config, "teacher_view", "imagenet")))

    def teacher_logits_fn(raw: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            logits = teacher(teacher_view(raw))
        return logits.clone()  # a normal tensor, which autograd may save

    mean, std = dataset_stats(dataset)
    augment = make_train_augment(mean, std, jitter=(in_ch == 3))
    img_size = int(config.img_size)
    resize = (lambda v: resize_bilinear(v, img_size)) if train_x.shape[-1] != img_size \
        else (lambda v: v)
    alpha = float(getattr(config, "distill_alpha", 0.25))
    step_fn = make_distill_step(
        augment_fn=lambda gen, v: augment(gen, resize(v)),
        temperature=float(getattr(config, "distill_temperature", 2.0)), kd_weight=alpha,
        ce_weight=1.0 - alpha, grad_clip_norm=getattr(config, "grad_clip_norm", None))
    eval_step = make_eval_step(model)
    eval_transform = make_eval_transform(mean, std)

    if cache_teacher is None:
        cache_teacher = bool(getattr(config, "distill_cache_teacher", True))
        if cache_teacher and max_steps is not None and max_steps <= steps_per_epoch:
            cache_teacher = False  # no sample comes back: the table would not pay
    logit_cache, cache_seconds = None, None
    if cache_teacher:
        t = time.perf_counter()
        logit_cache = precompute_teacher_logits(teacher_logits_fn, train_x, batch_size,
                                                int(config.num_classes), device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        cache_seconds = time.perf_counter() - t
        if is_main:
            print(f"teacher-logit cache: {logit_cache.shape[0]} x {logit_cache.shape[1]} "
                  f"f32 ({logit_cache.numel() * 4 / 1e6:.1f} MB) in {cache_seconds:.2f} s: "
                  "the teacher leaves the hot loop", flush=True)

    logdir = f"{getattr(config, 'checkpoint_dir', 'runs')}/distill_{experiment_name(config)}"
    writer = MetricsWriter(logdir) if write_metrics and is_main else None
    ckpt = CheckpointManager(f"{logdir}/ckpt", max_to_keep=getattr(config, "keep_checkpoints", 3),
                             best_metric="accuracy") if checkpoint else None
    if resume and ckpt and ckpt.latest_step is not None:
        ckpt.restore(state)
        if is_main:
            print(f"resumed from step {state.step}", flush=True)
    routed = set_mix_routes(model, config)
    if routed and is_main:
        print(f"mix routes registered: {routed}", flush=True)
    if is_main:
        layout = "" if state.layout is None else \
            f" layout={state.layout.kind} mesh={tuple(mesh.shape)}"
        print(f"distill: student params={param_count(model):,} teacher "
              f"params={param_count(teacher):,} device={device} batch={batch_size * dp}"
              f"{layout} steps/epoch={steps_per_epoch}", flush=True)

    # on SIGTERM/SIGINT: finish the step, save the whole state, stop
    preempted = {"flag": False}

    def on_signal(signum, frame):
        preempted["flag"] = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:  # not the main thread
            pass

    batch_losses: list[tuple[int, float, float, float]] = []

    def fetch(pending: list) -> None:
        """One host read for a window of steps' loss scalars."""
        if not pending:
            return
        values = torch.stack([torch.stack([m["loss"], m["loss_dist"], m["loss_ce"]])
                              for _, m in pending]).tolist()
        for (step_no, _), (loss, kd, ce) in zip(pending, values):
            batch_losses.append((step_no, loss, kd, ce))
            if writer:
                writer.scalar("Batch Loss/Train", loss, step_no)
                writer.scalar("Batch Loss/Dist", kd, step_no)
                writer.scalar("Batch Loss/CE", ce, step_no)
        pending.clear()

    start_epoch = state.step // steps_per_epoch
    skip_batches = state.step % steps_per_epoch
    for _ in range(start_epoch):
        train_iter.skip_epoch()
    log_every = int(getattr(config, "log_every", 50))
    prefetch = int(getattr(config, "prefetch_depth", 2))
    val_batch = max(1, int(getattr(config, "val_batch_size", batch_size * dp)) // dp)
    epochs = int(config.epochs)
    done = max_steps is not None and state.step >= max_steps
    metrics = None
    last_val = -1.0
    t0 = time.perf_counter()

    for epoch in range(start_epoch, epochs):
        if done:
            break
        pending: list = []
        src = iter(train_iter)
        if skip_batches:
            src = itertools.islice(src, skip_batches, None)
            skip_batches = 0
        for batch in prefetch_to_device(src, device, prefetch=prefetch):
            teacher_logits = logit_cache[batch["index"]] if logit_cache is not None \
                else teacher_logits_fn(batch["image"])
            metrics = step_fn(state, batch["image"], teacher_logits, batch["label"])
            pending.append((state.step, metrics))
            if len(pending) >= log_every:
                fetch(pending)
            if state.layout is not None:
                preempted["flag"] = state.layout.agree(preempted["flag"])
            if preempted["flag"] or (max_steps is not None and state.step >= max_steps):
                done = True
                break
        fetch(pending)
        if preempted["flag"]:
            break  # the grace window belongs to the save below, not a validation pass

        val_loss, last_val, _ = evaluate_state(
            state, eval_step, eval_transform,
            BatchIterator(val_x, val_y, val_batch, shuffle=False), device)
        if writer:
            writer.scalar("Loss/Validation", val_loss, state.step)
            writer.scalar("Accuracy/Validation", last_val, state.step)
            writer.flush()
        if metrics is not None:
            if is_main:
                print(f"distill epoch {epoch + 1}/{epochs} step {state.step} val loss "
                      f"{val_loss:.4f} acc {last_val:.4f}", flush=True)
            if ckpt:
                ckpt.save(state, {"accuracy": last_val, "neg_loss": -batch_losses[-1][1]})

    if metrics is None:
        raise RuntimeError("no training batch ran (empty dataset, epochs=0, or a resume past "
                           "the last step): nothing to return")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if ckpt:
        if preempted["flag"]:
            ckpt.save(state, {"accuracy": last_val})
            if is_main:
                print(f"preempted at step {state.step}: state checkpointed, resume with "
                      "--resume", flush=True)
        ckpt.wait()
        ckpt.close()
    if writer:
        writer.scalar("Training time", time.perf_counter() - t0, state.step)
        writer.close()
    for sig, handler in prev_handlers.items():
        signal.signal(sig, handler)
    model.train()
    end_own_group(own_group)
    return DistillResult(state, {k: float(v) for k, v in metrics.items()}, batch_losses,
                         last_val, cache_seconds, logdir)
