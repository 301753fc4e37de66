"""Train and eval steps (port of spectre_tpu/train/step.py).

One train step is forward in train mode, cross-entropy, backward through
every layer, optional gradient clipping, AdamW, and the schedule's next
learning rate. Activations run in the model's compute dtype over float32
master parameters (the modules cast per call; no autocast, no loss scaling:
bf16 has float32's range). Metrics are device tensors; callers read them on
the host once per epoch, not per step.

The distillation step is the same update on ``distill_loss``: soft-target
KL at temperature T (times T^2) against the frozen teacher's logits,
weighted ``kd_weight``, plus cross-entropy weighted ``ce_weight``.

On a mesh (``state.layout``, ``parallel/layout.py``) the step calls the
layout's module (DDP's wrapper, or the FSDP or tensor-parallel model),
skips the gradient reduction on every microbatch but the last, reduces the
gradients no wrapper reduced, clips on the norm over every rank's shards,
and returns metrics averaged over the data ranks. The augmentation draws
for the global batch and keeps this rank's rows (``parallel.augment_rows``).
"""

from __future__ import annotations

from collections.abc import Callable

import contextlib

import torch
import torch.nn.functional as F

from spectre_tpu_torch.parallel.layout import augment_rows
from spectre_tpu_torch.profile.spans import span
from spectre_tpu_torch.train.optim import clip_by_global_norm_
from spectre_tpu_torch.train.state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    return F.cross_entropy(logits.float(), labels.long())


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 labels: torch.Tensor, temperature: float = 2.0, kd_weight: float = 0.25,
                 ce_weight: float = 0.75) -> tuple[torch.Tensor, dict]:
    """``kd_weight * KD + ce_weight * CE``, KD = T^2 mean_B sum_c p_T (log p_T
    - log p_S) with both softmaxes at T in float32 whatever the logits'
    dtype; the teacher's logits are detached. Returns (loss, {"loss_dist":
    KD, "loss_ce": CE})."""
    t = float(temperature)
    log_p_s = F.log_softmax(student_logits.float() / t, dim=-1)
    log_p_t = F.log_softmax(teacher_logits.detach().float() / t, dim=-1)
    kd = (t * t) * (log_p_t.exp() * (log_p_t - log_p_s)).sum(dim=-1).mean()
    ce = cross_entropy_loss(student_logits, labels)
    return kd_weight * kd + ce_weight * ce, {"loss_dist": kd, "loss_ce": ce}


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


def _aux_loss(model: torch.nn.Module, like: torch.Tensor) -> torch.Tensor:
    """Auxiliary-loss hook: a module may leave a tensor in its
    ``spectre_loss`` attribute during the forward; all of them are summed
    into the objective."""
    aux = like.new_zeros(())
    for m in model.modules():
        value = getattr(m, "spectre_loss", None)
        if value is not None:
            aux = aux + value.sum()
    return aux


def _clip(state: TrainState, max_norm) -> None:
    layout = state.layout
    # on one rank a shard is the whole gradient: the single device's norm
    norm_fn = layout.global_norm if layout is not None and layout.sharded \
        and torch.distributed.get_world_size() > 1 else None
    clip_by_global_norm_(state.model.parameters(), float(max_norm), norm_fn)


def _finish(state: TrainState, grad_clip_norm, metrics: dict) -> dict:
    """Reduce what no wrapper reduced, clip, step the optimizer and the
    schedule; the metrics averaged over the data ranks."""
    with span("step/optimizer"):
        if state.layout is not None:
            state.layout.reduce_gradients()
        if grad_clip_norm:
            _clip(state, grad_clip_norm)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
    return metrics if state.layout is None else state.layout.mean_over_data(metrics)


def make_train_step(augment_fn: Callable | None = None, grad_accum_steps: int = 1,
                    grad_clip_norm: float | None = None) -> Callable:
    """Build ``train_step(state, images, labels) -> metrics``; it updates
    ``state`` in place and returns ``loss``, ``accuracy`` and ``loss_aux`` as
    device tensors.

    ``augment_fn(generator, images) -> images`` runs on the device inside
    the step, per microbatch, before the forward when given: raw pixels come
    in, and its draws come from the state's generator, so they are part of
    what a checkpoint resumes. ``grad_accum_steps`` > 1 splits the batch into that
    many equal microbatches and accumulates their gradients before the one
    optimizer update (mean of means over equal microbatches is the full
    batch's mean; each microbatch draws its own dropout masks).
    """
    a = max(1, int(grad_accum_steps))

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor) -> dict:
        with span("step"):
            return _train_step(state, images, labels)

    def _train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor) -> dict:
        model, layout = state.model, state.layout
        net = model if layout is None else layout.module
        if images.shape[0] % a:
            raise ValueError(f"batch {images.shape[0]} not divisible by "
                             f"grad_accum_steps={a}: samples would be dropped")
        state.optimizer.zero_grad(set_to_none=True)
        metrics = None
        for i, (x, y) in enumerate(zip(images.chunk(a), labels.chunk(a))):
            if augment_fn is not None:
                with span("step/augment"):
                    x = augment_fn(augment_rows(state.augment_source, layout, x.shape[0]), x)
            with (contextlib.nullcontext() if layout is None
                  else layout.accumulating(last=i == a - 1)):
                with span("step/forward"):
                    logits = net(x)
                    aux = _aux_loss(model, logits)
                    loss = cross_entropy_loss(logits, y) + aux
                with span("step/backward"):
                    (loss / a).backward()
            part = {"loss": loss.detach(), "accuracy": _accuracy(logits.detach(), y),
                    "loss_aux": aux.detach()}
            metrics = part if metrics is None else {k: metrics[k] + v for k, v in part.items()}
        if a > 1:
            metrics = {k: v / a for k, v in metrics.items()}
        return _finish(state, grad_clip_norm, metrics)

    return train_step


def make_distill_step(augment_fn: Callable | None = None, temperature: float = 2.0,
                      kd_weight: float = 0.25, ce_weight: float = 0.75,
                      grad_clip_norm: float | None = None) -> Callable:
    """Build ``distill_step(state, images, teacher_logits, labels) ->
    metrics``: the student's forward in train mode on ``images`` (through
    ``augment_fn(generator, images)`` first when given, its draws from the
    state's generator), ``distill_loss`` against ``teacher_logits``, and the
    update of ``make_train_step``. Metrics ``loss``, ``accuracy``,
    ``loss_dist`` and ``loss_ce`` stay on the device."""

    def distill_step(state: TrainState, images: torch.Tensor, teacher_logits: torch.Tensor,
                     labels: torch.Tensor) -> dict:
        net = state.model if state.layout is None else state.layout.module
        state.optimizer.zero_grad(set_to_none=True)
        if augment_fn is not None:
            images = augment_fn(augment_rows(state.augment_source, state.layout,
                                             images.shape[0]), images)
        logits = net(images)
        loss, parts = distill_loss(logits, teacher_logits, labels, temperature, kd_weight,
                                   ce_weight)
        loss.backward()
        return _finish(state, grad_clip_norm,
                       {"loss": loss.detach(), "accuracy": _accuracy(logits.detach(), labels),
                        **{k: v.detach() for k, v in parts.items()}})

    return distill_step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """Eval step over a possibly padded batch: ``mask`` flags the real
    examples. Returns sums (``loss_sum``, ``correct``, ``count``) as device
    tensors, so the caller aggregates exact epoch metrics. The model must be
    in eval mode."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> dict:
        if model.training:
            raise RuntimeError("eval_step needs the model in eval mode (model.eval())")
        logits = model(images)
        per_ex = F.cross_entropy(logits.float(), labels.long(), reduction="none")
        return {
            "loss_sum": (per_ex * mask).sum(),
            "correct": ((logits.argmax(dim=-1) == labels) & mask).sum(),
            "count": mask.sum(),
        }

    return eval_step
