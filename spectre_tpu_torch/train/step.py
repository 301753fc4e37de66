"""Train and eval steps (port of spectre_tpu/train/step.py).

One train step is forward in train mode, cross-entropy, backward through
every layer, optional gradient clipping, AdamW, and the schedule's next
learning rate. Activations run in the model's compute dtype over float32
master parameters (the modules cast per call; no autocast, no loss scaling:
bf16 has float32's range). Metrics are device tensors; callers read them on
the host once per epoch, not per step.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

from spectre_tpu_torch.train.optim import clip_by_global_norm_
from spectre_tpu_torch.train.state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    return F.cross_entropy(logits.float(), labels.long())


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


def make_train_step(augment_fn: Callable | None = None, grad_accum_steps: int = 1,
                    grad_clip_norm: float | None = None) -> Callable:
    """Build ``train_step(state, images, labels) -> metrics``; it updates
    ``state`` in place and returns ``loss``, ``accuracy`` and ``loss_aux`` as
    device tensors.

    ``augment_fn(generator, images) -> images`` runs on the device before the
    forward when given. ``grad_accum_steps`` > 1 splits the batch into that
    many equal microbatches and accumulates their gradients before the one
    optimizer update (mean of means over equal microbatches is the full
    batch's mean; each microbatch draws its own dropout masks).
    """
    a = max(1, int(grad_accum_steps))

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor) -> dict:
        model = state.model
        if images.shape[0] % a:
            raise ValueError(f"batch {images.shape[0]} not divisible by "
                             f"grad_accum_steps={a}: samples would be dropped")
        state.optimizer.zero_grad(set_to_none=True)
        metrics = None
        for x, y in zip(images.chunk(a), labels.chunk(a)):
            if augment_fn is not None:
                x = augment_fn(state.dropout_generator, x)
            logits = model(x)
            aux = _aux_loss(model, logits)
            loss = cross_entropy_loss(logits, y) + aux
            (loss / a).backward()
            part = {"loss": loss.detach(), "accuracy": _accuracy(logits.detach(), y),
                    "loss_aux": aux.detach()}
            metrics = part if metrics is None else {k: metrics[k] + v for k, v in part.items()}
        if a > 1:
            metrics = {k: v / a for k, v in metrics.items()}
        if grad_clip_norm:
            clip_by_global_norm_(model.parameters(), float(grad_clip_norm))
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return metrics

    return train_step


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
