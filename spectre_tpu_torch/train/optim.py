"""Optimizer and schedule (port of spectre_tpu/train/optim.py).

AdamW with a cosine learning-rate schedule over ``epochs * steps_per_epoch``
steps, an optional linear warmup (``warmup_steps`` / ``warmup_epochs``), a
floor ``eta_min``, and optional global-norm gradient clipping
(``grad_clip_norm``).

The schedule is a function of the 0-based step count, as optax's are: the
first update uses ``schedule(0)``. ``torch.optim.AdamW`` shrinks the weights
by ``1 - lr * weight_decay`` and then takes the Adam step, where optax adds
``weight_decay * p`` to the Adam direction and scales both by the learning
rate; the two agree to rounding (eps 1e-8 outside the root, the same bias
correction), and a test holds them together.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterable
from types import SimpleNamespace

import torch


def make_schedule(config: SimpleNamespace, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate as a function of the 0-based step."""
    lr = float(getattr(config, "learning_rate", 1e-3))
    total_steps = max(1, int(config.epochs) * int(steps_per_epoch))
    warmup_steps = int(getattr(config, "warmup_steps", 0) or
                       getattr(config, "warmup_epochs", 0) * steps_per_epoch)
    eta_min = float(getattr(config, "eta_min", 0.0))
    alpha = eta_min / lr if lr else 0.0
    decay_steps = total_steps - warmup_steps
    if warmup_steps > 0 and decay_steps <= 0:
        raise ValueError(f"warmup of {warmup_steps} steps leaves no step of {total_steps} "
                         "to the cosine decay")

    def cosine(step: int) -> float:
        t = min(step, decay_steps) / decay_steps
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t)) + alpha)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * step / warmup_steps
        return cosine(step - warmup_steps)

    return schedule


def make_optimizer(config: SimpleNamespace, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int
                   ) -> tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over ``params`` and the scheduler that sets its learning rate;
    call ``scheduler.step()`` after every ``optimizer.step()``."""
    schedule = make_schedule(config, steps_per_epoch)
    betas = tuple(getattr(config, "adam_betas", (0.9, 0.999)))
    # base lr 1.0: the scheduler's factor is the learning rate itself
    optimizer = torch.optim.AdamW(
        params, lr=1.0, betas=betas, eps=1e-8,
        weight_decay=float(getattr(config, "adam_weight_decay", 1e-4)))
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> None:
    """Scale the gradients in place by ``max_norm / norm`` when their global
    L2 norm reaches ``max_norm`` (optax's ``clip_by_global_norm``). The
    decision stays on the device: no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
