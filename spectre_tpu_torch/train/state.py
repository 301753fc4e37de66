"""Train state (port of spectre_tpu/train/state.py): what a training run
carries from step to step.

The model holds the parameters and the mix buffers, the optimizer the AdamW
moments, the scheduler the learning rate; ``step`` counts optimizer updates
on the host, and ``dropout_generator`` is the one generator every Dropout of
the model draws its masks from.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from spectre_tpu_torch.models.layers import Dropout


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    dropout_generator: torch.Generator
    step: int = 0


def create_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       scheduler: torch.optim.lr_scheduler.LRScheduler,
                       seed: int = 42) -> TrainState:
    """Put ``model`` in train mode and give its Dropout modules one
    generator, on the model's device, seeded with ``seed``."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    model.train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    return TrainState(model, optimizer, scheduler, gen)


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
