"""Training of the port: optimizer and schedule, train state, the train,
distillation and eval steps, checkpoints, and the config-driven loop."""

from spectre_tpu_torch.train.checkpoint import CheckpointManager
from spectre_tpu_torch.train.loop import TrainResult, train_from_config
from spectre_tpu_torch.train.optim import clip_by_global_norm_, make_optimizer, make_schedule
from spectre_tpu_torch.train.state import TrainState, create_train_state, param_count
from spectre_tpu_torch.train.step import (
    cross_entropy_loss,
    distill_loss,
    make_distill_step,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "CheckpointManager",
    "TrainResult",
    "TrainState",
    "clip_by_global_norm_",
    "create_train_state",
    "cross_entropy_loss",
    "distill_loss",
    "make_distill_step",
    "make_eval_step",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "param_count",
    "train_from_config",
]
