"""Distillation (port of spectre_tpu/distill/): the frozen DINO teacher and
the distill loop."""

from spectre_tpu_torch.distill.loop import (
    DistillResult,
    distill_from_config,
    make_teacher_view,
    precompute_teacher_logits,
    teacher_from_config,
)
from spectre_tpu_torch.distill.teacher import (
    DinoClassifier,
    DinoVisionTransformer,
    import_torch_state_dict,
    load_teacher,
)

__all__ = [
    "DinoClassifier",
    "DinoVisionTransformer",
    "DistillResult",
    "distill_from_config",
    "import_torch_state_dict",
    "load_teacher",
    "make_teacher_view",
    "precompute_teacher_logits",
    "teacher_from_config",
]
