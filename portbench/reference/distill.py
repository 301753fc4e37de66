"""The reference's first distillation steps: the student of
``cfg["reference"]`` trained against the frozen teacher of
``cfg["teacher"]["reference"]`` (``portbench/reference/<family>.py``), in
blocks of rows so that float32 activations of a large batch fit.

Each step takes one raw batch of [0, 1] pixels. The teacher sees its view of
it (``family.view``) and gives logits without gradients; the student sees it
through the training augmentation, with the draws and dropout masks the
configuration's step makes (``reference/common.py``). The loss is

    alpha * KD + (1 - alpha) * CE,
    KD = T^2 / B * sum_rows sum_c p_T (log p_T - log p_S),

both softmaxes at temperature T, CE the mean cross-entropy, then AdamW on
the cosine schedule, as in ``reference/steps.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import (DTYPES, AdamW, Draws, augment, cosine_lr, cross_entropy,
                                        make_matmul, trainable)
from portbench.reference.steps import family


def kd_sum(student: torch.Tensor, teacher: torch.Tensor, temperature: float) -> torch.Tensor:
    """T^2 * sum over the rows of KL(p_T || p_S) at temperature T (the
    caller divides by the batch)."""
    log_s = F.log_softmax(student / temperature, dim=-1)
    log_t = F.log_softmax(teacher / temperature, dim=-1)
    return temperature ** 2 * (log_t.exp() * (log_t - log_s)).sum()


@torch.no_grad()
def teacher_logits(cfg: dict, params: dict, raw: torch.Tensor, mm, fault: str | None = None,
                   block_rows: int = 256) -> torch.Tensor:
    """The teacher's logits [B, classes] of raw [B, C, H, W] pixels in [0, 1]."""
    t = cfg["teacher"]
    fam = family(t["reference"])
    return torch.cat([fam.forward(mm, params, fam.view(raw[s:s + block_rows], t), t, fault)
                      for s in range(0, len(raw), block_rows)])


def distill_steps(cfg: dict, student0: dict, teacher: dict, images: np.ndarray,
                  labels: np.ndarray, batches: list[np.ndarray], draw_seed: int,
                  steps_per_epoch: int, device, precision: str = "float32",
                  half_batch: bool = False, frozen: bool = False,
                  teacher_fault: str | None = None,
                  block_rows: int = 256) -> tuple[list[float], dict, dict, list[torch.Tensor]]:
    """(loss of each step, the first step's gradient of every trainable
    leaf, every trainable leaf after the last step, the teacher's logits of
    each step) of ``len(batches)`` distillation steps from ``student0`` on
    the dataset rows ``batches``. Planted faults: ``half_batch``, the loss is
    the mean over the first half of each batch only; ``frozen``, the steps
    leave the parameters and the optimizer's state as they were;
    ``teacher_fault``, one of the teacher family's ``FAULTS``."""
    fam = family(cfg["reference"])
    m, d = cfg["model"], cfg["distill"]
    temp, alpha = float(d["distill_temperature"]), float(d["distill_alpha"])
    mm = make_matmul(precision)
    names = trainable(fam.spec(m))
    p = {k: v.detach().clone() for k, v in student0.items()}
    adam = AdamW(cfg["optimizer"])
    draws = Draws(draw_seed, device)
    losses, first, kept = [], None, []
    for t, rows in enumerate(batches):
        b = len(rows)
        raw = torch.from_numpy(images[rows]).to(device)
        y = torch.from_numpy(labels[rows]).to(device)
        soft = teacher_logits(cfg, teacher, raw, mm, teacher_fault, block_rows)
        kept.append(soft)
        x = augment(draws, raw, cfg["augment"], cfg["dataset_stats"])
        masks = [(draws.keep_mask(shape, m["dropout"], DTYPES[dt]), batched)
                 for shape, dt, batched in fam.dropout_sites(m, b)]
        used = b // 2 if half_batch else b
        for k in names:
            p[k].requires_grad_(True)
        total = torch.zeros((), device=device)
        for s in range(0, used, block_rows):
            e = min(used, s + block_rows)
            block = [mask[s:e] if batched else mask for mask, batched in masks]
            logits = fam.forward(mm, p, x[s:e], m, block)
            loss = (alpha * kd_sum(logits, soft[s:e], temp)
                    + (1.0 - alpha) * cross_entropy(logits, y[s:e])) / used
            loss.backward()
            total += loss.detach()
        grads = {k: p[k].grad for k in names}
        for k in names:
            p[k] = p[k].detach()
        losses.append(float(total))
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        if not frozen:
            adam.step(p, grads, cosine_lr(cfg["optimizer"], t, steps_per_epoch))
    return losses, first, {k: p[k] for k in names}, kept
