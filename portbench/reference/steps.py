"""The reference's first training steps and its served logits, in blocks of
rows so that float32 activations of a large batch fit beside nothing else."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench.reference.common import (DTYPES, AdamW, Draws, augment, cosine_lr, cross_entropy,
                                        make_matmul, trainable)


def family(name: str):
    """The reference module of a model family (``portbench/reference/<name>.py``)."""
    return importlib.import_module(f"portbench.reference.{name}")


def train_steps(cfg: dict, params0: dict, images: np.ndarray, labels: np.ndarray,
                batches: list[np.ndarray], draw_seed: int, steps_per_epoch: int, device,
                precision: str = "float32", half_batch: bool = False, frozen: bool = False,
                block_rows: int = 256) -> tuple[list[float], dict, dict]:
    """(loss of each step, the first step's gradient of every trainable leaf,
    every trainable leaf after the last step) of ``len(batches)`` train steps
    from ``params0`` on the dataset rows ``batches`` (float32 pixels in
    [0, 1]). ``half_batch`` is a planted fault: the loss is the mean over
    the first half of each batch only; ``frozen`` another: the steps leave
    the parameters and the optimizer's state as they were."""
    fam = family(cfg["reference"])
    m = cfg["model"]
    mm = make_matmul(precision)
    names = trainable(fam.spec(m))
    p = {k: v.detach().clone() for k, v in params0.items()}
    adam = AdamW(cfg["optimizer"])
    draws = Draws(draw_seed, device)
    losses, first = [], None
    for t, rows in enumerate(batches):
        b = len(rows)
        x = torch.from_numpy(images[rows]).to(device)
        y = torch.from_numpy(labels[rows]).to(device)
        x = augment(draws, x, cfg["augment"], cfg["dataset_stats"])
        masks = [(draws.keep_mask(shape, m["dropout"], DTYPES[dt]), batched)
                 for shape, dt, batched in fam.dropout_sites(m, b)]
        used = b // 2 if half_batch else b
        for k in names:
            p[k].requires_grad_(True)
        total = torch.zeros((), device=device)
        for s in range(0, used, block_rows):
            e = min(used, s + block_rows)
            block = [mask[s:e] if batched else mask for mask, batched in masks]
            loss = cross_entropy(fam.forward(mm, p, x[s:e], m, block), y[s:e]) / used
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
    return losses, first, {k: p[k] for k in names}


@torch.no_grad()
def served_logits(cfg: dict, params: dict, pixels_u8: np.ndarray, device,
                  precision: str = "float32", block_rows: int = 512) -> torch.Tensor:
    """Eval-mode logits [n, classes] of raw u8 images [n, C, H, W], which the
    server scales by 1/255 and does not normalise."""
    fam = family(cfg["reference"])
    mm = make_matmul(precision)
    out = []
    for s in range(0, len(pixels_u8), block_rows):
        x = torch.from_numpy(pixels_u8[s:s + block_rows]).to(device).float() / 255.0
        out.append(fam.forward(mm, params, x, cfg["model"]))
    return torch.cat(out)
