"""Datasets of the port. Only the synthetic generator is ported (the JAX
package's ``data/datasets.py::_synthetic``, the same draws from the same
seeds); loading CIFAR-100 and MNIST files is not ported yet (ROADMAP.md,
queue A7)."""

from __future__ import annotations

import numpy as np

# (channels, height, width, classes)
_SHAPES = {"cifar100": (3, 32, 32, 100), "mnist": (1, 28, 28, 10)}


def synthetic_dataset(name: str, split: str, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic class-separable synthetic data with the real shapes:
    (images [N, C, H, W] float32 in [0, 1], labels [N] int32), 4096 train or
    1024 test examples. Each class has a fixed random template and a sample
    is its template plus noise, so a working model learns."""
    c, h, w, n_classes = _SHAPES.get(name, _SHAPES["mnist"])
    n = 4096 if split == "train" else 1024
    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    templates = np.random.default_rng(seed).uniform(
        0.1, 0.9, (n_classes, c, h, w)).astype(np.float32)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    images = templates[labels] + rng.normal(0, 0.15, (n, c, h, w)).astype(np.float32)
    return np.clip(images, 0.0, 1.0), labels
