"""Dataset loading (port of spectre_tpu/data/datasets.py): CIFAR-100, MNIST
(Kaggle CSV and IDX) and the synthetic generator.

Loaders read the standard on-disk formats when present and fall back to a
deterministic synthetic set of the same shapes and dtypes, so that every
pipeline and test runs without a download. All return plain numpy: images
[N, C, H, W] float32 in [0, 1], labels [N] int32. Augmentation and
normalisation happen on the device (``data/augment.py``).

The JAX package's threaded native decoder for ``cifar-100-binary`` (its
``data/native_loader``, built from ``native/``) is an optional accelerator
that is not ported; the numpy reading below gives the same arrays.
"""

from __future__ import annotations

import os
import pickle
import struct

import numpy as np

# (channels, height, width, classes)
_SHAPES = {"cifar100": (3, 32, 32, 100), "mnist": (1, 28, 28, 10)}


def _load_cifar100(data_dir: str, split: str) -> tuple[np.ndarray, np.ndarray]:
    name = "train" if split == "train" else "test"
    pickle_path = os.path.join(data_dir, "cifar-100-python", name)
    binary_path = os.path.join(data_dir, "cifar-100-binary", f"{name}.bin")
    if os.path.exists(pickle_path):
        with open(pickle_path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        images = d[b"data"].reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
        return images, np.asarray(d[b"fine_labels"], dtype=np.int32)
    if os.path.exists(binary_path):
        raw = np.fromfile(binary_path, np.uint8).reshape(-1, 2 + 3072)
        labels = raw[:, 1].astype(np.int32)  # byte 0 is the coarse label, byte 1 the fine one
        return raw[:, 2:].reshape(-1, 3, 32, 32).astype(np.float32) / 255.0, labels
    raise FileNotFoundError(pickle_path)


def _load_mnist_idx(data_dir: str, split: str) -> tuple[np.ndarray, np.ndarray]:
    prefix = "train" if split == "train" else "t10k"
    with open(os.path.join(data_dir, f"{prefix}-images-idx3-ubyte"), "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, 1, rows, cols)
    with open(os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte"), "rb") as f:
        struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8)
    return images.astype(np.float32) / 255.0, labels.astype(np.int32)


def _load_mnist_kaggle_csv(data_dir: str, split: str) -> tuple[np.ndarray, np.ndarray]:
    """Kaggle digit-recognizer format: train.csv has a label column and 784
    pixels; test.csv has pixels only (it is the submission set).

    As test.csv carries no labels, the evaluation split is the last tenth of
    train.csv and the train split the rest. ``split="submission"`` returns
    the unlabelled test.csv pixels with labels of -1."""
    if split == "submission":
        raw = np.loadtxt(os.path.join(data_dir, "test.csv"), delimiter=",", skiprows=1,
                         dtype=np.float32)
        return raw.reshape(-1, 1, 28, 28) / 255.0, np.full((raw.shape[0],), -1, np.int32)
    raw = np.loadtxt(os.path.join(data_dir, "train.csv"), delimiter=",", skiprows=1,
                     dtype=np.float32)
    labels = raw[:, 0].astype(np.int32)
    images = raw[:, 1:].reshape(-1, 1, 28, 28) / 255.0
    n_val = max(1, len(images) // 10)
    if split == "train":
        return images[:-n_val], labels[:-n_val]
    return images[-n_val:], labels[-n_val:]


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


def synthetic_batch(name: str, batch: int, split: str = "train") -> tuple[np.ndarray, np.ndarray]:
    """The first ``batch`` examples of the synthetic set, the set repeated
    where it is shorter: one fixed batch of raw pixels for timing a step."""
    x, y = synthetic_dataset(name, split)
    reps = -(-batch // len(x))
    return np.tile(x, (reps, 1, 1, 1))[:batch], np.tile(y, reps)[:batch]


def load_dataset(name: str, split: str = "train", data_dir: str | None = None,
                 allow_synthetic: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Load ``cifar100`` or ``mnist``: (images [N, C, H, W] f32, labels [N] i32).

    Search order: ``data_dir`` -> ``$SPECTRE_DATA_DIR`` -> ``./data`` -> the
    synthetic set (if allowed)."""
    candidates = [d for d in (data_dir, os.environ.get("SPECTRE_DATA_DIR"), "data") if d]
    for d in candidates:
        try:
            if name == "cifar100":
                return _load_cifar100(d, split)
            if name == "mnist":
                if os.path.exists(os.path.join(d, "train.csv")):
                    return _load_mnist_kaggle_csv(d, split)
                return _load_mnist_idx(d, split)
        except (FileNotFoundError, NotADirectoryError):
            continue
    if not allow_synthetic:
        raise FileNotFoundError(f"dataset {name!r} not found in {candidates}")
    return synthetic_dataset(name, split)
