"""Input pipeline (port of spectre_tpu/data/pipeline.py::BatchIterator):
shuffled batching over in-memory numpy arrays. Batch shapes are static: the
last partial batch is dropped in training and padded in eval."""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np


class BatchIterator:
    """Epoch iterator over in-memory numpy arrays.

    train mode: reshuffle every epoch from a seeded Generator, drop remainder.
    eval mode: sequential, final batch zero-padded to full size (``mask``
    flags the real examples, so metrics stay exact).
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
                 *, shuffle: bool, seed: int = 0, drop_last: bool | None = None):
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self._rng = np.random.default_rng(seed)
        self.num_examples = images.shape[0]

    def __len__(self) -> int:
        n, b = self.num_examples, self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def __iter__(self) -> Iterator[dict]:
        idx = np.arange(self.num_examples)
        if self.shuffle:
            self._rng.shuffle(idx)
        b = self.batch_size
        for start in range(0, self.num_examples, b):
            sel = idx[start:start + b]
            valid = len(sel)
            if valid < b:
                if self.drop_last:
                    return
                sel = np.concatenate([sel, np.zeros(b - valid, dtype=sel.dtype)])
            mask = np.zeros(b, np.bool_)
            mask[:valid] = True
            yield {"image": self.images[sel], "label": self.labels[sel], "mask": mask}
