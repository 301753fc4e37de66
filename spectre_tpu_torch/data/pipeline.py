"""Input pipeline (port of spectre_tpu/data/pipeline.py): shuffled batching
over in-memory numpy arrays and a prefetch queue onto the device. Batch shapes
are static: the last partial batch is dropped in training and padded in eval.

The host's only job is to hand raw pixel batches to the card ahead of time;
augmentation runs on the device inside the step. ``prefetch_to_device`` keeps
``prefetch`` batches in flight: each is copied into a pinned host buffer and
from there to the device with a non-blocking copy on a side stream, so the
copy of batch k+1 overlaps step k.

On a mesh each data rank iterates its own slice of the dataset
(``rank_slice``) in batches of global / data ranks and stages them onto its
own card, the counterpart of the JAX package's ``prefetch_to_mesh``, whose
global array is here the sum of the ranks' local tensors.
"""

from __future__ import annotations

import collections
from collections.abc import Iterable, Iterator

import numpy as np
import torch


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

    def skip_epoch(self) -> None:
        """Advance the shuffle stream by exactly one epoch without making
        batches (it consumes what ``__iter__`` would): a resumed run
        fast-forwards the data order this way."""
        if self.shuffle:
            self._rng.shuffle(np.arange(self.num_examples))

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
            # index: the dataset rows of the batch, to join per-sample side
            # tables against a shuffled batch; valid: the count of real examples
            yield {"image": self.images[sel], "label": self.labels[sel], "mask": mask,
                   "index": sel, "valid": np.int32(valid)}


def rank_slice(images: np.ndarray, labels: np.ndarray, rank: int,
               size: int) -> tuple[np.ndarray, np.ndarray]:
    """Data rank ``rank``'s strided slice of a dataset, as each JAX process
    loads its own: every rank gets the same length, the shortest slice's.
    Ranks that ran different numbers of batches would wait on each other's
    collectives for ever."""
    if size == 1:
        return images, labels
    n = len(images) // size
    return images[rank::size][:n], labels[rank::size][:n]


class _Slot:
    """One pinned staging buffer per array of a batch, and the event that
    marks the end of the last copy out of them."""

    def __init__(self):
        self.pinned: dict[str, torch.Tensor] = {}
        self.event: torch.cuda.Event | None = None

    def buffer(self, key: str, like: torch.Tensor) -> torch.Tensor:
        buf = self.pinned.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = self.pinned[key] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return buf


def prefetch_to_device(iterator: Iterable[dict], device: torch.device | str,
                       prefetch: int = 2) -> Iterator[dict]:
    """Stage host batches onto ``device`` ahead of their use.

    Every ndarray value of a batch becomes a tensor on the device; host
    scalars (``valid``) pass through. On a CUDA device a queue of ``prefetch``
    batches is kept in flight: each goes through a pinned buffer and a
    non-blocking copy on a side stream, and the consumer's stream waits for
    that copy's event before it reads the batch. A pinned buffer is written
    again only after the event of its previous copy has completed (a buffer
    reused earlier would corrupt a batch silently). On the CPU batches pass
    through one by one, in the same order.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                   for k, v in batch.items()}
        return

    prefetch = max(1, int(prefetch))
    copy_stream = torch.cuda.Stream(device)
    slots = [_Slot() for _ in range(prefetch)]
    queue: collections.deque = collections.deque()
    staged = 0

    def stage(batch: dict) -> tuple[dict, torch.cuda.Event]:
        nonlocal staged
        slot = slots[staged % prefetch]
        staged += 1
        if slot.event is not None:
            slot.event.synchronize()  # the copy that last read these buffers
        out = {}
        with torch.cuda.stream(copy_stream):
            for k, v in batch.items():
                if isinstance(v, np.ndarray):
                    src = torch.from_numpy(v)
                    out[k] = slot.buffer(k, src).copy_(src).to(device, non_blocking=True)
                else:
                    out[k] = v
            slot.event = torch.cuda.Event()
            slot.event.record(copy_stream)
        return out, slot.event

    it = iter(iterator)
    for batch in it:
        queue.append(stage(batch))
        if len(queue) >= prefetch:
            break
    while queue:
        out, event = queue.popleft()
        for batch in it:
            queue.append(stage(batch))
            break
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for v in out.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(current)  # allocated on the side stream, read on this one
        yield out
