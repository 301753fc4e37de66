"""Named spans inside the program, on the profiler's clock.

``span(name)`` marks a stretch of the host's work. While a ``torch.profiler``
is recording it is ``torch.profiler.record_function(name)``: the span lands
in the Kineto trace as a ``user_annotation`` on its thread, on the same clock
as the card's kernels, copies and fills, and every launch inside it can be
tied to it through the launch's correlation id. Otherwise it is one shared
no-op context: the cost is one attribute read, no torch call and no
allocation. Spans are on exactly when a profiler runs; there is no other
switch.

The program's spans (``portbench/spans.py`` reads them):

- ``data/gather``: ``BatchIterator`` making one batch (row gather, mask);
- ``data/stage``: ``prefetch_to_device`` staging one batch (the pinned copy
  and the host-to-device copy's issue; on the CPU the tensors' wrapping),
  and inside it ``data/slot_wait``, the wait for a pinned buffer's last copy;
- ``step``: one ``train_step`` call, and inside it per microbatch
  ``step/augment``, ``step/forward`` (the forward, the auxiliary loss and
  the loss) and ``step/backward``, then ``step/optimizer`` (reduction,
  clipping, the optimizer's and the schedule's steps);
- ``op/mix``: ``MHPermutMix.forward``; ``op/spectre_linear``:
  ``ops/linear.py::spectre_linear_apply``. No span is opened on the
  autograd engine's thread: the backward of an op is tied to its forward
  span through the autograd sequence number the trace records.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in a running profiler's trace, or the
    shared no-op context when none runs."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
