"""Collective audit of one step (port of spectre_tpu/parallel/audit.py).

A loss that matches across layouts cannot tell a sharded run from one that
silently kept every parameter whole: the same loss at the same step comes
out of both. The JAX package reads the compiled HLO and counts collectives
by opcode; here the step runs eagerly under a dispatch mode that counts
every collective op torch.distributed dispatches (DDP's bucket all-reduces,
FSDP2's all-gathers and reduce-scatters, the tensor-parallel layers'
all-reduces): the ops ``CommDebugMode`` counts, without its module tracker,
which loses its place in this model's nested forwards (torch 2.13 raises
from its forward hook). ``collective_counts`` keys them by the JAX names.
The signatures are JAX's:

- pure DP: at least one all-reduce (the gradient), no all-gather and no
  reduce-scatter (nothing is sharded). The JAX audit lets all-gathers of its
  augmentation's scope through (GSPMD gathers the rotation's pixel source);
  the port's augmentation runs on each rank's rows and gathers nothing, so
  there is no such exemption here;
- FSDP: at least one all-gather (the weights before use) and one
  reduce-scatter (or its all-to-all form) of the gradients;
- TP: strictly more all-reduces than the pure-DP step of the same model;
  and each SpectreLinear split by columns all-gathers its row statistics in
  the forward and the chain's row sums in the backward (kernel B3's shard
  entries merge them in rank order), so at least two all-gathers for each.

At one rank FSDP2 issues no collective at all, so the FSDP signature holds
only across ranks.
"""

from __future__ import annotations

from collections.abc import Callable

from torch.utils._python_dispatch import TorchDispatchMode

# CommDebugMode's op names (c10d, functional and their variants) by kind
_KINDS = (("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("allgather", "all-gather"),
          ("all_gather", "all-gather"), ("allreduce", "all-reduce"),
          ("all_reduce", "all-reduce"), ("broadcast", "broadcast"))


def _kind(op) -> str | None:
    name = str(op).lower()
    for needle, kind in _KINDS:
        if needle in name:
            return kind
    return None


class _CollectiveCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "c10d" in func.namespace:
            kind = _kind(func.__name__)
            if kind is not None:
                self.counts[kind] = self.counts.get(kind, 0) + 1
        return func(*args, **(kwargs or {}))


def collective_counts(fn: Callable, *args, **kwargs) -> dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once and count the collectives it issued,
    keyed "all-reduce", "all-gather", "reduce-scatter", "all-to-all" (and
    "broadcast")."""
    mode = _CollectiveCounter()
    with mode:
        fn(*args, **kwargs)
    return mode.counts


def assert_dp_signature(counts: dict[str, int], leg: str = "dp") -> None:
    """Pure data parallelism: a gradient all-reduce, no parameter movement."""
    assert counts.get("all-reduce", 0) >= 1, \
        f"{leg}: expected a gradient all-reduce, got {counts}"
    assert counts.get("all-gather", 0) == 0, \
        f"{leg}: unexpected all-gather (parameters should be whole): {counts}"
    assert counts.get("reduce-scatter", 0) == 0, \
        f"{leg}: unexpected reduce-scatter with whole parameters: {counts}"


def assert_fsdp_signature(counts: dict[str, int]) -> None:
    """ZeRO-3: weight all-gathers and a sharded gradient reduction."""
    assert counts.get("all-gather", 0) >= 1, \
        f"fsdp: expected weight all-gathers, got {counts}: the step is NOT parameter-sharded"
    assert counts.get("reduce-scatter", 0) + counts.get("all-to-all", 0) >= 1, \
        f"fsdp: expected gradient reduce-scatters, got {counts}: gradients are whole"


def assert_tp_signature(counts: dict[str, int], dp_counts: dict[str, int],
                        column_layers: int = 0) -> None:
    """DP x TP: the activations' all-reduces on the model axis come on top
    of the gradient's, and the ``column_layers`` SpectreLinears split by
    columns all-gather their statistics twice each (forward and backward)."""
    assert counts.get("all-reduce", 0) > dp_counts.get("all-reduce", 0), \
        f"tp: expected MORE all-reduces than pure DP, got tp={counts} dp={dp_counts}: " \
        "the model axis is not used"
    assert counts.get("all-gather", 0) >= 2 * column_layers, \
        f"tp: expected at least {2 * column_layers} all-gathers of row statistics for " \
        f"{column_layers} column-split SpectreLinears, got {counts}"
