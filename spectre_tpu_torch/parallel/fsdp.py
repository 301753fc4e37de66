"""Fully sharded data parallelism, ZeRO-3, on FSDP2 (port of spectre_tpu/parallel/fsdp.py).

Each parameter large enough, and its AdamW moments, is split over the
mesh's ``data`` axis; FSDP2 (``fully_shard``) all-gathers a layer's weights
before its forward and backward and reduce-scatters its gradients, so each
rank updates only its own shard. Every encoder layer is one FSDP unit (one
all-gather and one reduce-scatter), the root holds the rest.

Which dim of a leaf is split follows the JAX package's ``_with_data_axis``:
the largest dim that the data size divides and that tensor parallelism has
not claimed. FSDP2 would split dim 0 of everything; ``shard_placement_fn``
gives it JAX's choice per leaf. A leaf under ``min_size`` elements, or with
no such dim, stays whole on every rank, as in JAX: it is in FSDP2's
``ignored_params`` (torch 2.11 and 2.13 both take it and
``shard_placement_fn``), so FSDP neither splits nor reduces it, and the
train step all-reduces its gradient over ``data`` itself
(``parallel/layout.py::Layout.reduce_gradients``), where GSPMD kept an
all-reduce for it.

The moments are split from their first step: ``torch.optim.AdamW`` makes its
state lazily with ``zeros_like(param)``, and the parameter it sees is the
shard, so no whole copy of a moment ever exists (JAX places them on the
parameters' shardings at once, ``_place_like_params``, for the same end).

JAX's ``pin_step_shardings`` has no counterpart: it exists because GSPMD's
propagation drifts the carried state back toward replicated after an
update. FSDP2 runs eagerly and its parameters are ``DTensor`` shards that
the optimizer updates in place, so the layout after any number of steps is
the layout ``apply_fsdp`` made (the tests hold it so after steps).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Shard

from spectre_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size
from spectre_tpu_torch.parallel.tp import apply_tp, tp_specs, trim

# Leaves with fewer elements stay whole: splitting a [512] bias saves 2 KB a
# rank and costs a collective in the step.
MIN_SHARD_SIZE = 2 ** 14


def _with_data_axis(spec: tuple, shape, data_size: int, min_size: int) -> tuple:
    """``spec`` with DATA_AXIS on the largest unclaimed dim of ``shape`` that
    ``data_size`` divides; unchanged when the leaf is too small or no dim
    divides."""
    if math.prod(shape) < min_size:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    candidates = [d for d, e in enumerate(entries)
                  if e is None and shape[d] >= data_size and shape[d] % data_size == 0]
    if not candidates:
        return spec
    entries[max(candidates, key=lambda i: shape[i])] = DATA_AXIS
    return trim(entries)


def fsdp_specs(model: nn.Module, data_size: int, *, min_size: int = MIN_SHARD_SIZE,
               tp_rules=None, model_size: int = 1) -> dict[str, tuple]:
    """JAX's ``fsdp_shardings`` for the port's parameters: {name: spec}, the
    tensor-parallel claims first when ``tp_rules`` are given, then the data
    axis on the largest remaining divisible dim."""
    base = tp_specs(model, model_size, tp_rules) if tp_rules is not None else {}
    return {name: _with_data_axis(base.get(name, ()), tuple(p.shape), data_size, min_size)
            for name, p in model.named_parameters()}


def encoder_layers(model: nn.Module) -> list[nn.Module]:
    """The FSDP units below the root: each encoder layer of SpectreViT, the
    ViT and SpectreBranch."""
    from spectre_tpu_torch.models import (SpectreBranchEncoderLayer, SpectreEncoderLayer,
                                          TransformerEncoderLayer)

    kinds = (SpectreEncoderLayer, TransformerEncoderLayer, SpectreBranchEncoderLayer)
    return [m for m in model.modules() if isinstance(m, kinds)]


def swap_parameters(optimizer: torch.optim.Optimizer, before: dict, after: dict) -> None:
    """Point ``optimizer`` at the parameters that replaced ``before``'s:
    {name: parameter} maps of the model before and after it was wrapped."""
    new = {id(p): after[name] for name, p in before.items()}
    if optimizer.state:
        raise ValueError("wrap the model before the optimizer's first step: its state "
                         "would not follow the new parameters")
    for group in optimizer.param_groups:
        group["params"] = [new.get(id(p), p) for p in group["params"]]


def apply_fsdp(model: nn.Module, optimizer: torch.optim.Optimizer | None, mesh: DeviceMesh,
               *, min_size: int = MIN_SHARD_SIZE, tp_rules=None) -> set[nn.Parameter]:
    """Shard ``model`` over the mesh's ``data`` axis in place: tensor
    parallelism over ``model`` first when ``tp_rules`` are given and that
    axis has more than one rank, then ``fully_shard`` on every encoder
    layer and on the root, with JAX's choice of dim per leaf. ``optimizer``
    (built on the unwrapped parameters, before its first step) is pointed at
    the shards. Returns the parameters kept whole (FSDP's
    ``ignored_params``), whose gradients the step reduces itself."""
    before = dict(model.named_parameters())
    model_size = axis_size(mesh, MODEL_AXIS)
    rules = tp_rules if model_size > 1 else None
    specs = fsdp_specs(model, axis_size(mesh, DATA_AXIS), min_size=min_size, tp_rules=rules,
                       model_size=model_size)
    if rules is not None:
        apply_tp(model, mesh, rules)
    params = dict(model.named_parameters())
    placement = {id(p): Shard(specs[n].index(DATA_AXIS))
                 for n, p in params.items() if DATA_AXIS in specs[n]}
    whole = {p for p in params.values() if id(p) not in placement}
    data_mesh = mesh[DATA_AXIS]
    kw = dict(mesh=data_mesh, shard_placement_fn=lambda p: placement.get(id(p)),
              ignored_params=whole)
    for layer in encoder_layers(model):
        fully_shard(layer, **kw)
    fully_shard(model, **kw)
    if optimizer is not None:
        swap_parameters(optimizer, before, dict(model.named_parameters()))
    _key_folds_on_shards(model)
    return whole


def _key_folds_on_shards(model: nn.Module) -> None:
    """Key each folded mix's weight cache on its stored kernel shard, which
    the optimizer and a restore update in place (the kernel a forward sees
    is FSDP's gathered copy, in a buffer refilled every forward)."""
    from spectre_tpu_torch.models import FoldedMixLinear

    for m in model.modules():
        if isinstance(m, FoldedMixLinear) and isinstance(m.kernel, DTensor):
            shard = m.kernel
            m.fold_key = lambda p=shard: (id(p), p._version)
            m._wp = None
