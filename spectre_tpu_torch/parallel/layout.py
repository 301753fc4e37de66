"""A train state laid out over the mesh, and what its step does about it.

``parallelize`` turns a single-device train state (``train/state.py``) into
one of the JAX train loop's layouts on the ``("data", "model")`` mesh:

- ``"dp"``: data parallelism, DDP. Parameters whole on every rank, the
  gradient all-reduce in DDP's buckets, overlapped with the backward. The
  mix tables are constant buffers: DDP is told not to broadcast them every
  forward.
- ``"fsdp"``: ZeRO-3 on FSDP2 (``parallel/fsdp.py``), tensor parallelism
  composed over ``model`` when that axis has more than one rank.
- ``"tp"``: tensor parallelism over ``model`` (``parallel/tp.py``) and data
  parallelism over ``data``, the gradients all-reduced by the step.

The state keeps the unwrapped model (checkpoints, evaluation and the mix
routes see the module they always saw); ``Layout.module`` is what the train
step calls. Each rank's dropout generator is seeded from (seed, data rank):
ranks with one generator would draw the same masks for sample i of every
slice. The ranks of one ``model`` row hold the same generator and draw
alike: a Dropout after a column-split output draws the whole row's mask
and keeps the rank's columns (``models/layers.py::Dropout``), so tensor
parallelism draws the unsplit model's masks. The augmentation stays independent of the layout by default, as in
JAX: with more than one data rank it draws from a generator that every rank
seeds alike, for the global batch, and each rank keeps its rows
(``augment_rows``); ``shard_local_augment`` draws per rank from the dropout
generator instead. At one data rank nothing is reseeded, so the run equals
the unwrapped trainer's.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.nn.parallel import DistributedDataParallel

from spectre_tpu_torch.parallel.fsdp import MIN_SHARD_SIZE, apply_fsdp, swap_parameters
from spectre_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_rank, axis_size
from spectre_tpu_torch.parallel.tp import apply_tp, local


def rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of data rank ``rank``: ``seed`` itself at rank 0."""
    return int(seed) + 1_000_003 * int(rank)


@dataclass
class Layout:
    mesh: DeviceMesh
    kind: str                  # "dp", "fsdp" or "tp"
    module: nn.Module          # what the step calls: the DDP wrapper, else the model
    reduce_params: list = field(default_factory=list)  # gradients the step reduces
    cpu_group: object = None   # gloo group for host-side agreement and objects

    @property
    def dp(self) -> int:
        return axis_size(self.mesh, DATA_AXIS)

    @property
    def data_rank(self) -> int:
        return axis_rank(self.mesh, DATA_AXIS)

    @property
    def data_group(self):
        return self.mesh.get_group(DATA_AXIS)

    @property
    def sharded(self) -> bool:
        """Whether a rank holds only part of the state (FSDP or TP)."""
        return self.kind != "dp"

    @property
    def is_main(self) -> bool:
        return dist.get_rank() == 0

    def accumulating(self, last: bool):
        """The context of one microbatch's forward and backward: the
        gradient reduction runs only with the last."""
        if last:
            return contextlib.nullcontext()
        if self.kind == "dp":
            return self.module.no_sync()
        if self.kind == "fsdp":
            return _fsdp_no_sync(self.module)
        return contextlib.nullcontext()  # "tp": the step reduces once, after the last

    def reduce_gradients(self) -> None:
        """Average over ``data`` the gradients no wrapper reduced: FSDP's
        whole leaves, and every leaf under tensor parallelism alone. One
        all-reduce per dtype."""
        if self.dp == 1:
            return
        grads = [local(p.grad) for p in self.reduce_params if p.grad is not None]
        for dtype in {g.dtype for g in grads}:
            part = [g for g in grads if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in part])
            dist.all_reduce(flat, group=self.data_group)
            flat.div_(self.dp)
            for g, f in zip(part, flat.split([g.numel() for g in part])):
                g.copy_(f.view_as(g))

    def global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole gradient over every rank's shards: each
        local sum of squares divided by the number of ranks that hold the
        same values, one all-reduce over the world."""
        world = dist.get_world_size()
        sq = torch.zeros((), dtype=torch.float32, device=local(grads[0]).device)
        for g in grads:
            distinct = 1
            if isinstance(g, DTensor):
                for mesh_dim, pl in enumerate(g.placements):
                    if pl.is_shard():
                        distinct *= g.device_mesh.size(mesh_dim)
            sq = sq + local(g).float().pow(2).sum() * (distinct / world)
        dist.all_reduce(sq)
        return sq.sqrt()

    def mean_over_data(self, metrics: dict) -> dict:
        """Each metric averaged over the data ranks (one all-reduce)."""
        if self.dp == 1:
            return metrics
        keys = list(metrics)
        v = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(v, group=self.data_group)
        v = v / self.dp
        return {k: v[i] for i, k in enumerate(keys)}

    def sum_over_data(self, sums: dict) -> dict:
        """Each value summed over the data ranks (validation sums)."""
        if self.dp == 1:
            return sums
        keys = list(sums)
        v = torch.stack([sums[k].to(torch.float64) for k in keys])
        dist.all_reduce(v, group=self.data_group)
        return {k: v[i] for i, k in enumerate(keys)}

    def agree(self, flag: bool) -> bool:
        """Whether any rank raised ``flag`` (a stop request seen by one rank
        only): a host-side all-reduce on the gloo group, no device sync."""
        if dist.get_world_size() == 1:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.cpu_group)
        return bool(t.item())

    def gather_objects(self, obj) -> list:
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj, group=self.cpu_group)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.cpu_group)


@contextlib.contextmanager
def _fsdp_no_sync(module):
    module.set_requires_gradient_sync(False)
    try:
        yield
    finally:
        module.set_requires_gradient_sync(True)


def split_param_groups(state) -> None:
    """Give each kind of parameter its own optimizer group: plain tensors,
    and ``DTensor`` shards by the mesh they lie on. AdamW's multi-tensor
    step (the default on the card) takes one group's tensors in one call,
    and a call that mixes ``DTensor`` and plain tensors, or two meshes, is
    refused. The scheduler is made anew over the groups, its schedule
    unchanged (before the first step, so it restarts where it was). A
    checkpoint still holds one group in the unwrapped model's parameter
    order (``train/checkpoint.py``)."""
    optimizer = state.optimizer
    groups = []
    for group in optimizer.param_groups:
        kinds: dict = {}
        for p in group["params"]:
            key = id(p.device_mesh) if isinstance(p, DTensor) else None
            kinds.setdefault(key, []).append(p)
        groups += [{**group, "params": ps} for ps in kinds.values()]
    if len(groups) == len(optimizer.param_groups):
        return
    optimizer.param_groups = groups
    schedule = state.scheduler.lr_lambdas[0]
    state.scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)


def augment_rows(generator: torch.Generator, layout: Layout | None, rows: int):
    """The generator the step's augmentation draws from for a local batch of
    ``rows``: the plain generator, or a ``data.augment.RowWindow`` over the
    layout's global batch."""
    if layout is None or layout.dp == 1:
        return generator
    from spectre_tpu_torch.data.augment import RowWindow

    return RowWindow(generator, rows * layout.dp, layout.data_rank * rows)


def parallelize(state, mesh: DeviceMesh, *, fsdp: bool = False,
                min_size: int = MIN_SHARD_SIZE, tp_rules=None, seed: int = 42,
                shard_local_augment: bool = False):
    """Lay ``state`` (fresh, before its first step) out on ``mesh`` in
    place: FSDP when ``fsdp``, else tensor parallelism when the ``model``
    axis has more than one rank (``tp_rules`` then required), else DDP.
    Reseeds the generators as the module docstring says. Returns ``state``
    with ``state.layout`` set."""
    model = state.model
    mp = axis_size(mesh, MODEL_AXIS)
    if mp > 1 and tp_rules is None:
        raise ValueError("a model axis of more than one rank needs tensor-parallel rules")
    cpu_group = dist.new_group(backend="gloo") if dist.get_backend() != "gloo" else None
    if fsdp:
        whole = apply_fsdp(model, state.optimizer, mesh, min_size=min_size, tp_rules=tp_rules)
        ids = {id(p) for p in whole}
        layout = Layout(mesh, "fsdp", model, [p for p in model.parameters() if id(p) in ids],
                        cpu_group)
    elif mp > 1:
        before = dict(model.named_parameters())
        apply_tp(model, mesh, tp_rules)
        swap_parameters(state.optimizer, before, dict(model.named_parameters()))
        layout = Layout(mesh, "tp", model, list(model.parameters()), cpu_group)
    else:
        # the mix tables are constants: no broadcast of buffers per forward
        DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            model, [name for name, _ in model.named_buffers()])
        dev = next(model.parameters()).device
        ddp = DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=mesh.get_group(DATA_AXIS))
        layout = Layout(mesh, "dp", ddp, [], cpu_group)
    state.layout = layout
    split_param_groups(state)
    if layout.dp > 1:
        state.dropout_generator.manual_seed(rank_seed(seed, layout.data_rank))
        if not shard_local_augment:
            state.augment_generator = torch.Generator(
                device=state.dropout_generator.device).manual_seed(int(seed))
    return state
