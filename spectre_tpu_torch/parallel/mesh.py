"""Process group and device mesh (port of spectre_tpu/parallel/mesh.py).

The JAX package builds a ``("data", "model")`` mesh over the chips one
process sees and lets GSPMD derive the collectives. The port runs one process
per device, as ``torch.distributed`` does: ``init_distributed`` joins the
process group (the counterpart of ``jax.distributed.initialize``) and
``create_mesh`` lays the ranks out as the same two axes. Ranks of one
``model`` row hold the same batch slice; ranks of one ``data`` column the same
parameter shards.

The batch is sharded over ``data``: every rank holds its own slice of the
global batch (``local_rows``), staged by ``data/pipeline.py``. Sequence
parallelism stays out of scope, as in the JAX package (the mix permutes the
flattened [N * E] vector).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(init_method: str | None = None, *, rank: int | None = None,
                     world_size: int | None = None, local_rank: int | None = None,
                     device: str | None = None, backend: str | None = None,
                     timeout_s: float = 600.0) -> tuple[int, int]:
    """Join the process group and return (rank, world size).

    Without arguments it reads torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; ``init_method``
    (``tcp://host:port`` or ``file:///path``) with ``rank`` and
    ``world_size`` replaces them. ``device`` "cuda" takes NCCL and binds the
    process to the card ``LOCAL_RANK`` names; "cpu" takes gloo; None picks
    NCCL when a card is present. ``backend`` "gloo" with "cuda" runs gloo's
    collectives on card tensors, and ranks then share the cards: LOCAL_RANK
    modulo the cards present (NCCL refuses two ranks on one card). With
    none of these, a group of this one process is made. A second call
    returns the group's values."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else int(local_rank)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    on_card = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if on_card else "gloo")
    if on_card:
        if backend == "gloo":
            local_rank %= torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
    kw = dict(rank=rank, world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
    if init_method is None and world_size == 1 and "MASTER_ADDR" not in env:
        kw["store"] = dist.HashStore()  # a group of one: nothing to rendezvous with
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(backend, **kw)
    return rank, world_size


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def create_mesh(data_parallel: int | None = None, model_parallel: int = 1,
                device_type: str | None = None) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the process group: pure
    data parallelism by default. Consecutive ranks share a ``model`` row, so
    tensor-parallel partners sit on one host when a host has several cards.
    ``device_type`` of the tensors it holds: "cuda" under NCCL by default,
    else "cpu"."""
    _, n = world()
    if data_parallel is None:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"mesh {data_parallel} x {model_parallel} does not cover the "
                         f"{n} ranks of the process group")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh | None, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def local_rows(mesh: DeviceMesh | None, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch``: its block of the data
    axis (every rank of a ``model`` row gets the same rows)."""
    dp = axis_size(mesh, DATA_AXIS)
    if batch % dp:
        raise ValueError(f"batch {batch} does not divide over the {dp} data-parallel ranks")
    n = batch // dp
    i = axis_rank(mesh, DATA_AXIS)
    return slice(i * n, (i + 1) * n)


def shard_batch(mesh: DeviceMesh | None, batch: dict) -> dict:
    """This rank's slice of a global batch (a dict of arrays or tensors whose
    leading axis is the batch); other values pass through."""
    rows = None
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape):
            rows = rows or local_rows(mesh, v.shape[0])
            out[k] = v[rows]
        else:
            out[k] = v
    return out
