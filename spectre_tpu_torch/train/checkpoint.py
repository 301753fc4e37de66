"""Checkpoints of the whole train state (port of spectre_tpu/train/checkpoint.py):
best-metric and latest steps, exact resume.

This is the port's own format, on ``torch.save`` / ``torch.load``; it does not
read the JAX package's orbax directories (weights cross over from ``.npz``
exports through ``models/jax_import.py``). A directory holds one file per
saved step, ``step_<step>.pt``, and ``index.json`` with each step's metrics.
A file carries the model's ``state_dict`` (parameters and buffers: the mix
tables are draws that cannot be made again), the optimizer's and the
scheduler's ``state_dict``, the step count and the state of the generator
that dropout and the augmentation draw from, so a stopped run resumes
exactly. The manager keeps the latest ``max_to_keep`` steps plus the step with
the best ``best_metric``.

Every file is written under a temporary name and moved into place with
``os.replace``: a save cut short (it may run inside a termination grace
window) leaves the earlier files whole.

A state laid out on a mesh (``state.layout``: DDP, FSDP, tensor
parallelism) saves the same single-device file: every rank takes part in
gathering each shard whole (``DTensor.full_tensor``), in one order, and rank
0 writes. The parameter names carry no wrapper's prefix, the optimizer's
state is keyed by parameter index as a single-device optimizer keys it, and
``generators`` holds every rank's generator state (``generator`` is rank
0's, which a single-device restore reads), with the shared augmentation
generator beside it. A restore reads the file on every rank and takes its
own shard of each tensor, so a file restores into any layout: FSDP into one
device, one device into FSDP, bit for bit. A rank that finds no generator
state of its own (a file of fewer ranks) seeds its generator from rank 0's
initial seed, its rank and the step.

Devices: tensors are saved from and loaded through host memory, so a
checkpoint written on the card restores on the CPU and the reverse. A
generator's state, however, restores only into a generator of the same
device type. Across device types the generator is seeded anew with its
saved initial seed plus the step count: the run continues, but its dropout
masks and augmentation draws are no longer those of the uninterrupted run.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from spectre_tpu_torch.parallel.mesh import world
from spectre_tpu_torch.train.state import TrainState


def _whole(t):
    """A tensor on the host, gathered whole when it is a shard (collective)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu() if isinstance(t, torch.Tensor) else t


def _generator_entry(gen: torch.Generator) -> dict:
    return {"device": gen.device.type, "state": gen.get_state().cpu(),
            "initial_seed": int(gen.initial_seed())}


def _payload(state: TrainState) -> dict | None:
    """The single-device file's contents; under a layout gathered from
    every rank (every rank must call), None on ranks other than 0."""
    layout = state.layout
    model = {k: _whole(v) for k, v in state.model.state_dict().items()}
    osd = state.optimizer.state_dict()
    order = _model_order(state)
    opt_state = {order[i]: {k: _whole(v) for k, v in osd["state"][i].items()}
                 for i in sorted(osd["state"])}
    groups = [{**osd["param_groups"][0], "params": list(range(len(order)))}]
    entry = _generator_entry(state.dropout_generator)
    gens = [entry] if layout is None else layout.gather_objects(entry)
    if layout is not None and not layout.is_main:
        return None
    payload = {"step": int(state.step), "model": model,
               "optimizer": {"state": opt_state, "param_groups": groups},
               "scheduler": _scheduler_groups(state.scheduler.state_dict(), 1),
               "generator": gens[0], "generators": gens}
    if state.augment_generator is not None:
        payload["augment_generator"] = _generator_entry(state.augment_generator)
    return payload


def _scheduler_groups(sd: dict, n: int) -> dict:
    """A scheduler's state with its per-group lists cut or repeated to ``n``
    groups (every group of a layout's optimizer has one learning rate)."""
    return {k: [v[0]] * n if isinstance(v, list) and v else v for k, v in sd.items()}


def _model_order(state: TrainState) -> list[int]:
    """For each parameter of the optimizer, in its groups' order, its index
    in the unwrapped model's ``parameters()``: a single-device optimizer's
    index (a layout may have split the parameters into groups)."""
    pos = {id(p): i for i, p in enumerate(state.model.parameters())}
    return [pos[id(p)] for g in state.optimizer.param_groups for p in g["params"]]


def _like(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``src`` (whole, on the host) laid out as ``dst``: its shard when
    ``dst`` is a ``DTensor``."""
    if isinstance(dst, DTensor):
        return distribute_tensor(src.to(dst.device, dst.dtype), dst.device_mesh,
                                 dst.placements)
    return src


def _restore_generator(gen: torch.Generator, saved: dict, step: int,
                       seed: int | None = None) -> None:
    if seed is not None:
        gen.manual_seed(seed + step)
    elif saved["device"] == gen.device.type:
        gen.set_state(saved["state"])
    else:
        warnings.warn(
            f"checkpoint written with a {saved['device']} generator, restoring into a "
            f"{gen.device.type} one: its state does not carry over, seeding it with "
            "initial_seed + step (dropout and augmentation draws will differ from the "
            "uninterrupted run's)", stacklevel=4)
        gen.manual_seed(saved["initial_seed"] + step)


def _replace_into(path: str, write) -> None:
    """Write through a temporary file in the same directory, then move it
    into place."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, best_metric: str = "accuracy"):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, int(max_to_keep))
        self.best_metric = best_metric
        os.makedirs(self.directory, exist_ok=True)
        self._index_path = os.path.join(self.directory, "index.json")
        self._metrics: dict[int, dict[str, float]] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._metrics = {int(k): v for k, v in json.load(f)["steps"].items()}
        # the index is written after its file: drop entries whose file is gone
        self._metrics = {s: m for s, m in self._metrics.items()
                         if os.path.exists(self._path(s))}

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def save(self, state: TrainState, metrics: dict[str, float] | None = None) -> None:
        """Write ``state``'s step. Under a layout every rank must call: the
        shards are gathered, rank 0 writes, and the others wait for it."""
        payload = _payload(state)
        step = int(state.step)
        if payload is not None:
            _replace_into(self._path(step), lambda f: torch.save(payload, f))
        self._metrics[step] = {k: float(v) for k, v in (metrics or {}).items()}
        keep = set(sorted(self._metrics)[-self.max_to_keep:]) | {self.best_step}
        for s in [s for s in self._metrics if s not in keep]:
            del self._metrics[s]
        if payload is not None:
            self._write_index()
            for name in os.listdir(self.directory):
                if name.startswith("step_") and name.endswith(".pt") \
                        and int(name[5:-3]) not in self._metrics:
                    os.unlink(os.path.join(self.directory, name))
        if state.layout is not None:
            state.layout.barrier()

    def _write_index(self) -> None:
        text = json.dumps({"best_metric": self.best_metric,
                           "steps": {str(s): m for s, m in sorted(self._metrics.items())}},
                          indent=1)
        _replace_into(self._index_path, lambda f: f.write(text.encode()))

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight when ``save`` returns."""

    @property
    def latest_step(self) -> int | None:
        return max(self._metrics) if self._metrics else None

    @property
    def best_step(self) -> int | None:
        """The step with the largest ``best_metric`` (the later one on a tie)."""
        if not self._metrics:
            return None
        return max(self._metrics, key=lambda s: (
            self._metrics[s].get(self.best_metric, float("-inf")), s))

    def metrics(self, step: int) -> dict[str, float]:
        """The metrics recorded with ``step``."""
        return dict(self._metrics[step])

    def _load(self, step: int | None) -> dict:
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore_model(self, model: torch.nn.Module, step: int | None = None) -> int:
        """Load only the model's parameters and buffers of ``step`` (default
        the latest) into ``model`` in place, as serving needs them: no
        optimizer or generator is built. Returns the step restored."""
        payload = self._load(step)
        model.load_state_dict(payload["model"])
        return int(payload["step"])

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Restore into ``state`` in place (it must be built from the same
        model and optimizer configuration) and return it. ``step=None``: the
        latest. The model's buffers change in place, so the mix layers derive
        their tables again at their next forward."""
        payload = self._load(step)
        state.step = int(payload["step"])
        self._restore_into(state, payload)
        state.scheduler.load_state_dict(_scheduler_groups(
            payload["scheduler"], len(state.optimizer.param_groups)))
        return state

    @staticmethod
    @torch.no_grad()
    def _restore_into(state: TrainState, payload: dict) -> None:
        """Each rank takes its shard of every tensor of a single-device
        file (the whole tensor where it holds one), and its own generator
        state."""
        from spectre_tpu_torch.models import FoldedMixLinear
        from spectre_tpu_torch.parallel.layout import rank_seed

        own = state.model.state_dict()
        saved = payload["model"]
        if set(own) != set(saved):
            raise KeyError(f"checkpoint does not match the model: missing "
                           f"{sorted(set(own) - set(saved))}, extra "
                           f"{sorted(set(saved) - set(own))}")
        for name, dst in own.items():
            dst.copy_(_like(saved[name], dst))
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        order = _model_order(state)
        osd = payload["optimizer"]
        saved_group = {k: v for k, v in osd["param_groups"][0].items() if k != "params"}
        groups, flat = [], 0
        for g in state.optimizer.param_groups:
            groups.append({**saved_group, "params": list(range(flat, flat + len(g["params"])))})
            flat += len(g["params"])
        state.optimizer.load_state_dict({
            "param_groups": groups,
            "state": {i: {k: v if k == "step" else _like(v, params[i])
                          for k, v in osd["state"][order[i]].items()}
                      for i in range(len(params)) if order[i] in osd["state"]}})
        for m in state.model.modules():
            if isinstance(m, FoldedMixLinear):
                m._wp = None
        rank, _ = world()
        # rank 0 reads ``generator``, as a single-device restore always has
        gens = [payload["generator"], *payload.get("generators", [])[1:]]
        if rank < len(gens):
            _restore_generator(state.dropout_generator, gens[rank], state.step)
        else:
            _restore_generator(state.dropout_generator, gens[0], state.step,
                               seed=rank_seed(gens[0]["initial_seed"], rank))
        if state.augment_generator is not None:
            _restore_generator(state.augment_generator,
                               payload.get("augment_generator", gens[0]), state.step)

    def close(self) -> None:
        """Nothing is held open between calls."""
