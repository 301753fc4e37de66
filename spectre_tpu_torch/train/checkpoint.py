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

from spectre_tpu_torch.train.state import TrainState


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


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
        gen = state.dropout_generator
        payload = {
            "step": int(state.step),
            "model": _to_cpu(state.model.state_dict()),
            "optimizer": _to_cpu(state.optimizer.state_dict()),
            "scheduler": _to_cpu(state.scheduler.state_dict()),
            "generator": {"device": gen.device.type, "state": gen.get_state().cpu(),
                          "initial_seed": int(gen.initial_seed())},
        }
        _replace_into(self._path(payload["step"]), lambda f: torch.save(payload, f))
        self._metrics[payload["step"]] = {k: float(v) for k, v in (metrics or {}).items()}
        keep = set(sorted(self._metrics)[-self.max_to_keep:]) | {self.best_step}
        for step in [s for s in self._metrics if s not in keep]:
            del self._metrics[step]
        self._write_index()
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".pt") \
                    and int(name[5:-3]) not in self._metrics:
                os.unlink(os.path.join(self.directory, name))

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

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Restore into ``state`` in place (it must be built from the same
        model and optimizer configuration) and return it. ``step=None``: the
        latest. The model's buffers change in place, so the mix layers derive
        their tables again at their next forward."""
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        state.step = int(payload["step"])
        gen, saved = state.dropout_generator, payload["generator"]
        if saved["device"] == gen.device.type:
            gen.set_state(saved["state"])
        else:
            warnings.warn(
                f"checkpoint written with a {saved['device']} generator, restoring into a "
                f"{gen.device.type} one: its state does not carry over, seeding it with "
                "initial_seed + step (dropout and augmentation draws will differ from the "
                "uninterrupted run's)", stacklevel=2)
            gen.manual_seed(saved["initial_seed"] + state.step)
        return state

    def close(self) -> None:
        """Nothing is held open between calls."""
