"""Metrics writer (port of spectre_tpu/utils/metrics.py).

The same metric surface as the JAX package: scalars ``Loss/{Train,Validation}``
and ``Accuracy/{Train,Validation}``, a terminal ``Training time`` scalar, the
run name that encodes the hyperparameters, and the throughput scalars
``Perf/steps_per_sec`` and ``Perf/images_per_sec_per_chip``.

Backend: tensorboardX when importable, always mirrored to a JSONL event log
(``events.jsonl``), so that a run stays observable without TensorBoard.
"""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

try:
    from tensorboardX import SummaryWriter  # type: ignore
except Exception:  # pragma: no cover - environment without tensorboardX
    SummaryWriter = None


def experiment_name(config: SimpleNamespace) -> str:
    """Run name that encodes the hyperparameters."""
    parts = [
        getattr(config, "model", "model"),
        getattr(config, "dataset", "data"),
        f"m{getattr(config, 'method', 'none')}",
        f"e{config.embed_dim}",
        f"l{config.num_encoders}",
        f"h{config.num_heads}",
        f"p{config.patch_size}",
        f"b{config.batch_size}",
        f"lr{getattr(config, 'learning_rate', 1e-3):g}",
    ]
    return "_".join(str(p) for p in parts)


class MetricsWriter:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._tb = (SummaryWriter(logdir)
                    if (use_tensorboard and SummaryWriter is not None) else None)
        self._jsonl = open(os.path.join(logdir, "events.jsonl"), "a")
        self._t0 = time.time()

    def scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"t": round(time.time() - self._t0, 3), "step": int(step),
                                      "tag": tag, "value": value}) + "\n")

    def scalars(self, prefix: str, metrics: dict, step: int) -> None:
        for k, v in metrics.items():
            self.scalar(f"{prefix}/{k}", v, step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
