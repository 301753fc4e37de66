"""What every runner shares: seeds derived from ``--seed``, the program's
configuration checked against the benchmark's copy, the device record, the
look for JAX in the process, and the result line."""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "spectre_tpu")


@dataclass(frozen=True)
class Seeds:
    weights: int   # the benchmark's weights and mix tables
    data: int      # the dataset, or the clients' image pool
    shuffle: int   # the batch iterator's shuffle stream
    program: int   # the program's random seed: its augmentation and dropout draws
    clients: int   # the clients' request order and sampled replies


def derive_seeds(seed: int) -> Seeds:
    """Independent 63-bit seeds from any whole number."""
    words = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(10, dtype=np.uint32)
    vals = [(int(words[2 * i]) << 31) ^ int(words[2 * i + 1]) for i in range(5)]
    return Seeds(*vals)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def port_config(config: dict):
    """The program's configuration (``port_config``, a path from the
    checkout's root, with ``overrides``), refused where it states another
    number than the benchmark's file does for a key they share."""
    from spectre_tpu_torch.configs import parse_config
    from spectre_tpu_torch.data import DATASET_STATS

    from portbench.manifest import ROOT

    cfg = parse_config(os.path.join(ROOT, config["port_config"]))
    for key, value in config["overrides"].items():
        setattr(cfg, key, value)
    differ = [f"{k}: program {getattr(cfg, k)!r}, benchmark {v!r}"
              for group in ("model", "optimizer") for k, v in config[group].items()
              if hasattr(cfg, k) and not _same(getattr(cfg, k), v)]
    stats = DATASET_STATS.get(cfg.dataset)
    if stats is None or not _same(list(stats), [config["dataset_stats"]["mean"],
                                                config["dataset_stats"]["std"]]):
        differ.append(f"dataset statistics: program {stats!r}")
    if differ:
        raise RuntimeError("the program's configuration differs from the benchmark's: "
                           + "; ".join(differ))
    return cfg


def launches() -> dict:
    """The program's counts of its hand-written kernels' launches."""
    from spectre_tpu_torch.ops.kernels import launch_counts

    return launch_counts()


def print_launches(before: dict, after: dict, per: int, what: str) -> None:
    """The hand-written kernels' launches for each ``what`` of the window on
    standard error, a check of what the timed path ran."""
    counts = {k: (after[k] - before.get(k, 0)) / max(per, 1) for k in after
              if after[k] != before.get(k, 0)}
    print(f"launches a {what}: " + (", ".join(f"{k} {v:g}" for k, v in sorted(counts.items()))
                                    or "none"), file=sys.stderr)


def device_record(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def end_to_end(cell, values: dict) -> dict:
    """The cell's end-to-end metrics from the runner's ``values``; a metric
    the cell lists and the runner does not measure is an error."""
    missing = [m["name"] for m in cell.end_to_end if m["name"] not in values]
    if missing:
        raise RuntimeError(f"cell {cell.name} lists end-to-end metrics its runner does not "
                           f"measure: {missing}")
    return {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
            for m in cell.end_to_end}


def emit(result: dict, checks: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; then the result as the last line of standard output,
    with the checks under the key that comes last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    print(json.dumps(result), flush=True)
