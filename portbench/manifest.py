"""Finds every piece of a cell by the names in ``BENCHMARK.json``:

- ``configs/<file>``: the configuration as it is run (the program's config
  file and its overrides, the numbers the reference computes from, the
  limits of the correctness check);
- ``traffic/<mix>.json``: the parameters of a traffic mix, read by the
  runner of its ``kind``, the module ``portbench.drive_<kind>``
  (``run.py::find_runner``: ``drive_train.py``, ``drive_serve.py``,
  ``drive_distill.py``);
- ``layer_metrics/<reader>.py``: the reader of a per-layer metric, found as
  the longest dotted prefix of the metric's name that names a file; the
  rest of the name, split at its dots, is passed to the reader's ``read``.

A configuration names the reference family of each model it runs
(``reference/<family>.py``; a distillation's teacher under ``teacher``).
Adding a configuration, a mix, a traffic kind, a reference family or a
metric is adding a file and an entry.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PACKAGE = os.path.basename(HERE)


@dataclass
class Cell:
    name: str
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's parameters
    chips: int
    root: str = ROOT      # the checkout the pieces were found in
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)


def load_manifest(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(manifest: dict, name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix and the metrics it
    reports; raises KeyError for an unknown cell."""
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, PACKAGE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    cell = Cell(name, config, traffic, int(w["chips"]), root)
    cell.end_to_end = [m for m in manifest["end_to_end"] if _covers(m, name)]
    cell.per_layer = [m for m in manifest["per_layer"] if _covers(m, name)]
    return cell


def reader_for(metric: str, reader_dir: str) -> tuple[str, list[str]]:
    """(path of the reader file, arguments) for a per-layer metric name."""
    parts = metric.split(".")
    for cut in range(len(parts), 0, -1):
        path = os.path.join(reader_dir, ".".join(parts[:cut]) + ".py")
        if os.path.isfile(path):
            return path, parts[cut:]
    raise FileNotFoundError(f"no reader in {reader_dir} for per-layer metric {metric!r}")


def load_reader(path: str):
    """The ``read`` function of a reader file."""
    name = "portbench_reader_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_per_layer(cell: Cell, record: dict) -> dict:
    """{metric: {"value", "unit"}} of the cell's per-layer metrics that found
    something to read in ``record``; a reader that finds nothing returns None
    and its metric is left out."""
    out = {}
    reader_dir = os.path.join(cell.root, PACKAGE, "layer_metrics")
    for metric in cell.per_layer:
        path, args = reader_for(metric["name"], reader_dir)
        value = load_reader(path)(record, *args)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out
