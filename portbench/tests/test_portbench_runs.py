"""Whole runs of the runners on the CPU at a tiny size, with the harness's
look for a card skipped: the result line's schema, a sound run read as
correct, the reference against the program's plain path, and each fault
that a cell can have planted underneath the timed path and read as not
correct. Also the look for JAX in a process that loads everything the
harness runs."""

from __future__ import annotations

import ast
import glob
import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from portbench import drive_serve, drive_train
from portbench.common import emit, forbidden_modules
from portbench.manifest import PACKAGE, ROOT, find_cell, load_manifest
from portbench.tests.tiny import tiny_root

SEED = 2**31 + 12345  # beyond 32 signed bits, as a run's seeds may be


def _cell(tmp_path, name, config="spectre_vit_cifar100", **model):
    root = tiny_root(str(tmp_path), config, **model)
    return find_cell(load_manifest(os.path.join(root, "BENCHMARK.json")), name, root)


def _run(cell, trace=False):
    runner = drive_train if cell.traffic["kind"] == "train" else drive_serve
    return runner.run(cell, SEED, 0.5, trace, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name,trace", [("tiny.train", False), ("tiny.train", True),
                                        ("tiny.serve", False)])
def test_result_line_schema(tmp_path, name, trace):
    cell = _cell(tmp_path, name)
    result, checks = _run(cell, trace)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        emit(result, checks)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= wanted and all(
        set(v) == {"value", "unit"} for v in line["metrics"].values())
    if not trace:
        assert set(line["metrics"]) == wanted
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    last = err.getvalue().strip().splitlines()[-len(checks):]
    assert all(ln.startswith("check ") and " limit " in ln for ln in last)
    assert set(line["checks"]) == set(cell.config["limits"][cell.traffic["kind"]])


@pytest.mark.parametrize("config", ["spectre_vit_cifar100", "vit_cifar100"])
def test_reference_matches_the_programs_plain_path_in_float32(tmp_path, config):
    """With the program computing in float32 too, every number of the check
    reads at rounding: the reference makes the same draws, batches and
    update as the program's step."""
    cell = _cell(tmp_path, "tiny.train", config, compute_dtype="float32")
    result, checks = _run(cell)
    assert result["correct"]
    assert max(c["value"] for c in checks.values()) < 1e-5, checks


def test_served_replies_match_the_reference_in_float32(tmp_path):
    cell = _cell(tmp_path, "tiny.serve", compute_dtype="float32")
    result, checks = _run(cell)
    assert result["correct"] and checks["logits"]["value"] < 1e-5, checks


def test_state_left_unchanged_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    result, checks = _run(_cell(tmp_path, "tiny.train", compute_dtype="float32"))
    assert not result["correct"] and not checks["update"]["ok"]


def test_half_the_batch_left_out_is_not_correct(tmp_path, monkeypatch):
    from spectre_tpu_torch.train import loop

    make = loop.make_train_step

    def halved(*args, **kw):
        step = make(*args, **kw)
        return lambda state, images, labels: step(state, images[: len(images) // 2],
                                                  labels[: len(labels) // 2])

    monkeypatch.setattr(loop, "make_train_step", halved)
    result, checks = _run(_cell(tmp_path, "tiny.train", compute_dtype="float32"))
    assert not result["correct"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(tmp_path, monkeypatch):
    from spectre_tpu_torch.serving.torch_server import TorchServer

    dispatch = TorchServer._dispatch

    def altered(self, x, parts):
        parts_, host, events = dispatch(self, x, parts)
        with torch.inference_mode():
            host[0][0, 0] += 1.0  # one logit of the bucket's first image
        return parts_, host, events

    monkeypatch.setattr(TorchServer, "_dispatch", altered)
    result, checks = _run(_cell(tmp_path, "tiny.serve", compute_dtype="float32"))
    assert not result["correct"] and not checks["logits"]["ok"]


def test_harness_loads_no_jax():
    """Everything the harness and the program's paths it drives import, in a
    fresh process: no top-level name is jax, jaxlib, flax or spectre_tpu."""
    mods = sorted(f"{PACKAGE}." + os.path.relpath(p, os.path.join(ROOT, PACKAGE))[:-3]
                  .replace(os.sep, ".")
                  for p in glob.glob(os.path.join(ROOT, PACKAGE, "**", "*.py"), recursive=True)
                  if "/tests/" not in p and not p.endswith("__init__.py")
                  and "/layer_metrics/" not in p)
    code = ("import sys, json\n" + "".join(f"import {m}\n" for m in mods)
            + "import spectre_tpu_torch.train.loop, spectre_tpu_torch.serving.torch_server\n"
            + "from portbench.manifest import load_reader\n"
            + "import glob\n"
            + f"[load_reader(p) for p in glob.glob('{ROOT}/{PACKAGE}/layer_metrics/*.py')]\n"
            + "from portbench.common import forbidden_modules\n"
            + "print(json.dumps(forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "spectre_tpu_torchx", sys)
    assert "spectre_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert "flax" in forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, PACKAGE, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for name in names:
                assert name.split(".")[0] in ("torch", "numpy", "math", "importlib",
                                              "collections", "__future__", PACKAGE), (path, name)
