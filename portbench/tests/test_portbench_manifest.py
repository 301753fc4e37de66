"""BENCHMARK.json against the benchmark's contract, every cell finding its
pieces by name, and a new configuration, mix and metric added as files and
entries alone."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench.manifest import PACKAGE, ROOT, find_cell, load_manifest, read_per_layer, reader_for

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keeps_to_the_contract():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == [PACKAGE] and m["command"] == ["python3", f"{PACKAGE}/run.py"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    names = [x["name"] for x in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(PACKAGE + "/") and _line(c["why"]) and _line(c["source"])
        assert any(w["config"] == c["name"] for w in m["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    e2e = {e["name"] for e in m["end_to_end"]}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(x["unit"]) and x["moves"] in e2e and _line(x["layer"])
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"
    assert len(json.dumps(m)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_pieces_by_name(cell):
    found = find_cell(MANIFEST, cell)
    assert os.path.isfile(os.path.join(ROOT, PACKAGE, f"drive_{found.traffic['kind']}.py"))
    names = {e["name"] for e in found.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and found.per_layer
    for metric in found.per_layer:
        assert metric["moves"] in names
        path, _ = reader_for(metric["name"], os.path.join(ROOT, PACKAGE, "layer_metrics"))
        assert os.path.isfile(path)
    assert set(found.config["limits"]) >= {found.traffic["kind"]}


def test_a_new_config_mix_and_metric_are_files_and_entries(tmp_path):
    pkg = tmp_path / PACKAGE
    for sub in ("configs", "traffic", "layer_metrics"):
        shutil.copytree(os.path.join(ROOT, PACKAGE, sub), pkg / sub)
    bench = json.loads(json.dumps(MANIFEST))
    conf = json.loads((pkg / "configs" / "spectre_vit_cifar100.json").read_text())
    conf["name"] = "spectre_vit_b128"
    (pkg / "configs" / "spectre_vit_b128.json").write_text(json.dumps(conf))
    mix = json.loads((pkg / "traffic" / "train_b256.json").read_text())
    (pkg / "traffic" / "train_b128.json").write_text(json.dumps(dict(mix, batch_size=128)))
    (pkg / "layer_metrics" / "steps_counted.py").write_text(
        "def read(record, kind):\n    return record['steps'] if record['kind'] == kind else None\n")
    bench["configs"].append({"name": "spectre_vit_b128", "source": "https://example.org",
                             "file": f"{PACKAGE}/configs/spectre_vit_b128.json", "reduced": [],
                             "why": "w"})
    bench["workloads"].append({"name": "new.train", "config": "spectre_vit_b128",
                               "traffic": "train_b128", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "steps_counted.train", "unit": "steps",
                               "better": "higher", "source": "host_clock", "layer": "trainer step",
                               "moves": "train_img_s", "workloads": ["new.train"]})
    for e in bench["end_to_end"] + bench["per_layer"]:
        if e["name"] in ("train_img_s", "input_wait_ms.train", "elementwise_ms.train"):
            e["workloads"].append("new.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = find_cell(load_manifest(str(tmp_path / "BENCHMARK.json")), "new.train", str(tmp_path))
    assert cell.traffic["batch_size"] == 128 and cell.config["name"] == "spectre_vit_b128"
    record = {"kind": "train", "steps": 7, "window_s": 1.0, "batch": 128,
              "model": cell.config["model"], "input_wait_s": 0.07, "issue_s": 0.7}
    got = read_per_layer(cell, record)
    assert got["steps_counted.train"]["value"] == 7
    assert got["input_wait_ms.train"]["value"] == pytest.approx(10.0)
    assert "elementwise_ms.train" not in got  # no trace: its reader finds nothing


def test_config_files_hold_the_numbers_the_program_runs():
    from portbench.common import port_config

    for c in MANIFEST["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        port_config(conf)  # raises where the program states another number
        bad = json.loads(json.dumps(conf))
        bad["model"]["embed_dim"] += 1
        with pytest.raises(RuntimeError, match="embed_dim"):
            port_config(bad)
