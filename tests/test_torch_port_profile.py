"""The port's profiling layer (spectre_tpu_torch/profile) against the JAX
package's: ``trace_step`` on the CPU writes a Kineto trace; on a
``torch.profiler`` trace recorded here both ``ProfilerParser``s give the same
names, calls and host milliseconds; on a hand-written Kineto trace with a GPU
lane the device split follows the event categories; the chainable API,
``filter_name``, ``to_csv`` and ``to_pandas`` (refused by name without
pandas)."""

import csv
import json
import sys

import pytest
import torch

from spectre_tpu.profile import ProfilerParser as JaxProfilerParser
from spectre_tpu_torch.profile import ProfilerParser, trace_step
from spectre_tpu_torch.profile.parser import COLUMNS


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    x = torch.ones(64, 64)
    torch.sin(x @ x.T).sum()  # first call outside the trace
    with trace_step(str(d), device="cpu") as t:
        torch.sin(x @ x.T).sum()
    return d, t


def test_trace_step_writes_a_kineto_trace(traced):
    d, t = traced
    assert t.path == str(d) and t.trace_file.startswith(str(d))
    assert t.trace_file.endswith(".pt.trace.json")
    with open(t.trace_file) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" and e.get("ph") == "X" for e in events)
    assert t.profiler.key_averages()  # the profiler itself, for its own totals


def test_trace_step_on_a_card_refuses_without_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        with trace_step(str(tmp_path), device="cuda"):
            pass


def test_cpu_trace_table_equals_the_jax_parsers(traced):
    d, _ = traced
    rows = ProfilerParser(str(d)).rows
    want = JaxProfilerParser(str(d)).to_pandas()
    assert [r["name"] for r in rows] == list(want["name"])
    assert [r["calls"] for r in rows] == list(want["calls"])
    assert [r["host_total_ms"] for r in rows] == list(want["host_total_ms"])
    assert "aten::mm" in [r["name"] for r in rows]
    assert all(r["device_total_ms"] == 0.0 for r in rows)


def _kineto_trace(path):
    """A Kineto-shaped trace: a host lane with operators and runtime calls, a
    GPU lane (pid 0) with two launches of one kernel, a copy, a fill and an
    annotation over the device's span."""
    host, gpu = 4242, 0
    events = [
        {"ph": "M", "name": "process_name", "pid": host, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": gpu, "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": host, "tid": 1, "ts": 0,
         "dur": 30.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": host, "tid": 1, "ts": 40,
         "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": host, "tid": 1,
         "ts": 5, "dur": 4.0},
        {"ph": "X", "cat": "kernel", "name": "void gemm_kernel<float>(float*)", "pid": gpu,
         "tid": 7, "ts": 10, "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "void gemm_kernel<float>(float*)", "pid": gpu,
         "tid": 7, "ts": 600, "dur": 250.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "pid": gpu, "tid": 8, "ts": 900, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": gpu, "tid": 8,
         "ts": 1000, "dur": 150.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step#AdamW.step",
         "pid": gpu, "tid": 9, "ts": 0, "dur": 2000.0},
        {"ph": "X", "cat": "kernel", "name": "idle", "pid": gpu, "tid": 7, "ts": 1200,
         "dur": 9.0},
        {"ph": "s", "cat": "ac2g", "name": "launch", "pid": host, "tid": 1, "ts": 5, "id": 1},
    ]
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return path


def test_device_split_on_a_kineto_trace_with_a_gpu_lane(tmp_path):
    p = ProfilerParser(str(_kineto_trace(tmp_path / "x.pt.trace.json")))
    rows = {r["name"]: r for r in p.rows}
    gemm = rows["void gemm_kernel<float>(float*)"]
    assert (gemm["calls"], gemm["host_total_ms"]) == (2, 0.0)
    assert gemm["device_total_ms"] == pytest.approx(0.75)
    assert gemm["avg_device_ms"] == pytest.approx(0.375)
    assert rows["Memcpy HtoD (Pageable -> Device)"]["device_total_ms"] == pytest.approx(0.1)
    assert rows["Memset (Device)"]["device_total_ms"] == pytest.approx(0.15)
    mm = rows["aten::mm"]
    assert (mm["calls"], mm["device_total_ms"]) == (2, 0.0)
    assert mm["host_total_ms"] == pytest.approx(0.04)
    assert rows["cudaLaunchKernel"]["device_total_ms"] == 0.0
    assert "Optimizer.step#AdamW.step" not in rows  # an annotation, not device work
    assert "launch" not in rows  # flow events are no spans
    kept = p.remove_idle()
    assert "idle" in rows and "idle" not in {r["name"] for r in kept.rows}
    assert sum(r["device_total_ms"] for r in kept.rows) == pytest.approx(1.0)


def test_chainable_api_filter_and_csv(tmp_path, capsys):
    path = _kineto_trace(tmp_path / "x.pt.trace.json")
    p = (ProfilerParser(str(tmp_path)).remove_idle().add_percentages().round(2)
         .sort_by_device().head(3))
    rows = p.rows
    assert len(rows) == 3 and list(rows[0]) == list(COLUMNS) + ["device_pct"]
    assert [r["name"] for r in rows][0] == "void gemm_kernel<float>(float*)"
    assert [r["device_pct"] for r in rows] == [75.0, 15.0, 10.0]
    assert [r["device_total_ms"] for r in rows] == sorted(
        (r["device_total_ms"] for r in rows), reverse=True)
    host = ProfilerParser(str(path)).sort_by_host().rows
    assert host[0]["name"] == "aten::mm"
    p.show()
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == list(COLUMNS) + ["device_pct"] and len(out) == 4
    dest = tmp_path / "sub" / "ops.csv"
    ProfilerParser(str(path)).filter_name("^aten|Mem").to_csv(str(dest))
    with open(dest) as f:
        read = list(csv.DictReader(f))
    assert [r["name"] for r in read] == ["Memcpy HtoD (Pageable -> Device)",
                                        "Memset (Device)", "aten::mm"]
    assert float(read[2]["host_total_ms"]) == pytest.approx(0.04)
    df = ProfilerParser(str(path)).filter_name("gemm").to_pandas()
    assert list(df.columns) == list(COLUMNS) and df["calls"].tolist() == [2]


def test_to_pandas_refuses_by_name_without_pandas(tmp_path, monkeypatch):
    p = ProfilerParser(str(_kineto_trace(tmp_path / "x.pt.trace.json")))
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="to_pandas needs pandas"):
        p.to_pandas()
    p.show().to_csv(str(tmp_path / "ok.csv"))  # the rest needs no pandas
    assert (tmp_path / "ok.csv").exists()


def test_missing_trace_is_named(tmp_path):
    with pytest.raises(FileNotFoundError, match="trace.json"):
        ProfilerParser(str(tmp_path))
