"""The rate, tail and idle arithmetic on synthetic records: over all requests
and the whole window, not over chunks."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import tracing
from portbench.drive_serve import window_stats
from portbench.manifest import ROOT, PACKAGE, load_reader


def _reader(name):
    return load_reader(f"{ROOT}/{PACKAGE}/layer_metrics/{name}.py")


def test_window_counts_requests_answered_inside_it():
    # client 0: steady 10 ms requests; client 1: one 900 ms stall in the middle
    c0 = {"sent": [i * 0.01 for i in range(100)], "done": [i * 0.01 + 0.01 for i in range(100)],
          "answered": [64] * 100}
    c1 = {"sent": [0.0, 0.05, 0.95, 0.99], "done": [0.05, 0.95, 0.99, 1.2],
          "answered": [64, 64, 64, 64]}
    s = window_stats([c0, c1], 0.0, 1.0)
    assert s["attempted"] == 104 and s["failed"] == 0
    # the request still in flight at the window's end is attempted, not answered
    assert s["images"] == 64 * 103
    lat = sorted(s["latencies"])
    assert len(lat) == 103 and lat[-1] == pytest.approx(0.9)
    # the tail of all requests, not a mean of per-chunk tails
    assert np.percentile(lat, 95) == pytest.approx(0.01)
    assert np.percentile(lat, 99.5) > 0.04


def test_failed_and_early_requests():
    rec = {"sent": [-0.5, 0.1, 0.2], "done": [0.05, 0.15, 0.3], "answered": [64, 0, 64]}
    s = window_stats([rec], 0.0, 1.0)
    assert (s["attempted"], s["failed"], s["images"]) == (2, 1, 64)


def _trace(tmp_path, device, host=()):
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 1000.0,
               "dur": 1000.0}]
    events += [{"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
               for name, cat, ts, dur in device]
    events += [{"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur}
               for name, ts, dur in host]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.summarize(str(path))


def test_idle_is_one_minus_the_union_of_device_intervals(tmp_path):
    t = _trace(tmp_path, [
        ("void chain_kernel<float>()", "kernel", 900.0, 200.0),     # clipped to 1000-1100
        ("void at::native::reduce_kernel<1>()", "kernel", 1050.0, 100.0),  # overlaps: to 1150
        ("Memcpy HtoD", "gpu_memcpy", 1500.0, 100.0),
        ("nvjet_gemm", "kernel", 1800.0, 300.0),                     # clipped to 1800-2000
    ], host=[("aten::copy_", 1150.0, 400.0), ("cudaStreamSynchronize", 1200.0, 100.0)])
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx((150 + 100 + 200) * 1e-6)
    idle = _reader("idle_pct")({"kind": "train", "trace": t}, "train")
    assert idle == pytest.approx(55.0)
    assert t["classes"]["hand_written"] == pytest.approx(100e-6)
    assert t["classes"]["pytorch"] == pytest.approx(100e-6)
    assert t["classes"]["memcpy"] == pytest.approx(100e-6)
    assert [g[1] for g in t["idle_gaps"]] == pytest.approx([350e-6, 200e-6])
    # each gap is named by the innermost host event over its middle
    assert [g[0] for g in t["idle_gaps"]] == ["aten::copy_", "no host event"]
    assert t["device_ops"][0] == ["nvjet_gemm", pytest.approx(200e-6)]


def test_readers_on_a_synthetic_record():
    m = json.load(open(f"{ROOT}/{PACKAGE}/configs/spectre_vit_cifar100.json"))["model"]
    rec = {"kind": "train", "model": m, "batch": 1024, "steps": 10, "window_s": 1.0,
           "input_wait_s": 0.01, "issue_s": 0.2, "trace_steps": 2,
           "trace": {"classes": {"pytorch": 0.08},
                     "kernels": {"void fused_linear_wgmma_kernel<1>()": ["kernel", 0.01, 16],
                                 "void chain_kernel<1>()": ["kernel", 0.01, 18]}}}
    mfu = _reader("mfu")(rec, "train")
    assert mfu == pytest.approx(100 * 9.23e12 * 10 / 989e12, rel=1e-3)
    assert _reader("mfu")(rec, "serve") is None
    assert _reader("elementwise_ms")(rec, "train") == pytest.approx(40.0)
    assert _reader("host_issue_ms")(rec, "train") == pytest.approx(20.0)
    share = _reader("spectre_linear_roofline")(rec)
    assert 0 < share < 100
    assert _reader("attention_roofline")(rec) is None
    assert _reader("serve.images_per_bucket")({"kind": "serve", "images": 2560,
                                               "forwards": 10}) == 256.0
