"""The program's spans read from a Kineto trace (``portbench/spans.py``) on a
hand-written trace with a GPU lane, a main thread and an autograd thread:
device work tied to spans by its launch, backward work tied to an ``op/*``
span through the autograd sequence number, idle time under the input
pipeline's and the step's spans, and what falls under none. Also
``tracing.summarize`` unmoved by the spans, and the six span readers on a
hand-made record, with the op roofline's least time pinned."""

from __future__ import annotations

import importlib.util
import json

import pytest

from portbench import spans, tracing
from portbench.manifest import PACKAGE, ROOT, load_reader
from portbench.roofline import BF16_FLOPS, HBM_BYTES_PER_S, spectre_linear_step_s

HOST, GPU, MAIN, AUTOGRAD = 100, 0, 1, 2


def _x(cat, name, ts, dur, tid=MAIN, pid=HOST, **args):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": float(ts),
         "dur": float(dur)}
    if args:
        e["args"] = args
    return e


def _launch(corr, ts, tid=MAIN):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 3, tid, correlation=corr)


def _kernel(corr, name, ts, dur, cat="kernel", stream=7):
    return _x(cat, name, ts, dur, stream, GPU, correlation=corr)


PROGRAM = [  # (name, start, end) on the main thread, all inside the window [0, 1000)
    ("data/gather", 10, 60), ("data/stage", 70, 120), ("data/slot_wait", 75, 95),
    ("step", 130, 890), ("step/augment", 135, 200), ("step/forward", 200, 400),
    ("op/mix", 210, 300), ("op/spectre_linear", 310, 380), ("step/backward", 400, 800),
    ("step/optimizer", 800, 885)]


def _events(program=True):
    ev = [{"ph": "M", "name": "process_name", "pid": GPU, "args": {"name": "GPU 0"}},
          _x("user_annotation", tracing.WINDOW, 0, 1000),
          _x("gpu_user_annotation", "step", 130, 700, 9, GPU),  # drawn on the GPU lane
          _x("user_annotation", "Optimizer.step#AdamW.step", 805, 75),  # not the program's
          _x("cpu_op", "aten::empty", 0, 10)]
    if program:
        ev += [_x("user_annotation", n, a, b - a) for n, a, b in PROGRAM]
    fwd = {"Fwd thread id": 0}
    bwd = {"Fwd thread id": 1}
    ev += [
        # forward operators and their sequence numbers
        _x("cpu_op", "aten::mm", 220, 20, **{"Sequence number": 5}, **fwd),
        _x("cpu_op", "aten::to", 305, 3, **{"Sequence number": 6}, **fwd),
        _x("cpu_op", "_FusedSpectreLinear", 320, 50, **{"Sequence number": 6}, **fwd),
        _x("cpu_op", "aten::add", 390, 5, **{"Sequence number": 7}, **fwd),
        # the autograd engine's thread: backward functions, one op of their own
        _x("cpu_op", spans.EVALUATE + "_FusedSpectreLinearBackward", 410, 90, AUTOGRAD,
           **{"Sequence number": 6}, **bwd),
        _x("cpu_op", "_FusedSpectreLinearBackward", 412, 80, AUTOGRAD,
           **{"Sequence number": 6}, **bwd),
        _x("cpu_op", spans.EVALUATE + "MmBackward0", 510, 90, AUTOGRAD,
           **{"Sequence number": 5}, **bwd),
        _x("cpu_op", spans.EVALUATE + "AddBackward0", 610, 40, AUTOGRAD,
           **{"Sequence number": 7}, **bwd),
        # launches and what they ran
        _x("cuda_runtime", "cudaMemcpyAsync", 100, 3, correlation=1),
        _kernel(1, "Memcpy HtoD (Pinned -> Device)", 100, 30, "gpu_memcpy", 8),
        _launch(2, 140), _kernel(2, "void augment_kernel()", 150, 40),
        _launch(3, 225), _kernel(3, "void mix_fwd_kernel()", 230, 50),
        _launch(4, 330), _kernel(4, "void fused_linear_wgmma_kernel<1>()", 330, 40),
        _launch(5, 392), _kernel(5, "void loss_kernel()", 395, 5),
        _launch(6, 420, AUTOGRAD), _kernel(6, "void chain_kernel<1>()", 420, 60),
        _launch(7, 520, AUTOGRAD), _kernel(7, "void mix_bwd_kernel()", 520, 70),
        _launch(8, 615, AUTOGRAD), _kernel(8, "void add_kernel()", 615, 25),
        _launch(9, 700, AUTOGRAD), _kernel(9, "void accumulate_kernel()", 700, 20),
        _launch(10, 810), _kernel(10, "void adamw_kernel()", 810, 70),
        _launch(11, 895), _kernel(11, "void after_step_kernel()", 900, 50),
        _kernel(99, "void lost_kernel()", 960, 10),  # its launch is not in the trace
        {"ph": "s", "cat": "ac2g", "name": "launch", "pid": HOST, "tid": MAIN, "ts": 140,
         "id": 2},
    ]
    return ev


@pytest.fixture(scope="module")
def summary():
    return spans.summarize_spans(_events())


def _us(x):
    return pytest.approx(x * 1e-6)


def test_device_work_is_tied_to_the_spans_of_its_launch(summary):
    s = summary["spans"]
    assert summary["device_events"] == 12 and summary["device_s"] == _us(470)
    assert summary["clock_lead_s"] == 0.0  # no kernel starts before its launch
    assert s["data/stage"]["device_s"] == _us(30)  # the copy issued in data/stage
    assert s["data/stage"]["ops"] == [["Memcpy HtoD", _us(30)]]
    assert s["data/gather"]["device_s"] == 0.0 and s["data/slot_wait"]["device_s"] == 0.0
    assert s["step/augment"]["device_s"] == _us(40)
    assert s["step/forward"]["device_s"] == _us(50 + 40 + 5)
    assert s["step/forward"]["self_device_s"] == _us(5)
    assert s["step/optimizer"]["device_s"] == _us(70)
    assert s["step"]["device_s"] == _us(40 + 95 + 175 + 70)
    assert (s["step"]["calls"], s["step"]["host_s"]) == (1, _us(760))
    assert "Optimizer.step#AdamW.step" not in s


def test_backward_work_reaches_its_op_through_the_sequence_number(summary):
    s = summary["spans"]
    # a launch on the autograd thread falls under the main thread's step/backward
    assert s["step/backward"]["device_s"] == _us(60 + 70 + 25 + 20)
    assert s["step/backward"]["self_device_s"] == _us(25 + 20)
    # and the forward op of its sequence number gives it an op: the latest
    # forward operator with the number, never the backward's own
    lin = s["op/spectre_linear"]
    assert lin["device_s"] == _us(40 + 60)
    assert dict((k, v) for k, v in lin["ops"]) == {
        "fused_linear_wgmma_kernel": _us(40), "chain_kernel": _us(60)}
    assert s["op/mix"]["device_s"] == _us(50 + 70)
    assert summary["groups"]["op"]["device_s"] == _us(220)
    assert s["op/mix"]["phases"] == {"step/forward": _us(50), "step/backward": _us(70)}
    # the call site: the backward node and the operators around the launch
    assert sorted((op, site) for op, site, _ in lin["sites"]) == [
        ("chain_kernel", "_FusedSpectreLinearBackward"),
        ("fused_linear_wgmma_kernel", "_FusedSpectreLinear")]
    assert [site for _, site, _ in s["op/mix"]["sites"]] == ["MmBackward0", "aten::mm"]
    assert s["step/backward"]["sites"][0][1] == "AddBackward0"
    assert [site for _, site, _ in s["step/forward"]["sites"]] == ["aten::add"]
    assert s["step/optimizer"]["sites"] == [["adamw_kernel", "no operator", _us(70)]]


def test_idle_time_under_the_input_pipeline_and_the_step(summary):
    s, g = summary["spans"], summary["groups"]
    assert summary["idle_s"] == _us(530)
    assert g["data"]["idle_s"] == _us(50 + 30)  # gather 10-60, stage 70-100
    assert s["data/stage"]["idle_s"] == _us(30) and s["data/slot_wait"]["idle_s"] == _us(20)
    assert s["data/stage"]["self_idle_s"] == _us(10)
    assert g["step"]["idle_s"] == _us(20 + 40 + 50 + 25 + 20 + 40 + 25 + 60 + 90 + 10)
    assert s["step/backward"]["idle_s"] == _us(20 + 40 + 25 + 60 + 80)
    assert s["op/mix"]["idle_s"] == _us(20 + 20)
    assert s["step/optimizer"]["idle_s"] == _us(10 + 5)


def test_what_falls_under_no_span(summary):
    u = summary["unattributed"]
    assert u["device_s"] == _us(50 + 10) and u["no_launch_s"] == _us(10)
    assert {k for k, _ in u["ops"]} == {"after_step_kernel", "lost_kernel"}
    assert u["idle_s"] == _us(10 + 10 + 10 + 10 + 30)
    # the host's innermost event over each stretch: the launch of the kernel
    # that runs after the step, and nothing at all at the window's end
    assert dict((k, v) for k, v in u["host"]) == {
        "aten::empty": _us(10), "cudaLaunchKernel": _us(10), "no host event": _us(50)}


def test_a_trace_without_program_spans(tmp_path):
    s = spans.summarize_spans(_events(program=False))
    assert s["spans"] == {} and s["groups"] == {}
    assert s["unattributed"]["device_s"] == _us(470) and s["unattributed"]["idle_s"] == _us(530)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    assert spans.read_spans(str(path)) == spans.summarize_spans(_events())


def test_summarize_is_unmoved_by_the_spans(tmp_path):
    with_spans, without = tmp_path / "a.json", tmp_path / "b.json"
    with_spans.write_text(json.dumps({"traceEvents": _events()}))
    without.write_text(json.dumps({"traceEvents": _events(program=False)}))
    a, b = tracing.summarize(str(with_spans)), tracing.summarize(str(without))
    gaps_a, gaps_b = a.pop("idle_gaps"), b.pop("idle_gaps")
    assert a == b
    assert [g[1] for g in gaps_a] == [g[1] for g in gaps_b]
    # only the gaps' names change: the spans now name gaps no operator covers
    assert {g[0] for g in gaps_a} & {n for n, _, _ in PROGRAM}
    assert "no host event" in {g[0] for g in gaps_b}


def _reader(name):
    return load_reader(f"{ROOT}/{PACKAGE}/layer_metrics/{name}.py")


def _flagship():
    with open(f"{ROOT}/{PACKAGE}/configs/spectre_vit_cifar100.json") as f:
        return json.load(f)["model"]


def _record(**over):
    row = {"calls": 2, "host_s": 0.1, "self_device_s": 0.0, "idle_s": 0.0,
           "self_idle_s": 0.0, "ops": []}
    table = {"step/augment": dict(row, device_s=0.004),
             "op/mix": dict(row, device_s=0.030),
             "step/optimizer": dict(row, device_s=0.006),
             "op/spectre_linear": dict(row, device_s=0.016584712089403744)}
    found = {"spans": table, "device_events": 100, "device_s": 0.1, "idle_s": 0.03,
             "groups": {"data": {"device_s": 0.001, "idle_s": 0.012},
                        "step": {"device_s": 0.09, "idle_s": 0.008}},
             "unattributed": {}}
    rec = {"kind": "train", "model": _flagship(), "batch": 1024, "steps": 10,
           "window_s": 1.0, "trace_steps": 2, "trace": {"spans": found}}
    rec.update(over)
    return rec


def test_the_six_readers_on_a_hand_made_record():
    rec = _record()
    assert _reader("idle_under_ms")(rec, "train", "input") == pytest.approx(6.0)
    assert _reader("idle_under_ms")(rec, "train", "step") == pytest.approx(4.0)
    assert _reader("device_ms")(rec, "train", "augment") == pytest.approx(2.0)
    assert _reader("device_ms")(rec, "train", "mix") == pytest.approx(15.0)
    assert _reader("device_ms")(rec, "train", "optimizer") == pytest.approx(3.0)
    # two steps' least time over 16.58 ms under op/spectre_linear: half of the roofline
    assert _reader("spectre_linear_op_roofline")(rec) == pytest.approx(50.0)


@pytest.mark.parametrize("rec", [
    _record(trace={}),                                   # not traced
    _record(trace={"kernels": {}}),                      # traced without the spans' summary
    _record(kind="serve"),
    _record(trace={"spans": {"spans": {}, "groups": {}, "device_events": 0}}),  # no card
])
def test_the_readers_find_nothing_where_there_is_nothing(rec):
    assert _reader("idle_under_ms")(rec, "train", "input") is None
    assert _reader("device_ms")(rec, "train", "mix") is None
    assert _reader("spectre_linear_op_roofline")(rec) is None


def test_a_span_that_did_not_run_reads_nothing():
    rec = _record()
    found = rec["trace"]["spans"]
    del found["spans"]["op/mix"], found["groups"]["data"]
    assert _reader("device_ms")(rec, "train", "mix") is None
    assert _reader("idle_under_ms")(rec, "train", "input") is None


def test_op_least_time_of_the_flagship_at_1024():
    """Per layer, linear1 (M = 1,024 x 65 = 66,560 rows, K 512, N 768) and
    linear3 (K 768, N 512) each add to the forward and chain of
    ``spectre_linear_step_s`` (1.2233 ms for the step): four products of
    2 M K N = 52.34 GFLOP (dW, dx, the pool matrix's x P and g P^T), each
    bound by operations at 52.93 us; dW's float32 cast, 6 K N bytes, 0.70
    us; out + pool and dx + pool, 6 M N and 6 M K bytes, 91.55 and 61.04
    us. 365.0 us a call, 8 calls; the head (1,024 x 512 -> 100) 2.86 us.
    4.1462 ms in all."""
    spec = importlib.util.spec_from_file_location(
        "op_roofline", f"{ROOT}/{PACKAGE}/layer_metrics/spectre_linear_op_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    m = _flagship()
    rows, mk, mn, kn = 66_560, 66_560 * 512, 66_560 * 768, 512 * 768
    gemm = max(2 * (mk + mn + kn) / HBM_BYTES_PER_S, 2 * rows * 512 * 768 / BF16_FLOPS)
    assert gemm == pytest.approx(52.93e-6, rel=1e-3)
    call = 4 * gemm + 6 * kn / HBM_BYTES_PER_S + 6 * (mn + mk) / HBM_BYTES_PER_S
    assert call == pytest.approx(365.0e-6, rel=1e-3)
    head = mod.op_step_s(dict(m, num_encoders=0), 1024) - spectre_linear_step_s(
        dict(m, num_encoders=0), 1024)
    assert head == pytest.approx(2.86e-6, rel=1e-2)
    assert mod.op_step_s(m, 1024) == pytest.approx(
        spectre_linear_step_s(m, 1024) + 8 * call + head, rel=1e-9)
    assert mod.op_step_s(m, 1024) == pytest.approx(4.1462e-3, rel=1e-4)


def test_a_device_clock_converted_early_shows_as_a_lead():
    ev = [_x("user_annotation", tracing.WINDOW, 0, 1000), _x("user_annotation", "step", 50, 200),
          _launch(1, 100), _kernel(1, "void early_kernel()", 95, 20)]
    s = spans.summarize_spans(ev)
    assert s["clock_lead_s"] == _us(5) and s["spans"]["step"]["device_s"] == _us(20)


def test_the_span_report_on_a_tiny_cell(tmp_path, capsys):
    from portbench import span_report
    from portbench.tests.tiny import tiny_root

    root = tiny_root(str(tmp_path / "root"))
    out = tmp_path / "spans.json"
    assert span_report.main(["--workload", "tiny.train", "--seed", str(2**31 + 7), "--device",
                             "cpu", "--steps", "2", "--turns", "spans,stubbed", "--root", root,
                             "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    turns = [json.loads(ln) for ln in lines[:2]]
    assert [t["turn"] for t in turns] == ["spans", "stubbed"]
    assert set(turns[0]["metrics"]) == set(span_report.SPAN_METRICS)
    report = json.loads(out.read_text())
    with_spans, stubbed = (t["trace"]["spans"]["spans"] for t in report["turns"])
    assert with_spans["step"]["calls"] == 2 and with_spans["op/spectre_linear"]["calls"] == 6
    assert stubbed == {}  # the program's spans off while the profiler records
    assert any(ln.startswith("op/mix") for ln in lines)
