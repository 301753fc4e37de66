"""The program's spans in a train cell's traced steps, turn by turn, with the
spans on and stubbed out in one process.

    python3 portbench/span_report.py --workload spectre_vit.train.b1024 --seed <n> \\
        [--turns spans,stubbed,spans,stubbed] [--steps 15] [--out runs/spans.json]

Set-up is the runner's (``drive_train.Trainer``, the cell's checked and
warm-up steps through the same call and feed). Each turn then traces
``--steps`` steps as ``tracing.traced`` does (a ``portbench.window``
annotation between two device synchronises, padded) and reads the trace
twice: ``tracing.summarize`` and ``spans.summarize_spans``. A ``stubbed``
turn runs with the program's spans off although the profiler records, so
that the two kinds of turn price the spans. Each turn's line on standard
output gives the window's milliseconds a step, the device's idle share and
the span readers' values (``layer_metrics/idle_under_ms.py``,
``device_ms.py``, ``spectre_linear_op_roofline.py``); ``--out`` takes every
turn's whole summary as JSON, and the last turn with spans is printed as a
table a span a row.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if not __package__:
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]

SPAN_METRICS = ("idle_under_ms.train.input", "idle_under_ms.train.step",
                "device_ms.train.augment", "device_ms.train.mix", "device_ms.train.optimizer",
                "spectre_linear_op_roofline")


@contextlib.contextmanager
def stubbed():
    """The program's spans off while a profiler records."""
    from spectre_tpu_torch.profile import spans

    real = spans._profiler
    spans._profiler = types.SimpleNamespace(_is_profiler_enabled=False)
    try:
        yield
    finally:
        spans._profiler = real


def traced_steps(trainer, k: int, sync) -> dict:
    """``k`` steps in a traced window, as ``tracing.traced`` traces them:
    its summary with the spans' summary under ``spans``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import torch

    from portbench.spans import read_spans
    from portbench.tracing import PAD_S, WINDOW, summarize

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="portbench_spans_") as tmp:
        with profile(activities=activities) as prof:
            sync()
            time.sleep(PAD_S)
            with record_function(WINDOW):
                for _ in range(k):
                    trainer.one()
                sync()
            time.sleep(PAD_S)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        out = summarize(path)
        out["spans"] = read_spans(path)
    return out


def span_metrics(record: dict) -> dict:
    from portbench.manifest import PACKAGE, load_reader, reader_for

    out = {}
    for name in SPAN_METRICS:
        path, args = reader_for(name, os.path.join(ROOT, PACKAGE, "layer_metrics"))
        out[name] = load_reader(path)(record, *args)
    return out


def table(record: dict) -> str:
    """A row a span, milliseconds a step: calls, host, device (nested spans
    included), self device, idle, self idle, the ops of its self time; then
    each op span's device time by phase and each span's call sites."""
    k, s = record["trace_steps"], record["trace"]["spans"]
    ms = lambda x: f"{1e3 * x / k:9.3f}"  # noqa: E731
    lines = [f"{'span':<20}{'calls':>7}{'host':>10}{'device':>10}{'self dev':>10}"
             f"{'idle':>10}{'self idle':>10}  ops (self)"]
    for name, r in sorted(s["spans"].items()):
        ops = ", ".join(f"{op} {1e3 * v / k:.3f}" for op, v in r["ops"][:4])
        lines.append(f"{name:<20}{r['calls'] / k:7.1f}{ms(r['host_s'])} {ms(r['device_s'])}"
                     f" {ms(r['self_device_s'])} {ms(r['idle_s'])} {ms(r['self_idle_s'])}"
                     f"  {ops}")
    u = s["unattributed"]
    lines.append(f"{'(no span)':<20}{'':>7}{'':>10}{ms(u['device_s'])} {'':>9} "
                 f"{ms(u['idle_s'])} {'':>9}  "
                 + ", ".join(f"{op} {1e3 * v / k:.3f}" for op, v in u["ops"][:4]))
    lines.append("idle under no span, the host in: "
                 + ", ".join(f"{h} {1e3 * v / k:.3f}" for h, v in u["host"]))
    for name, r in sorted(s["spans"].items()):
        if r["phases"]:
            lines.append(f"{name} by phase: " + ", ".join(
                f"{ph} {1e3 * v / k:.3f}" for ph, v in sorted(r["phases"].items())))
        for op, site, v in r["sites"]:
            lines.append(f"  {name}: {op} at {site}: {1e3 * v / k:.3f}")
    under = lambda part, whole: 100.0 * (1.0 - part / max(whole, 1e-12))  # noqa: E731
    lines.append(f"device ms a step {ms(s['device_s'])}, idle {ms(s['idle_s'])}; "
                 f"device time under a span {under(u['device_s'], s['device_s']):.2f}%, "
                 f"idle under a span {under(u['idle_s'], s['idle_s']):.2f}%, "
                 f"launch not in the trace {ms(u['no_launch_s'])} ms; a device event starts "
                 f"up to {1e3 * s['clock_lead_s']:.3f} ms before its launch")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--turns", default="spans,stubbed,spans,stubbed")
    p.add_argument("--steps", type=int, default=15)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=ROOT, help="the checkout whose BENCHMARK.json names the cell")
    p.add_argument("--out")
    a = p.parse_args(argv)

    import torch

    from portbench.drive_train import Trainer
    from portbench.manifest import find_cell, load_manifest

    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda, but torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    cell = find_cell(load_manifest(os.path.join(a.root, "BENCHMARK.json")), a.workload, a.root)
    if cell.traffic["kind"] != "train":
        print(f"{a.workload} is not a train cell", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    trainer = Trainer(cell, a.seed, device)
    for _ in range(int(cell.traffic["check_steps"]) + int(cell.traffic["warmup_steps"])):
        trainer.one()
    sync()
    turns, last = [], None
    for turn in a.turns.split(","):
        with stubbed() if turn == "stubbed" else contextlib.nullcontext():
            trace = traced_steps(trainer, a.steps, sync)
        record = {"kind": "train", "model": trainer.m, "batch": trainer.batch,
                  "trace_steps": a.steps, "trace": trace}
        result = {"turn": turn, "ms_per_step": 1e3 * trace["window_s"] / a.steps,
                  "idle_pct": 100.0 * (1.0 - trace["busy_s"] / trace["window_s"]),
                  "metrics": span_metrics(record)}
        print(json.dumps(result), flush=True)
        turns.append(dict(result, trace=trace))
        if turn == "spans":
            last = record
    trainer.close()
    if last is not None:
        print(table(last))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"workload": a.workload, "seed": a.seed, "steps": a.steps,
                       "device": torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu", "turns": turns}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
