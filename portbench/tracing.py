"""The traced part of a run: ``torch.profiler`` with CPU and CUDA activity
around a block of the cell's own work, and what the readers and the result's
``breakdown`` take from its Kineto trace.

The block is marked by a ``portbench.window`` annotation that starts after a
device synchronise and ends after another, so the card's work of the block
lies inside it; the profiler runs ``PAD_S`` longer on each side, because
Kineto drops device events of a short window whose converted timestamps fall
outside it (as the program's ``profile/tracer.py`` pads its windows). The
trace goes to a temporary directory and is deleted once read.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time

from portbench.kernel_names import DEVICE_CATEGORIES, classify, short_name

PAD_S = 0.25
WINDOW = "portbench.window"
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function", "cuda_runtime")


@contextlib.contextmanager
def traced(sync):
    """Profile the block; afterwards ``holder["trace"]`` is its summary
    (``summarize``). ``sync()`` waits for the card."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    holder: dict = {}
    tmp = tempfile.mkdtemp(prefix="portbench_trace_")
    try:
        with profile(activities=activities) as prof:
            sync()
            time.sleep(PAD_S)
            with record_function(WINDOW):
                yield holder
                sync()
            time.sleep(PAD_S)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        holder["trace"] = summarize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(path: str) -> dict:
    """From a chrome trace with one ``portbench.window`` annotation:
    ``window_s``; ``busy_s``, the union of device events inside it;
    ``kernels``, {name: [category, seconds, calls]} clipped to it;
    ``classes``, seconds by ``kernel_names.classify``; ``device_ops``, the ten
    names that took the most device time; ``idle_gaps``, the ten longest
    stretches inside the window with no device event, each named by the
    innermost host event that covers its middle."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in spans if e.get("name") == WINDOW and e.get("cat") != "gpu_user_annotation"]
    if len(windows) != 1:
        raise RuntimeError(f"expected one {WINDOW} span in the trace, found {len(windows)}")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device, kernels = [], {}
    for e in spans:
        cat = e.get("cat")
        if cat not in DEVICE_CATEGORIES:
            continue
        a, b = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))
        if b <= a:
            continue
        device.append((a, b))
        entry = kernels.setdefault(e.get("name", "?"), [cat, 0.0, 0])
        entry[1] += (b - a) * 1e-6
        entry[2] += 1
    busy = _union(device)
    classes: dict[str, float] = {}
    for name, (cat, secs, _) in kernels.items():
        cls = classify(name, cat)
        classes[cls] = classes.get(cls, 0.0) + secs
    by_short: dict[str, float] = {}
    for name, (_, secs, _) in kernels.items():
        key = short_name(name)
        by_short[key] = by_short.get(key, 0.0) + secs
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = [e for e in spans if e.get("cat") in HOST_CATEGORIES and e.get("name") != WINDOW]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        cover = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        inner = min(cover, key=lambda e: float(e["dur"]), default=None)
        named.append([inner["name"] if inner else "no host event", (b - a) * 1e-6])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": kernels,
        "classes": classes,
        "device_ops": sorted(([k, v] for k, v in by_short.items()), key=lambda kv: -kv[1])[:10],
        "idle_gaps": named,
    }
