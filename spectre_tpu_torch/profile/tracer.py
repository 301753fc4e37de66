"""Tracing around a step (port of spectre_tpu/profile/tracer.py).

``trace_step`` wraps ``torch.profiler.profile`` around whatever runs inside
it, with CPU activity and, when the device is a card, CUDA activity (the
kernels, copies and fills on the card's timeline), and writes the Kineto
chrome trace under ``logdir``, where ``ProfilerParser`` reads it.

Kineto drops a device event whose timestamp, converted to the host's clock,
falls outside the profiling window, and on a card in a virtual machine that
conversion can be off by milliseconds: a short window then loses some or all
of its kernels (``chip_smoke.py`` phase 24 counts how many, unpadded). On a
card the window is therefore padded: the card is synchronised and the host
waits ``PAD_S`` after the profiler starts and again before it stops.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

PAD_S = 0.25  # seconds of padding on each side of a window on a card


class TraceHandle:
    """What ``trace_step`` yields: the trace directory (``path``), the trace
    file once the block has ended (``trace_file``) and the profiler itself
    (``profiler``, for its ``key_averages()``)."""

    def __init__(self, path: str):
        self.path = path
        self.trace_file: str | None = None
        self.profiler: profile | None = None


@contextlib.contextmanager
def trace_step(logdir: str, device: torch.device | str = "cuda"):
    """Profile everything inside the block and write
    ``<logdir>/trace_<ns>.pt.trace.json``. The card's work is traced when
    ``device`` is a CUDA device (the default; it raises without a card), in
    a window padded by ``PAD_S`` seconds on each side. Synchronise inside
    the block, so that the card's work ends in it::

        with trace_step("plots/trace") as t:
            step(); torch.cuda.synchronize()
        ProfilerParser(t.path).remove_idle().sort_by_device().show()
    """
    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"trace_step on {device}, but torch.cuda.is_available() is "
                               "False; pass device='cpu' to trace the host only")
        activities.append(ProfilerActivity.CUDA)
    handle = TraceHandle(os.path.abspath(logdir))
    os.makedirs(handle.path, exist_ok=True)
    on_card = device.type == "cuda"
    with profile(activities=activities) as prof:
        handle.profiler = prof
        if on_card:
            torch.cuda.synchronize(device)
            time.sleep(PAD_S)
        yield handle
        if on_card:
            torch.cuda.synchronize(device)
            time.sleep(PAD_S)
    trace_file = os.path.join(handle.path, f"trace_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(trace_file)
    handle.trace_file = trace_file
