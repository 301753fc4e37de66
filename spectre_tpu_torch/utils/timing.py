"""Kernel times on the card by CUDA events, two ways, and the bound they are
held to.

``cuda_time_ms`` times calls back to back as a caller makes them: where the
host takes longer to issue a call (Python, ctypes, the allocator) than the
card takes to run it, the host's time is what it measures. ``device_time_ms``
queues the same calls behind a device sleep, so that the card runs them back
to back: the device's own time. A kernel's row gives both.
"""

from __future__ import annotations

import statistics
import time

import torch

# published peaks of one H100 SXM: device memory rate, dense bf16 tensor-core
# rate, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


def bound_ms(n_bytes: float, flops: float = 0.0,
             flops_per_s: float = BF16_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over their type's peak rate (bf16
    tensor cores unless ``flops_per_s`` says otherwise), and which of the
    two it is."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def cuda_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def queued_time_ms(fn, iters: int = 20, reps: int = 5) -> tuple[float, float]:
    """(device ms, host ms) of a call, medians over ``reps``: ``iters`` calls
    queued behind a device sleep, so that the card runs them back to back
    (the device's own time, without the host's per-call overhead: Python,
    ctypes, the allocator, which a small kernel can fall below), and the
    host's time to issue one. A repetition whose calls took the host longer
    to queue than the sleep lasted is taken again behind a sleep twice as
    long."""
    fn()
    device, host, cycles = [], [], 10_000_000
    while len(device) < reps:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        if queued_ms >= marks[0].elapsed_time(marks[1]):
            if cycles >= 640_000_000:
                raise AssertionError(f"queued_time_ms: queueing {iters} calls took "
                                     f"{queued_ms:.2f} ms, longer than any sleep tried")
            cycles *= 2
            continue
        device.append(marks[1].elapsed_time(marks[2]) / iters)
        host.append(queued_ms / iters)
    return statistics.median(device), statistics.median(host)


def device_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """The device's own time of a call (``queued_time_ms``)."""
    return queued_time_ms(fn, iters, reps)[0]
