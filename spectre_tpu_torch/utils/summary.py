"""Model summary: parameter and buffer counts and the forward's FLOPs (port
of spectre_tpu/utils/summary.py).

The JAX package takes FLOPs from XLA's cost analysis of the jitted forward.
Here they come from ``torch.utils.flop_counter.FlopCounterMode`` over the
plain path on the CPU: on the card the kernels launch through ctypes, which
the counter never sees, so a count taken there would silently drop kernel
1's and kernel 2's work. A model on the card is counted on a CPU copy.
The counter counts matrix products, convolutions and attention, not
elementwise work; the JAX package's ``bytes_accessed`` has no counterpart.
"""

from __future__ import annotations

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode


def forward_flops(model: torch.nn.Module, example_input: torch.Tensor) -> int:
    """FLOPs of one forward of ``model`` on ``example_input``'s shape, counted
    over the plain path on the CPU (a CPU copy of a model on another device)."""
    on_cpu = all(p.device.type == "cpu" for p in model.parameters())
    cpu_model = model if on_cpu else copy.deepcopy(model).cpu()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        cpu_model(example_input.cpu())
    return int(counter.get_total_flops())


def model_summary(model: torch.nn.Module, example_input: torch.Tensor) -> dict:
    """``params`` (parameter elements), ``buffer_elems`` (elements of the
    buffers a checkpoint holds: the mix tables; not the buffers derived from
    the config, which flax recomputes) and ``flops``, the forward's FLOPs on
    ``example_input``."""
    persistent = set(model.state_dict())
    return {
        "params": sum(p.numel() for p in model.parameters()),
        "buffer_elems": sum(b.numel() for name, b in model.named_buffers()
                            if name in persistent),
        "flops": float(forward_flops(model, example_input)),
    }


def format_summary(name: str, summary: dict) -> str:
    parts = [f"{name}: {summary['params']:,} params"]
    if summary.get("buffer_elems"):
        parts.append(f"{summary['buffer_elems']:,} buffer elems")
    if summary.get("flops"):
        parts.append(f"{summary['flops'] / 1e9:.2f} GFLOP/fwd")
    if summary.get("bytes_accessed"):
        parts.append(f"{summary['bytes_accessed'] / 1e6:.1f} MB touched")
    return " | ".join(parts)
