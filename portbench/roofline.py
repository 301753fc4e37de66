"""The least time the card could take for a kernel's work, from the shapes
the configuration gives: each input read once and each output written once
at the memory rate, the operations at the bf16 tensor-core rate, the larger
of the two (the bound arithmetic of the program's ``utils/timing.py``,
frozen here with its published peaks).

A group names the kernels whose share of their roofline a metric reports,
the trace names that find them, and the work of one train step.
"""

from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12   # one H100 SXM (data sheet)
BF16_FLOPS = 989e12


def bound_s(n_bytes: float, flops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def _tokens(m: dict) -> int:
    return (int(m["img_size"]) // int(m["patch_size"])) ** 2 + 1


def spectre_linear_step_s(m: dict, batch: int, elem: int = 2) -> float:
    """Kernel 2 over one flagship train step: the forward of every
    SpectreLinear outside the mix (linear1 and linear3 of each layer, rows B*N;
    the head, rows B) reads x, the kernel, bias, LayerNorm scale and bias and
    writes the output and the pre-LayerNorm h it saves; the backward chain
    of each reads h, the cotangent, scale and bias and writes dh and three
    column sums."""
    e, hd, c = int(m["embed_dim"]), int(m["hidden_dim"]), int(m["num_classes"])
    rows = batch * _tokens(m)
    calls = [(rows, e, hd), (rows, hd, e)] * int(m["num_encoders"]) + [(batch, e, c)]
    total = 0.0
    for mm, k, n in calls:
        fwd_bytes = elem * (mm * k + k * n + 3 * n + 2 * mm * n)
        total += bound_s(fwd_bytes, 2.0 * mm * k * n)
        chain_bytes = elem * (3 * mm * n + 2 * n + 3 * n)
        total += bound_s(chain_bytes, 0.0)
    return total


def attention_step_s(m: dict, batch: int, elem: int = 2) -> float:
    """B4 over one train step of a model with attention: per layer the
    forward reads q, k, v [B, H, N, D] and the keep mask [N, N] (float32) and
    writes O and the row log-sum-exp [B, H, N] (float32), 4*B*H*N*N*D
    operations; the backward reads q, k, v, O, dO, the log-sum-exp and the
    mask and writes dq, dk, dv, 10*B*H*N*N*D operations."""
    n, e = _tokens(m), int(m["embed_dim"])
    bhnd = batch * n * e
    bhn = batch * int(m["num_heads"]) * n
    fwd = bound_s(elem * 4 * bhnd + 4 * n * n + 4 * bhn, 4.0 * bhnd * n)
    bwd = bound_s(elem * 8 * bhnd + 4 * bhn + 4 * n * n, 10.0 * bhnd * n)
    return int(m["num_encoders"]) * (fwd + bwd)


# name -> (regular expression over trace names, least seconds of a train step)
GROUPS = {
    "spectre_linear": (r"fused_linear_(wgmma|cluster|wide_cluster)_kernel"
                       r"|(?<![A-Za-z0-9_])(chain|chain_wide|chain_walk|column_sum)_kernel(?![A-Za-z0-9_])",
                       spectre_linear_step_s),
    "attention": (r"flash_attention_(fwd|bwd)_kernel", attention_step_s),  # and *_tc
}


def share(record: dict, group: str, kind: str = "train"):
    """The group's share of its roofline, in percent, from a traced run's
    record: the least time of the traced steps over the device time of the
    group's kernels; None where the run was not traced or no kernel of the
    group ran."""
    trace = record.get("trace")
    if record["kind"] != kind or not trace or not record.get("trace_steps"):
        return None
    pattern, least_step_s = GROUPS[group]
    found = re.compile(pattern)
    device_s = sum(secs for name, (_, secs, _) in trace["kernels"].items() if found.search(name))
    if device_s <= 0.0:
        return None
    return 100.0 * least_step_s(record["model"], record["batch"]) * record["trace_steps"] / device_s
