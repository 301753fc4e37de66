"""The eval forward as a portable program: ``torch.export`` in place of the
JAX package's StableHLO export (spectre_tpu/export/stablehlo.py).

``export_forward`` traces ``model(x)`` at the example's fixed shape with the
weights inside the program, as ``jax.export`` bakes them. The kernels of the
forward are custom ops (``ops/kernels/library.py``), one node each, so the
program runs them on the card; the mix tables are derived before the trace
and become constants. ``save_exported`` / ``load_exported`` write and read
the program as a ``.pt2`` (``torch.export.save`` / ``load``); a ``.pt2`` is
tied to the torch version that wrote it. ``verify_export`` replays the
program against the live model, the analogue of JAX's replay check.

Loading needs the custom ops registered, which importing this module does;
it needs none of the port's model code.
"""

from __future__ import annotations

import os

import torch

from spectre_tpu_torch.ops.kernels import library  # registers the ops

# replay limits of the JAX package's repl/export.py: bf16 differs between two
# compilations of the same forward (the products' summation order), f32 not
# beyond rounding
EXPORT_ATOL = {"float32": 1e-5, "bfloat16": 5e-2}


def export_forward(model: torch.nn.Module, example: torch.Tensor) -> torch.export.ExportedProgram:
    """``torch.export.export`` of the eval forward ``model(example)``, at
    ``example``'s shape, dtype and device. The model must be in eval mode."""
    from spectre_tpu_torch.models.registry import refresh_mixes

    if model.training:
        raise ValueError("export_forward exports the eval forward; call model.eval() first")
    refresh_mixes(model)  # the tables the trace reads as constants
    with torch.no_grad():
        # one eager forward first: the constants the ops cache on first use
        # (the DFT matrices of ops/fft.py) must be made from real tensors,
        # not from the trace's fake ones
        model(example)
        return torch.export.export(model, (example,))


def save_exported(program: torch.export.ExportedProgram, path: str) -> str:
    torch.export.save(program, path)
    return path


def load_exported(path: str) -> torch.export.ExportedProgram:
    return torch.export.load(path)


def program_compute_dtype(program: torch.export.ExportedProgram) -> str:
    """``"bfloat16"`` when any value of the program's graph is bf16, else
    ``"float32"``: the dtype whose limit ``EXPORT_ATOL`` holds it to."""
    for node in program.graph.nodes:
        val = node.meta.get("val")
        for v in val if isinstance(val, (tuple, list)) else (val,):
            if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
                return "bfloat16"
    return "float32"


def kernel_nodes(program: torch.export.ExportedProgram) -> dict[str, int]:
    """{custom op name: its nodes in the program's graph} of the kernels'
    ops (``library.NAMESPACE``)."""
    counts: dict[str, int] = {}
    for node in program.graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        if node.op == "call_function" and name.startswith(library.NAMESPACE + "::"):
            op = name.split("::")[1].split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    return counts


def exported_module(program: torch.export.ExportedProgram):
    """The program as a callable ``x -> output`` without autograd. The module
    is built once here: ``program.module()`` unlifts the weights on every
    call, so call this once and the result many times."""
    module = program.module()

    def run(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(x)
    return run


def verify_export(program_or_path, model: torch.nn.Module, example: torch.Tensor,
                  atol: float = 1e-5) -> float:
    """Replay the program (or the ``.pt2`` at a path) on ``example`` against
    the live model. Returns max |program - model| and raises above ``atol``."""
    program = (load_exported(program_or_path)
               if isinstance(program_or_path, (str, os.PathLike)) else program_or_path)
    got = exported_module(program)(example).float()
    with torch.no_grad():
        want = model(example).float()
    err = (got - want).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"export parity check failed: max|delta|={err} > {atol}")
    return err
