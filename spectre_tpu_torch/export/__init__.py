"""Deployment of the port: the eval forward as a ``torch.export`` program
(``.pt2``) and the ``.stw`` weights container of ``native/``."""

from spectre_tpu_torch.export.program import (
    EXPORT_ATOL,
    export_forward,
    exported_module,
    kernel_nodes,
    load_exported,
    program_compute_dtype,
    save_exported,
    verify_export,
)
from spectre_tpu_torch.export.weights import (
    load_stw,
    load_stw_into,
    save_stw,
    stw_names,
    write_stw,
)

__all__ = [
    "EXPORT_ATOL",
    "export_forward",
    "exported_module",
    "kernel_nodes",
    "load_exported",
    "load_stw",
    "load_stw_into",
    "program_compute_dtype",
    "save_exported",
    "save_stw",
    "stw_names",
    "verify_export",
    "write_stw",
]
