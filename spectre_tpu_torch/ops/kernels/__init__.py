"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each wrapper keeps a launch count (``fn.launches``, a plain int) that it
raises by one where it launches its kernel and nowhere else.
"""

from spectre_tpu_torch.ops.kernels.block_scatter import (
    block_scatter_rows,
    block_scatter_rows_plain,
)
from spectre_tpu_torch.ops.kernels.fused_linear import (
    fused_spectre_linear,
    fused_spectre_linear_plain,
)

KERNELS = (block_scatter_rows, fused_spectre_linear)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = [
    "KERNELS",
    "block_scatter_rows",
    "block_scatter_rows_plain",
    "fused_spectre_linear",
    "fused_spectre_linear_plain",
    "launch_counts",
    "reset_launch_counts",
]
