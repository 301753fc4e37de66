"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each wrapper keeps a launch count (``fn.launches``, a plain int) that it
raises by one where it launches its kernel and nowhere else.
"""

from spectre_tpu_torch.ops.kernels.block_gather import (
    block_gather_sum,
    block_gather_sum_plain,
)
from spectre_tpu_torch.ops.kernels.block_scatter import (
    block_scatter_rows,
    block_scatter_rows_plain,
)
from spectre_tpu_torch.ops.kernels.fused_linear import (
    fused_spectre_linear,
    fused_spectre_linear_grad,
    fused_spectre_linear_plain,
)
from spectre_tpu_torch.ops.kernels.inverse_gather import (
    inverse_gather_sum,
    inverse_gather_sum_plain,
)

KERNELS = (block_scatter_rows, block_gather_sum, inverse_gather_sum, fused_spectre_linear)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = [
    "KERNELS",
    "block_gather_sum",
    "block_gather_sum_plain",
    "block_scatter_rows",
    "block_scatter_rows_plain",
    "fused_spectre_linear",
    "fused_spectre_linear_grad",
    "fused_spectre_linear_plain",
    "inverse_gather_sum",
    "inverse_gather_sum_plain",
    "launch_counts",
    "reset_launch_counts",
]
