"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each wrapper keeps a launch count (``fn.launches``, a plain int) that it
raises by one where it launches its kernel and nowhere else.
"""

from spectre_tpu_torch.ops.kernels.attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_attention_plain,
)
from spectre_tpu_torch.ops.kernels.block_gather import (
    block_gather_sum,
    block_gather_sum_plain,
)
from spectre_tpu_torch.ops.kernels.block_scatter import (
    block_scatter_rows,
    block_scatter_rows_plain,
)
from spectre_tpu_torch.ops.kernels.fused_block_bwd import (
    fused_block_bwd,
    fused_block_bwd_plain,
)
from spectre_tpu_torch.ops.kernels.fused_linear import (
    fused_spectre_linear,
    fused_spectre_linear_grad,
    fused_spectre_linear_plain,
)
from spectre_tpu_torch.ops.kernels.fwht import fwht, fwht_grad, fwht_plain
from spectre_tpu_torch.ops.kernels.inverse_gather import (
    inverse_gather_sum,
    inverse_gather_sum_plain,
)
from spectre_tpu_torch.ops.kernels.structured_mix import (
    invert_tile_perms,
    structured_mix,
    structured_mix_bwd,
    structured_mix_bwd_plain,
    structured_mix_grad,
    structured_mix_plain,
)

KERNELS = (block_scatter_rows, block_gather_sum, inverse_gather_sum, fused_spectre_linear,
           fused_block_bwd, flash_attention_fwd, flash_attention_bwd, fwht, structured_mix,
           structured_mix_bwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = [
    "KERNELS",
    "block_gather_sum",
    "block_gather_sum_plain",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "flash_attention_plain",
    "block_scatter_rows",
    "block_scatter_rows_plain",
    "fused_block_bwd",
    "fused_block_bwd_plain",
    "fused_spectre_linear",
    "fused_spectre_linear_grad",
    "fused_spectre_linear_plain",
    "fwht",
    "fwht_grad",
    "fwht_plain",
    "inverse_gather_sum",
    "inverse_gather_sum_plain",
    "invert_tile_perms",
    "launch_counts",
    "reset_launch_counts",
    "structured_mix",
    "structured_mix_bwd",
    "structured_mix_bwd_plain",
    "structured_mix_grad",
    "structured_mix_plain",
]
