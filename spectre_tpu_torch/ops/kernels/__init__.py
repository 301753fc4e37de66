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
    block_bwd_kernel,
    fused_block_bwd,
    fused_block_bwd_grouped,
    fused_block_bwd_plain,
    fused_block_bwd_wgmma,
    grouped_plan,
)
from spectre_tpu_torch.ops.kernels.fused_linear import (
    ClusterPlan,
    backward_kernel,
    chain_shard_dh,
    chain_shard_dh_plain,
    chain_shard_sums,
    chain_shard_sums_plain,
    cluster_plan,
    forward_kernel,
    fused_spectre_linear,
    fused_spectre_linear_bwd,
    fused_spectre_linear_bwd_plain,
    fused_spectre_linear_bwd_wide,
    fused_spectre_linear_cluster,
    fused_spectre_linear_grad,
    fused_spectre_linear_plain,
    fused_spectre_linear_shard_stats,
    fused_spectre_linear_shard_stats_wgmma,
    fused_spectre_linear_wgmma,
    fused_spectre_linear_wide_cluster,
    linear_products,
    matmul_f32,
    shard_stats_kernel,
    shard_stats_plain,
    shard_stats_plan,
    sharded_ln_gelu,
    sharded_ln_gelu_plain,
    wide_cluster_size,
)
from spectre_tpu_torch.ops.kernels.fwht import fwht, fwht_grad, fwht_plain
from spectre_tpu_torch.ops.kernels.inverse_gather import (
    inverse_gather_sum,
    inverse_gather_sum_plain,
)
from spectre_tpu_torch.ops.kernels.routed_gather import (
    routed_gather_sum,
    routed_gather_sum_plain,
)
from spectre_tpu_torch.ops.kernels import library  # registers the custom ops
from spectre_tpu_torch.ops.kernels.structured_mix import (
    invert_tile_perms,
    structured_mix,
    structured_mix_bwd,
    structured_mix_bwd_plain,
    structured_mix_grad,
    structured_mix_plain,
)

# kernel 2's forward and kernel 5 count each call in their wrapper and again
# in the kernel it launched (kernel 2: ``_wgmma``, ``_cluster`` and
# ``_wide_cluster``; kernel 5: ``_wgmma`` and ``_grouped``); kernel 2's
# backward counts a wide chain again in ``_bwd_wide``; kernel 2's column
# shard forward (``_shard_stats``) counts again in its bf16 kernel
# (``_shard_stats_wgmma``) or in ``_cluster``, whose statistics mode it runs
KERNELS = (block_scatter_rows, block_gather_sum, inverse_gather_sum, fused_spectre_linear,
           fused_spectre_linear_bwd, fused_block_bwd, flash_attention_fwd, flash_attention_bwd,
           fwht, structured_mix, structured_mix_bwd, routed_gather_sum,
           fused_spectre_linear_wgmma, fused_spectre_linear_cluster, fused_block_bwd_wgmma,
           fused_block_bwd_grouped, fused_spectre_linear_wide_cluster,
           fused_spectre_linear_bwd_wide, fused_spectre_linear_shard_stats, sharded_ln_gelu,
           chain_shard_sums, chain_shard_dh, fused_spectre_linear_shard_stats_wgmma)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = [
    "ClusterPlan",
    "KERNELS",
    "backward_kernel",
    "block_bwd_kernel",
    "block_gather_sum",
    "block_gather_sum_plain",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "flash_attention_plain",
    "forward_kernel",
    "block_scatter_rows",
    "block_scatter_rows_plain",
    "chain_shard_dh",
    "chain_shard_dh_plain",
    "chain_shard_sums",
    "chain_shard_sums_plain",
    "cluster_plan",
    "fused_block_bwd",
    "fused_block_bwd_grouped",
    "fused_block_bwd_plain",
    "fused_block_bwd_wgmma",
    "fused_spectre_linear",
    "fused_spectre_linear_bwd",
    "fused_spectre_linear_bwd_plain",
    "fused_spectre_linear_bwd_wide",
    "fused_spectre_linear_cluster",
    "fused_spectre_linear_grad",
    "fused_spectre_linear_plain",
    "fused_spectre_linear_shard_stats",
    "fused_spectre_linear_shard_stats_wgmma",
    "fused_spectre_linear_wgmma",
    "fused_spectre_linear_wide_cluster",
    "fwht",
    "fwht_grad",
    "fwht_plain",
    "grouped_plan",
    "inverse_gather_sum",
    "inverse_gather_sum_plain",
    "invert_tile_perms",
    "launch_counts",
    "library",
    "linear_products",
    "matmul_f32",
    "reset_launch_counts",
    "routed_gather_sum",
    "routed_gather_sum_plain",
    "shard_stats_kernel",
    "shard_stats_plain",
    "shard_stats_plan",
    "sharded_ln_gelu",
    "sharded_ln_gelu_plain",
    "structured_mix",
    "structured_mix_bwd",
    "structured_mix_bwd_plain",
    "structured_mix_grad",
    "structured_mix_plain",
    "wide_cluster_size",
]
