"""Op library of the port: plain torch functions on tensors, and the
hand-written kernels under ``ops/kernels``."""

from spectre_tpu_torch.ops.fft import (
    extract_patches,
    flatten_patches_cjk,
    rfft2_real_matrix,
    spectral_patch_matrix,
)
from spectre_tpu_torch.ops.fused_mix import (
    fold_weights,
    folded_bmm,
    folded_proj,
    perm_rows_t,
    perm_rows_t_plain,
)
from spectre_tpu_torch.ops.linear import (
    adaptive_avg_pool1d,
    adaptive_pool_matrix,
    gelu_exact,
    layer_norm,
    spectre_linear_apply,
)
from spectre_tpu_torch.ops.permute import (
    MixTables,
    derive_mix_tables,
    detect_block_size,
    make_block_mix_tables,
    make_mix_tables,
)

__all__ = [
    "MixTables",
    "adaptive_avg_pool1d",
    "adaptive_pool_matrix",
    "derive_mix_tables",
    "detect_block_size",
    "extract_patches",
    "flatten_patches_cjk",
    "fold_weights",
    "folded_bmm",
    "folded_proj",
    "gelu_exact",
    "layer_norm",
    "make_block_mix_tables",
    "make_mix_tables",
    "perm_rows_t",
    "perm_rows_t_plain",
    "rfft2_real_matrix",
    "spectral_patch_matrix",
    "spectre_linear_apply",
]
