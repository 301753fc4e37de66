"""Which events of a Kineto trace are the card's work, and whose kernel each
is, by its name.

The categories are a frozen copy of the program's
``profile/parser.py`` (``DEVICE_CATEGORIES``: kernels, copies and fills on a
GPU lane; ``gpu_user_annotation`` spans are neither host nor device work).
The classes sort a kernel by its name: the hand-written kernels of the
program (the ``__global__`` functions of ``spectre_tpu_torch/csrc``), the
matrix products of the vendor libraries, and PyTorch's own elementwise,
reduction, copy and normalisation kernels. A test holds the categories to
the program's and every ``__global__`` function to the hand-written class.
"""

from __future__ import annotations

import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
DROPPED_CATEGORIES = ("gpu_user_annotation",)

HAND_WRITTEN_KERNELS = (
    "block_scatter_rows_kernel", "chain_kernel", "chain_walk_kernel", "chain_wide_kernel",
    "column_sum_kernel", "flash_attention_bwd_kernel", "flash_attention_bwd_kernel_tc",
    "flash_attention_fwd_kernel", "flash_attention_fwd_kernel_tc",
    "fused_block_bwd_grouped_bf16_kernel", "fused_block_bwd_grouped_f32_kernel",
    "fused_block_bwd_wgmma_kernel", "fused_linear_cluster_kernel",
    "fused_linear_wgmma_kernel", "fused_linear_wide_cluster_kernel", "fwht_block_kernel",
    "fwht_warp_kernel", "gather_sum_kernel", "routed_gather_sum_kernel",
    "shard_chain_kernel", "shard_column_sum_kernel", "shard_ln_kernel",
    "shard_ln_walk_kernel", "shard_row_sum_kernel", "shard_stats_wgmma_kernel",
    "structured_mix_kernel",)
HAND_WRITTEN = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(HAND_WRITTEN_KERNELS)
                          + r")(?![A-Za-z0-9_])")
LIBRARY_PRODUCT = re.compile(r"gemm|sm90_xmma|sm80_xmma|cutlass|cublas|nvjet|Kernel2|"
                             r"splitKreduce|dot_kernel|gemv", re.IGNORECASE)
PYTORCH = re.compile(r"at::native|at::cuda|cunn_|elementwise_kernel|reduce_kernel|"
                     r"softmax_warp|CatArrayBatchedCopy|multi_tensor_apply|layer_norm|"
                     r"distribution_|fused_dropout|index_elementwise|unrolled_elementwise|"
                     r"vectorized_elementwise|GammaBeta|RowwiseMoments|ComputeFused")


def classify(name: str, category: str = "kernel") -> str:
    """``hand_written``, ``library_product``, ``pytorch``, ``memcpy``,
    ``memset`` or ``other`` for a device event."""
    if category == "gpu_memcpy":
        return "memcpy"
    if category == "gpu_memset":
        return "memset"
    if HAND_WRITTEN.search(name):
        return "hand_written"
    if LIBRARY_PRODUCT.search(name):
        return "library_product"
    if PYTORCH.search(name):
        return "pytorch"
    return "other"


_GENERIC = {"BinaryFunctor", "UnaryFunctor", "AUnaryFunctor", "BUnaryFunctor", "ReduceOp",
            "gpu_kernel_impl", "gpu_kernel_impl_nocast"}


def short_name(name: str) -> str:
    """A kernel's function name without its return type, template arguments
    and parameters, at most 120 characters; for PyTorch's generic
    elementwise and reduction kernels the first functor or op among its
    template arguments, in brackets (which operation it ran)."""
    clean = name.replace("(anonymous namespace)::", "")
    base = re.sub(r"[<(].*", "", clean).strip()
    if base.startswith("void "):
        base = base[5:]
    if re.search(r"elementwise|reduce_kernel", base):
        ops = re.findall(r"(\w+(?:Functor|Ops?|_kernel_cuda|_impl))\b", clean[len(base):])
        named = [op for op in ops if op not in _GENERIC] or ops
        if named:
            base = f"{base}[{named[0]}]"
    return base[:120] or name[:120]
