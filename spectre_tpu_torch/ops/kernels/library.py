"""The eval forward's kernels as PyTorch custom ops, for ``torch.export``.

Every wrapper of this package launches its kernel through ctypes on
``data_ptr()``. A fake tensor, which ``torch.export`` traces with, has no
data pointer, so an exported trace would break at the first kernel. Here
each kernel of the eval forward is a ``torch.library.custom_op`` with a
``register_fake`` that states its output's shape, dtype and strides; the
exported program then holds one node per kernel call
(``torch.ops.spectre_tpu_torch.<name>``), and a process that imports this
module runs it:

- ``block_scatter_rows``   kernel B1, the folded mix's block-row copy;
- ``fused_spectre_linear`` kernel B3's forward without ``save_h`` (all four
  forward kernels, chosen by ``forward_kernel`` as in eager);
- ``flash_attention_fwd``  kernel B4's forward, its output only (the eval
  path has no probability multiplier);
- ``structured_mix``       kernel B6's forward.

The impl of each op calls the wrapper: a CUDA tensor launches the
hand-written kernel (raising on failure) and raises its launch count
exactly as in eager, a CPU tensor takes the plain version. No op adds
arithmetic.

The call sites (``ops/fused_mix.py::perm_rows_t``,
``ops/linear.py::spectre_linear_apply``,
``ops/kernels/attention.py::flash_attention`` and
``ops/kernels/structured_mix.py::structured_mix_grad``) route to these ops
only under ``torch.compiler.is_exporting()``. Eager training and serving
call the wrappers directly: the dispatcher costs about 20 us a call more
than a direct call (35 against 15 us for a tiny op on the CPU), and those
paths are bound by the host at small batch.
"""

from __future__ import annotations

import torch
from torch import Tensor

from spectre_tpu_torch.ops.kernels import attention, block_scatter, fused_linear
from spectre_tpu_torch.ops.kernels import structured_mix as _structured

NAMESPACE = "spectre_tpu_torch"


@torch.library.custom_op(f"{NAMESPACE}::block_scatter_rows", mutates_args=())
def block_scatter_rows(xt: Tensor, bsrc: Tensor, blk: int) -> Tensor:
    """``block_scatter.block_scatter_rows``: [d, B] -> [H*d, B]."""
    return block_scatter.block_scatter_rows(xt, bsrc, blk)


@block_scatter_rows.register_fake
def _(xt, bsrc, blk):
    return xt.new_empty((bsrc.shape[0] * xt.shape[0], xt.shape[1]))


@torch.library.custom_op(f"{NAMESPACE}::fused_spectre_linear", mutates_args=())
def fused_spectre_linear(x: Tensor, w: Tensor, b: Tensor, gamma: Tensor, beta: Tensor,
                         eps: float) -> Tensor:
    """``fused_linear.fused_spectre_linear`` without ``save_h``."""
    return fused_linear.fused_spectre_linear(x, w, b, gamma, beta, eps)


@fused_spectre_linear.register_fake
def _(x, w, b, gamma, beta, eps):
    return x.new_empty((*x.shape[:-1], w.shape[1]))


@torch.library.custom_op(f"{NAMESPACE}::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """O of ``attention.flash_attention_fwd``: a [B, H, N, D] view of
    [B, N, H, D] memory on every device, as the kernel writes it (the plain
    version's contiguous O is laid out so on the CPU), so that the strides
    the program was traced with hold when it runs."""
    o = attention.flash_attention_fwd(q, k, v)[0]
    if o.device.type == "cpu":
        o = attention._empty_bhnd(o).copy_(o)
    return o


@flash_attention_fwd.register_fake
def _(q, k, v):
    return attention._empty_bhnd(q)


@torch.library.custom_op(f"{NAMESPACE}::structured_mix", mutates_args=())
def structured_mix(x: Tensor, tile_perms: Tensor, signs: Tensor, token_dim: int,
                   inv: Tensor) -> Tensor:
    """``structured_mix.structured_mix``: -> [B, token_dim, H*d / token_dim]."""
    return _structured.structured_mix(x, tile_perms, signs, token_dim, inv)


@structured_mix.register_fake
def _(x, tile_perms, signs, token_dim, inv):
    return x.new_empty((x.shape[0], token_dim, signs.numel() // token_dim))

