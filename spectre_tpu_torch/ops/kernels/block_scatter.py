"""Kernel 1: the block-row permutation of the folded mix forward.

``out[h*d + jb*blk + t, :] = xt[bsrc[h, jb]*blk + t, :]``, [d, B] -> [H*d, B],
with ``bsrc = perms[:, ::blk] // blk``. The CUDA kernel is
``csrc/block_scatter_rows.cu`` (it replaces the TPU kernel
``spectre_tpu/ops/pallas/bwd_gather.py::block_scatter_rows_pallas``); the
plain version below is the same copy written with ``index_select``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain path.
"""

from __future__ import annotations

import torch

from spectre_tpu_torch.ops.kernels.build import check, load_library

_DTYPES = (torch.float32, torch.bfloat16)


def block_scatter_rows_plain(xt: torch.Tensor, bsrc: torch.Tensor,
                             blk: int) -> torch.Tensor:
    """Plain PyTorch version: whole blk*B chunks selected by ``bsrc``."""
    d, b = xt.shape
    h, nb = bsrc.shape
    return xt.reshape(nb, blk * b).index_select(0, bsrc.reshape(-1)).reshape(h * d, b)


def _validate(xt: torch.Tensor, bsrc: torch.Tensor, blk: int) -> None:
    if xt.dim() != 2 or bsrc.dim() != 2:
        raise ValueError(f"want xt [d, B] and bsrc [H, d/blk]; got {tuple(xt.shape)}, "
                         f"{tuple(bsrc.shape)}")
    if xt.dtype not in _DTYPES:
        raise TypeError(f"block_scatter_rows takes float32 or bfloat16, not {xt.dtype}")
    if bsrc.dtype != torch.int32:
        raise TypeError(f"bsrc must be int32, not {bsrc.dtype}")
    if blk < 1 or xt.shape[0] != bsrc.shape[1] * blk:
        raise ValueError(f"xt rows {xt.shape[0]} != (d/blk={bsrc.shape[1]}) * blk={blk}")
    if xt.device != bsrc.device:
        raise ValueError(f"xt on {xt.device} but bsrc on {bsrc.device}")
    if not (xt.is_contiguous() and bsrc.is_contiguous()):
        raise ValueError("block_scatter_rows needs contiguous xt and bsrc")


def block_scatter_rows(xt: torch.Tensor, bsrc: torch.Tensor, blk: int) -> torch.Tensor:
    """[d, B] -> [H*d, B] block-row permutation (exact copy, any B >= 1)."""
    _validate(xt, bsrc, blk)
    if xt.device.type == "cpu":
        return block_scatter_rows_plain(xt, bsrc, blk)
    if xt.device.type != "cuda":
        raise RuntimeError(f"block_scatter_rows: no kernel for device {xt.device}")
    lib = load_library()
    d, b = xt.shape
    h, nb = bsrc.shape
    out = torch.empty((h * d, b), dtype=xt.dtype, device=xt.device)
    with torch.cuda.device(xt.device):
        err = lib.block_scatter_rows(
            xt.data_ptr(), bsrc.data_ptr(), out.data_ptr(), h, nb, blk, b,
            xt.element_size(), torch.cuda.current_stream().cuda_stream)
    check(err, "block_scatter_rows launch")
    block_scatter_rows.launches += 1
    return out


block_scatter_rows.launches = 0
