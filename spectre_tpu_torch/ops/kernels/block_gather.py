"""Kernel 3: the backward of the block-row permutation (kernel 1).

``dxt[jb*blk + t, :] = sum_h g[h*d + binv[h, jb]*blk + t, :]``, [H*d, B] ->
[d, B], with ``binv = argsort(bsrc)`` per head: the float32 sum over heads,
taken in head order and cast once. The CUDA kernel is
``csrc/block_gather_sum.cu`` (it replaces the TPU kernel
``spectre_tpu/ops/pallas/bwd_gather.py::block_gather_sum_pallas``); the plain
version below states the same arithmetic in PyTorch.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain path.
"""

from __future__ import annotations

import torch

from spectre_tpu_torch.ops.kernels.build import check, load_library

_DTYPES = (torch.float32, torch.bfloat16)


def block_gather_sum_plain(g: torch.Tensor, binv: torch.Tensor, blk: int) -> torch.Tensor:
    """Plain PyTorch version: per head, gather whole blk*B chunks, widen to
    float32 and add in head order; one cast at the end."""
    h, nb = binv.shape
    b = g.shape[1]
    gh = g.reshape(h, nb, blk * b)
    acc = gh[0].index_select(0, binv[0]).float()
    for i in range(1, h):
        acc += gh[i].index_select(0, binv[i]).float()
    return acc.to(g.dtype).reshape(nb * blk, b)


def _validate(g: torch.Tensor, binv: torch.Tensor, blk: int) -> None:
    if g.dim() != 2 or binv.dim() != 2:
        raise ValueError(f"want g [H*d, B] and binv [H, d/blk]; got {tuple(g.shape)}, "
                         f"{tuple(binv.shape)}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"block_gather_sum takes float32 or bfloat16, not {g.dtype}")
    if binv.dtype != torch.int32:
        raise TypeError(f"binv must be int32, not {binv.dtype}")
    h, nb = binv.shape
    if blk < 1 or h < 1 or g.shape[0] != h * nb * blk:
        raise ValueError(f"g rows {g.shape[0]} != H={h} * (d/blk={nb}) * blk={blk}")
    if g.device != binv.device:
        raise ValueError(f"g on {g.device} but binv on {binv.device}")
    if not (g.is_contiguous() and binv.is_contiguous()):
        raise ValueError("block_gather_sum needs contiguous g and binv")


def block_gather_sum(g: torch.Tensor, binv: torch.Tensor, blk: int) -> torch.Tensor:
    """[H*d, B] -> [d, B] head-summed inverse block permutation (any B >= 1)."""
    _validate(g, binv, blk)
    if g.device.type == "cpu":
        return block_gather_sum_plain(g, binv, blk)
    if g.device.type != "cuda":
        raise RuntimeError(f"block_gather_sum: no kernel for device {g.device}")
    lib = load_library()
    h, nb = binv.shape
    b = g.shape[1]
    out = torch.empty((nb * blk, b), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.block_gather_sum(
            g.data_ptr(), binv.data_ptr(), out.data_ptr(), h, nb, blk, b,
            g.element_size(), torch.cuda.current_stream().cuda_stream)
    check(err, "block_gather_sum launch")
    block_gather_sum.launches += 1
    return out


block_gather_sum.launches = 0
