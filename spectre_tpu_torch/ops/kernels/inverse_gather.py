"""Kernel 4: the backward of the row permutation for uniform tables.

``dxt[j, :] = sum_h g[h*d + inv[h, j], :]``, [H*d, B] -> [d, B], with
``inv = argsort(perms)`` per head: the float32 sum over heads, taken in head
order and cast once. The CUDA kernel is ``csrc/inverse_gather_sum.cu`` (it
replaces the TPU kernel ``spectre_tpu/ops/pallas/bwd_gather.py::
inverse_gather_sum_pallas``); the plain version below states the same
arithmetic in PyTorch. It is kernel 3 at a block of one row, with its own
entry point.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain path.
"""

from __future__ import annotations

import torch

from spectre_tpu_torch.ops.kernels.build import check, load_library

_DTYPES = (torch.float32, torch.bfloat16)


def inverse_gather_sum_plain(g: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: per head, gather rows, widen to float32 and
    add in head order; one cast at the end."""
    h, d = inv.shape
    gh = g.reshape(h, d, -1)
    acc = gh[0].index_select(0, inv[0]).float()
    for i in range(1, h):
        acc += gh[i].index_select(0, inv[i]).float()
    return acc.to(g.dtype)


def _validate(g: torch.Tensor, inv: torch.Tensor) -> None:
    if g.dim() != 2 or inv.dim() != 2:
        raise ValueError(f"want g [H*d, B] and inv [H, d]; got {tuple(g.shape)}, "
                         f"{tuple(inv.shape)}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"inverse_gather_sum takes float32 or bfloat16, not {g.dtype}")
    if inv.dtype != torch.int32:
        raise TypeError(f"inv must be int32, not {inv.dtype}")
    h, d = inv.shape
    if h < 1 or d < 1 or g.shape[0] != h * d:
        raise ValueError(f"g rows {g.shape[0]} != H={h} * d={d}")
    if g.device != inv.device:
        raise ValueError(f"g on {g.device} but inv on {inv.device}")
    if not (g.is_contiguous() and inv.is_contiguous()):
        raise ValueError("inverse_gather_sum needs contiguous g and inv")


def inverse_gather_sum(g: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """[H*d, B] -> [d, B] head-summed inverse row permutation (any B >= 1)."""
    _validate(g, inv)
    if g.device.type == "cpu":
        return inverse_gather_sum_plain(g, inv)
    if g.device.type != "cuda":
        raise RuntimeError(f"inverse_gather_sum: no kernel for device {g.device}")
    lib = load_library()
    h, d = inv.shape
    b = g.shape[1]
    out = torch.empty((d, b), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.inverse_gather_sum(
            g.data_ptr(), inv.data_ptr(), out.data_ptr(), h, d, b,
            g.element_size(), torch.cuda.current_stream().cuda_stream)
    check(err, "inverse_gather_sum launch")
    inverse_gather_sum.launches += 1
    return out


inverse_gather_sum.launches = 0
