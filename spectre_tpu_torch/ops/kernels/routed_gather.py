"""Kernel B9: the permutation-mix backward through 3-stage Clos route tables.

``dxt[j, :] = sum_h g[h*d + inv[h, j], :]``, [H*d, B] -> [d, B], where
``inv`` is given by its route over the [r, c] view of the rows (j = q*c + s):
``t = c_idx[h, q, s]``, ``p = b_idx[h, q, t]``,
``inv[h, j] = p*c + a_idx[h, p, t]`` (tables from ops/routing.py). The sum
runs in head order in the data type, rounded after every head: in bf16 the
bf16 chain ``o = o + y_h`` of the TPU kernel, in f32 the float32 sum of
kernel 4 bit for bit. The CUDA kernel is ``csrc/routed_gather_sum.cu`` (it
replaces the TPU kernel ``spectre_tpu/ops/pallas/routed_gather.py::
routed_gather_sum_pallas``); the plain version below states the same
arithmetic in PyTorch, as the three stages' gathers.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain path.
"""

from __future__ import annotations

import torch

from spectre_tpu_torch.ops.kernels.build import check, load_library

_DTYPES = (torch.float32, torch.bfloat16)


def routed_gather_sum_plain(g: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor,
                            c_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: per head the three stages as gathers over the
    [r, c, B] view (A within a row, B across rows, C within a row), then
    ``o = o + y_h`` in g's dtype, head by head."""
    h, r, c = a_idx.shape
    b = g.shape[1]
    gv = g.reshape(h, r, c, b)
    out = None
    for i in range(h):
        out1 = torch.gather(gv[i], 1, a_idx[i].long()[..., None].expand(r, c, b))
        out2 = torch.gather(out1, 0, b_idx[i].long()[..., None].expand(r, c, b))
        y = torch.gather(out2, 1, c_idx[i].long()[..., None].expand(r, c, b))
        out = y if out is None else out + y
    return out.reshape(r * c, b)


def _validate(g: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor,
              c_idx: torch.Tensor) -> None:
    if g.dim() != 2 or a_idx.dim() != 3:
        raise ValueError(f"want g [H*d, B] and tables [H, r, c]; got {tuple(g.shape)}, "
                         f"{tuple(a_idx.shape)}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"routed_gather_sum takes float32 or bfloat16, not {g.dtype}")
    for name, t in (("a_idx", a_idx), ("b_idx", b_idx), ("c_idx", c_idx)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, not {t.dtype}")
        if t.shape != a_idx.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != a_idx {tuple(a_idx.shape)}")
        if t.device != g.device:
            raise ValueError(f"g on {g.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"routed_gather_sum needs a contiguous {name}")
    h, r, c = a_idx.shape
    if min(h, r, c, g.shape[1]) < 1 or g.shape[0] != h * r * c:
        raise ValueError(f"g rows {g.shape[0]} != H={h} * r={r} * c={c} (B={g.shape[1]})")
    if not g.is_contiguous():
        raise ValueError("routed_gather_sum needs a contiguous g")


def routed_gather_sum(g: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor,
                      c_idx: torch.Tensor) -> torch.Tensor:
    """[H*d, B] -> [d, B] head-summed routed inverse permutation (any B >= 1,
    any r and c with r*c = d)."""
    _validate(g, a_idx, b_idx, c_idx)
    if g.device.type == "cpu":
        return routed_gather_sum_plain(g, a_idx, b_idx, c_idx)
    if g.device.type != "cuda":
        raise RuntimeError(f"routed_gather_sum: no kernel for device {g.device}")
    lib = load_library()
    h, r, c = a_idx.shape
    b = g.shape[1]
    out = torch.empty((r * c, b), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.routed_gather_sum(
            g.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(), c_idx.data_ptr(),
            out.data_ptr(), h, r, c, b, g.element_size(),
            torch.cuda.current_stream().cuda_stream)
    check(err, "routed_gather_sum launch")
    routed_gather_sum.launches += 1
    return out


routed_gather_sum.launches = 0
