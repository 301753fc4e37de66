"""Kernel 6: the Walsh-Hadamard transform of the last axis.

``out[..., :] = scale * H_n x[..., :]`` in natural (Sylvester) order, n a
power of two, scale = n^-1/2 when ``normalize``. The CUDA kernel is
``csrc/fwht.cu`` (it replaces the TPU kernel
``spectre_tpu/ops/pallas/fwht.py::fwht_pallas``); the plain version below
states the same arithmetic in PyTorch: widen to float32, log2(n) butterfly
stages that turn each pair (a, b) of a 2h-block into (a + b, a - b), one
multiply by the scale, one cast. Kernel and plain version add the same
float32 pairs in the same order.

The transform is its own adjoint (H_n is symmetric), so ``fwht_grad``, the
differentiable form, runs the same function on the cotangent.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback from a CUDA tensor to the plain path.
"""

from __future__ import annotations

import torch

from spectre_tpu_torch.ops.kernels.build import check, load_library

_DTYPES = (torch.float32, torch.bfloat16)
MAX_N = 32768  # a row lives in shared memory as float32 (csrc/fwht.cu)


def _check_pow2(n: int) -> None:
    if n & (n - 1) or n == 0:
        raise ValueError(f"FWHT length must be a power of 2, got {n}")


def fwht_plain(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the butterfly in float32, cast once."""
    n = x.shape[-1]
    _check_pow2(n)
    y = x.float().reshape(-1, n)
    h = 1
    while h < n:
        y = y.reshape(-1, n // (2 * h), 2, h)
        a, b = y[:, :, 0, :], y[:, :, 1, :]
        y = torch.cat((a + b, a - b), dim=-1)
        h *= 2
    y = y.reshape(x.shape)
    if normalize:
        y = y * (n ** -0.5)
    return y.to(x.dtype)


def fwht(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Walsh-Hadamard transform over the last axis; the leading axes are
    rows. Not differentiable: ``fwht_grad`` is."""
    if x.dim() < 1:
        raise ValueError("fwht needs at least one axis")
    n = x.shape[-1]
    _check_pow2(n)
    if x.dtype not in _DTYPES:
        raise TypeError(f"fwht takes float32 or bfloat16, not {x.dtype}")
    if x.device.type == "cpu":
        return fwht_plain(x, normalize)
    if x.device.type != "cuda":
        raise RuntimeError(f"fwht: no kernel for device {x.device}")
    if n > MAX_N:
        raise ValueError(f"fwht kernel takes n <= {MAX_N}, got {n}")
    if not x.is_contiguous():
        raise ValueError("fwht needs a contiguous x")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.fwht(x.data_ptr(), out.data_ptr(), x.numel(), n,
                       n ** -0.5 if normalize else 1.0, x.element_size(),
                       torch.cuda.current_stream().cuda_stream)
    check(err, "fwht launch")
    fwht.launches += 1
    return out


fwht.launches = 0


class _FWHT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, normalize):
        ctx.normalize = normalize
        return fwht(x, normalize)

    @staticmethod
    def backward(ctx, g):
        return fwht(g.contiguous(), ctx.normalize), None


def fwht_grad(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """``fwht`` with a gradient for x: the same transform of the cotangent."""
    return _FWHT.apply(x, normalize)
