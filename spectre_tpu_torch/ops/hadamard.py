"""Fast Walsh-Hadamard transforms (port of spectre_tpu/ops/hadamard.py).

- ``fwht``               natural (Hadamard) order along any axis, normalised
                         by default. On a CUDA tensor it launches the
                         hand-written kernel (ops/kernels/fwht.py); an axis
                         other than the last is moved to the last first.
- ``fwht_interleaved``   interleaved butterfly over the last axis,
                         unnormalised, purely functional (differentiable).
- ``hadamard_transform`` the normalised transform of a vector or a [B, D]
                         batch; the same values as ``fwht(normalize=True)``.
- ``learnable_hadamard`` residual block: pad to a power of two, one
                         interleaved pass per learnable scale, crop, add.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F

from spectre_tpu_torch.ops.kernels import fwht_grad


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 << (int(n) - 1).bit_length()


def _check_pow2(n: int) -> None:
    if n & (n - 1) or n == 0:
        raise ValueError(f"FWHT length must be a power of 2, got {n}")


def fwht(x: torch.Tensor, axis: int = -1, normalize: bool = True) -> torch.Tensor:
    """Walsh-Hadamard transform along ``axis``, natural ordering: each stage
    splits every 2h-block into two h-halves (a, b) and emits (a + b, a - b).
    Differentiable (the transform is its own adjoint)."""
    _check_pow2(x.shape[axis])
    moved = torch.movedim(x, axis, -1)
    return torch.movedim(fwht_grad(moved.contiguous(), normalize), -1, axis)


def fwht_interleaved(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-output FWHT over the last axis, unnormalised: each stage
    writes (a + b) to even lanes and (a - b) to odd lanes."""
    shape = x.shape
    n = shape[-1]
    _check_pow2(n)
    x = x.reshape(-1, n)
    m = x.shape[0]
    h = 1
    while h < n:
        x = x.reshape(m, -1, 2 * h)
        a, b = x[..., :h], x[..., h:2 * h]
        x = torch.stack((a + b, a - b), dim=-1).reshape(m, -1, 2 * h)
        h *= 2
    return x.reshape(shape)


def hadamard_transform(x: torch.Tensor) -> torch.Tensor:
    """Normalised FWHT for 1-D vectors or [B, D] batches."""
    if x.dim() not in (1, 2):
        raise ValueError("input's dimension must be either 1 or 2")
    return fwht(x, axis=-1, normalize=True)


def learnable_hadamard(x: torch.Tensor, scales: Sequence[torch.Tensor]) -> torch.Tensor:
    """Residual Hadamard block: pad the last axis to a power of two, apply
    one unnormalised interleaved pass per scale (each multiplied by its
    per-lane scale), crop back and add the input."""
    orig_dim = x.shape[-1]
    dim = next_pow2(orig_dim)
    residual = x
    if dim != orig_dim:
        x = F.pad(x, (0, dim - orig_dim))
    for p in scales:
        x = fwht_interleaved(x) * p
    return x[..., :orig_dim] + residual
