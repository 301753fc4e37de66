"""Haar discrete wavelet transforms (port of spectre_tpu/ops/dwt.py).

A fixed 2-tap lifting stencil written with reshapes. Conventions match
pywt's "haar" with zero padding: approx = (a + b) / sqrt(2), detail =
(a - b) / sqrt(2) over non-overlapping pairs.
"""

from __future__ import annotations

import torch

_SQRT2 = 2.0 ** 0.5


def haar_dwt1d(x: torch.Tensor, axis: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-level 1-D Haar DWT along ``axis`` (even length required).
    Returns (approx, detail), each of half length."""
    n = x.shape[axis]
    if n % 2:
        raise ValueError(f"haar_dwt1d needs even length, got {n}")
    x = torch.movedim(x, axis, -1)
    x = x.reshape(*x.shape[:-1], n // 2, 2)
    a = (x[..., 0] + x[..., 1]) / _SQRT2
    d = (x[..., 0] - x[..., 1]) / _SQRT2
    return torch.movedim(a, -1, axis), torch.movedim(d, -1, axis)


def haar_idwt1d(approx: torch.Tensor, detail: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of ``haar_dwt1d``."""
    a = torch.movedim(approx, axis, -1)
    d = torch.movedim(detail, axis, -1)
    even = (a + d) / _SQRT2
    odd = (a - d) / _SQRT2
    x = torch.stack([even, odd], dim=-1).reshape(*a.shape[:-1], a.shape[-1] * 2)
    return torch.movedim(x, -1, axis)


def haar_dwt_mix(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Shape-preserving Haar mixer: concat(approx, detail) along ``axis``
    (the dwt_embed / dwt_token mixers). For odd lengths the last element is
    passed through unscaled, between the two halves."""
    n = x.shape[axis]
    if n % 2 == 0:
        a, d = haar_dwt1d(x, axis=axis)
        return torch.cat([a, d], dim=axis)
    xm = torch.movedim(x, axis, -1)
    head, tail = xm[..., :n - 1], xm[..., n - 1:]
    a, d = haar_dwt1d(head, axis=-1)
    return torch.movedim(torch.cat([a, tail, d], dim=-1), -1, axis)


def haar_dwt2d(x: torch.Tensor):
    """Single-level 2-D Haar DWT over the last two axes: (LL, (LH, HL, HH)),
    in pytorch_wavelets' (approx, (H, V, D)) order."""
    lo_r, hi_r = haar_dwt1d(x, axis=-2)
    ll, lh = haar_dwt1d(lo_r, axis=-1)
    hl, hh = haar_dwt1d(hi_r, axis=-1)
    return ll, (lh, hl, hh)


def haar_idwt2d(ll: torch.Tensor, highs) -> torch.Tensor:
    lh, hl, hh = highs
    lo_r = haar_idwt1d(ll, lh, axis=-1)
    hi_r = haar_idwt1d(hl, hh, axis=-1)
    return haar_idwt1d(lo_r, hi_r, axis=-2)


def haar_dwt2d_multilevel(x: torch.Tensor, levels: int):
    """J-level 2-D decomposition: (LL_J, [highs_1, ..., highs_J])."""
    highs = []
    ll = x
    for _ in range(levels):
        ll, h = haar_dwt2d(ll)
        highs.append(h)
    return ll, highs
