"""Per-patch spectral embedding math (port of spectre_tpu/ops/fft.py:72-154).

At patch size P <= 8 the per-patch 2D rFFT is a small fixed linear map: its
real-part DFT matrix is folded into the patch projection, so the whole
SpectralPatchEmbed is one product over raw pixel patches.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def extract_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, N, P, P]; patch n = (i, j) row-major, holding
    x[:, :, i*P:(i+1)*P, j*P:(j+1)*P]."""
    B, C, H, W = x.shape
    P = patch_size
    nH, nW = H // P, W // P
    x = x.reshape(B, C, nH, P, nW, P).permute(0, 1, 2, 4, 3, 5)
    return x.reshape(B, C, nH * nW, P, P)


@lru_cache(maxsize=None)
def _rfft2_real_matrix_np(p: int) -> np.ndarray:
    """Dense matrix D of the linear map patch[P,P] -> Re(rfft2(patch, ortho)).

    D has shape [P*(P//2+1), P*P]; row (u, v), column (j, k):
    cos(2*pi*(u*j + v*k)/P) / P.
    """
    f = p // 2 + 1
    j = np.arange(p)
    u = np.arange(p)
    v = np.arange(f)
    ang = 2 * np.pi * (
        np.einsum("u,j->uj", u, j)[:, None, :, None]
        + np.einsum("v,k->vk", v, j)[None, :, None, :]
    ) / p
    d = (np.cos(ang) / p).reshape(p * f, p * p).astype(np.float32)
    d.setflags(write=False)
    return d


def rfft2_real_matrix(p: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor(_rfft2_real_matrix_np(p), dtype=dtype, device=device)


def spectral_patch_matrix(proj_w: torch.Tensor, freq_weight_h: torch.Tensor,
                          freq_weight_w: torch.Tensor, patch_size: int,
                          in_channels: int, dft: torch.Tensor | None = None) -> torch.Tensor:
    """Fold (rfft2 -> frequency reweight -> projection) into one [C*P*P, E]
    matrix W_eff with ``flatten_patches_cjk(x) @ W_eff == proj(freqw *
    Re(rfft2(patch, ortho)))``. proj_w: [C*P*F, E], input index (c, u, v);
    freq_weight_h: [P]; freq_weight_w: [F]. Computed in proj_w's dtype;
    ``dft`` is ``rfft2_real_matrix(P)`` on proj_w's device when the caller
    holds one."""
    P, F, C = patch_size, patch_size // 2 + 1, in_channels
    E = proj_w.shape[-1]
    d = rfft2_real_matrix(P, proj_w.dtype, proj_w.device) if dft is None else dft
    fw = (freq_weight_h[:, None] * freq_weight_w[None, :]).reshape(P * F)
    w = proj_w.reshape(C, P * F, E) * fw[None, :, None]
    w_eff = torch.einsum("fp,cfe->cpe", d, w)  # [C, P*P, E]
    return w_eff.reshape(C * P * P, E)


def flatten_patches_cjk(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, N, C*P*P] with (c, j, k) inner ordering."""
    patches = extract_patches(x, patch_size)  # [B, C, N, P, P]
    B, C, N, P, _ = patches.shape
    return patches.permute(0, 2, 1, 3, 4).reshape(B, N, C * P * P)
