"""FFT-domain ops (port of spectre_tpu/ops/fft.py): the FNet-style mixers and
the per-patch spectral embedding math.

At patch size P <= 8 the per-patch 2D rFFT is a small fixed linear map: its
real-part DFT matrix is folded into the patch projection, so the whole
SpectralPatchEmbed is one product over raw pixel patches. The FNet mixer
``fft2_real_matmul`` is likewise two dense DFT products per axis, the form
the JAX package runs; ``fft2_real`` is the same function through torch.fft.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def rfft_real(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Real part of the 1-D rFFT; the output has n // 2 + 1 values along
    ``axis``."""
    return torch.fft.rfft(x, dim=axis).real


def fft2_real(x: torch.Tensor) -> torch.Tensor:
    """FNet token mixer: Re(FFT over the embed axis, then the token axis),
    shape-preserving."""
    return torch.fft.fft2(x, dim=(-2, -1)).real


@lru_cache(maxsize=None)
def _dft_cos_sin_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Cosine and sine DFT matrices: C[u, j] = cos(2 pi u j / n), S likewise."""
    u = np.arange(n)
    ang = 2 * np.pi * np.outer(u, u) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=None)
def _dft_matrices(n: int, dtype: torch.dtype, device: torch.device):
    c, s = _dft_cos_sin_np(n)
    return (torch.tensor(c, dtype=dtype, device=device),
            torch.tensor(s, dtype=dtype, device=device))


def dft_matrices(n: int, dtype=torch.float32, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, S) of size [n, n], made once per size, dtype and device (a copy
    from the host on every call would stall the stream)."""
    return _dft_matrices(n, dtype, torch.device("cpu" if device is None else device))


def fft2_real_matmul(x: torch.Tensor) -> torch.Tensor:
    """Re(fft2(x)) over the last two axes by dense DFT products. For real x:
    Re(F_a x F_b^T) = C_a x C_b^T - S_a x S_b^T."""
    n_tok, n_emb = x.shape[-2], x.shape[-1]
    c_t, s_t = dft_matrices(n_tok, x.dtype, x.device)
    c_e, s_e = dft_matrices(n_emb, x.dtype, x.device)
    cx = torch.matmul(torch.matmul(c_t, x), c_e.t())
    sx = torch.matmul(torch.matmul(s_t, x), s_e.t())
    return cx - sx


def log_magnitude_rfft2(x: torch.Tensor) -> torch.Tensor:
    """log1p(|rfft2(x)|) over the last two axes."""
    return torch.log1p(torch.abs(torch.fft.rfft2(x, dim=(-2, -1))))


def extract_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, N, P, P]; patch n = (i, j) row-major, holding
    x[:, :, i*P:(i+1)*P, j*P:(j+1)*P]."""
    B, C, H, W = x.shape
    P = patch_size
    nH, nW = H // P, W // P
    x = x.reshape(B, C, nH, P, nW, P).permute(0, 1, 2, 4, 3, 5)
    return x.reshape(B, C, nH * nW, P, P)


def patch_rfft2_real(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Per-patch Re(rfft2(., norm="ortho")) through torch.fft, the direct form
    of what ``spectral_patch_matrix`` folds into one product: [B, C, H, W] ->
    [B, C, N, P, P//2+1]."""
    return torch.fft.rfft2(extract_patches(x, patch_size), norm="ortho").real


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
