"""Patch embeddings (port of spectre_tpu/models/patch_embed.py).

``PatchEmbedding``: a convolution with kernel = stride = P is a patchify
reshape and one product over [B, N, C*P*P] patches (``patcher``), then the
CLS token, learned position embeddings and dropout.

``SpectralPatchEmbed`` semantics: unfold P x P patches -> Re(rfft2(patch, ortho)) -> per-frequency
weights freq_weight_h [P] and freq_weight_w [P//2+1] -> flatten (c, u, v) ->
projection to E -> CLS token + position embeddings -> dropout. The DFT, the frequency
weights and the projection fold into one [C*P*P, E] matrix per call, so the
forward is a single product on raw pixel patches.
"""

from __future__ import annotations

import torch
from torch import nn

from spectre_tpu_torch.models.init import normal_, uniform_fan_in_
from spectre_tpu_torch.models.layers import Dense, Dropout
from spectre_tpu_torch.ops import flatten_patches_cjk, rfft2_real_matrix, spectral_patch_matrix


class PatchEmbedding(nn.Module):
    """[B, C, H, W] -> [B, N+1, E]. flax names: patcher (kernel [C*P*P, E],
    bias), cls_token [1, 1, E], position_embeddings [1, N+1, E]."""

    def __init__(self, embed_dim: int, patch_size: int, num_patches: int,
                 in_channels: int, *, dropout: float = 0.0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        kw = dict(dtype=param_dtype, device=device)
        self.patcher = Dense(in_channels * patch_size * patch_size, embed_dim, dtype=dtype,
                             param_dtype=param_dtype, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, **kw))
        self.position_embeddings = nn.Parameter(
            torch.empty(1, num_patches + 1, embed_dim, **kw))
        self.dropout = Dropout(dropout)

    def init_parameters(self, gen: torch.Generator) -> None:
        normal_(self.cls_token, gen)
        normal_(self.position_embeddings, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = self.patcher(flatten_patches_cjk(x.to(dt), self.patch_size))  # [B, N, E]
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        return self.dropout(torch.cat([cls, x], dim=1) + self.position_embeddings.to(dt))


class SpectralPatchEmbed(nn.Module):
    """[B, C, H, W] -> [B, N+1, E]. flax names: freq_weight_h, freq_weight_w,
    proj_kernel [C*P*F, E], proj_bias, cls_token [1, 1, E],
    position_embeddings [1, N+1, E]."""

    def __init__(self, embed_dim: int, patch_size: int, num_patches: int,
                 in_channels: int, *, dropout: float = 0.0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        P, F, C = patch_size, patch_size // 2 + 1, in_channels
        self.patch_size, self.in_channels, self.dtype = P, C, dtype
        kw = dict(dtype=param_dtype, device=device)
        self.freq_weight_h = nn.Parameter(torch.ones(P, **kw))
        self.freq_weight_w = nn.Parameter(torch.ones(F, **kw))
        self.proj_kernel = nn.Parameter(torch.empty(C * P * F, embed_dim, **kw))
        self.proj_bias = nn.Parameter(torch.empty(embed_dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim, **kw))
        self.position_embeddings = nn.Parameter(
            torch.empty(1, num_patches + 1, embed_dim, **kw))
        # the real-part DFT matrix, built once (no host copy per call)
        self.dropout = Dropout(dropout)
        self.register_buffer("dft", rfft2_real_matrix(P, dtype, device), persistent=False)

    def init_parameters(self, gen: torch.Generator) -> None:
        fan_in = self.proj_kernel.shape[0]
        with torch.no_grad():
            self.freq_weight_h.fill_(1.0)
            self.freq_weight_w.fill_(1.0)
        uniform_fan_in_(self.proj_kernel, fan_in, gen)
        uniform_fan_in_(self.proj_bias, fan_in, gen)
        normal_(self.cls_token, gen)
        normal_(self.position_embeddings, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w_eff = spectral_patch_matrix(self.proj_kernel.to(dt), self.freq_weight_h.to(dt),
                                      self.freq_weight_w.to(dt), self.patch_size,
                                      self.in_channels, self.dft)  # [C*P*P, E]
        patches = flatten_patches_cjk(x.to(dt), self.patch_size)  # [B, N, C*P*P]
        x = torch.matmul(patches, w_eff) + self.proj_bias.to(dt)
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        return self.dropout(torch.cat([cls, x], dim=1) + self.position_embeddings.to(dt))
