"""SpectreBranch, the dual-path model: a token trunk and a frequency-domain
CNN branch (port of spectre_tpu/models/spectre_branch.py).

- ``SpectreFeatExtractor``: log1p(|rfft2(image)|) by dense DFT products, then
  per stage a 3x3 VALID convolution (channels x3) feeding a 1x1 projection
  to E, flattened, average-pooled to N tokens and transposed: [B, N, E].
- ``SpectreBranchEncoderLayer``: x = norm1(mix(x)) + x; then
  linear1 -> dropout -> linear2 -> linear3 -> dropout, plain ``Dense``
  layers, and norm2(x + ff). ``method=None`` or ``"none"`` skips the mix.
- ``SpectreBranchEncoder``: each layer's output is concatenated with its
  stage's features and fused back to E by ``spectre_project_<i>`` (Dense
  2E -> E); the global residual at the end.
- ``SpectreBranch``: ``PatchEmbedding`` -> encoder -> ``mlp_head`` on CLS.

Module and parameter names mirror the flax tree (``embeddings_block``,
``encoder_blocks.spectre_branch.stage_<i>`` / ``project_<i>``,
``encoder_blocks.layer_<i>.mix_layer``, ``spectre_project_<i>``,
``mlp_head``), and the convolution kernels keep flax's [kH, kW, I, O]
layout, so the weight bridge moves no array.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spectre_tpu_torch.models.init import uniform_fan_in_
from spectre_tpu_torch.models.layers import Dense, Dropout, LayerNorm
from spectre_tpu_torch.models.mixers import make_mixer
from spectre_tpu_torch.models.patch_embed import PatchEmbedding
from spectre_tpu_torch.ops import adaptive_avg_pool1d, adaptive_pool_matrix, dft_matrices


def rfft2_log_magnitude_matmul(x: torch.Tensor) -> torch.Tensor:
    """log1p(|rfft2(x)|) over the last two axes by DFT products in x's dtype.

    For real x: X = F_h x F_w^T on the first W//2+1 columns;
    Re = C_h x C_w^T - S_h x S_w^T, Im = -(C_h x S_w^T + S_h x C_w^T).
    """
    h, w = x.shape[-2], x.shape[-1]
    ch, sh = dft_matrices(h, x.dtype, x.device)
    cw, sw = dft_matrices(w, x.dtype, x.device)
    f = w // 2 + 1
    cw, sw = cw[:f], sw[:f]
    cx, sx = torch.matmul(ch, x), torch.matmul(sh, x)
    re = torch.matmul(cx, cw.t()) - torch.matmul(sx, sw.t())
    im = -(torch.matmul(cx, sw.t()) + torch.matmul(sx, cw.t()))
    return torch.log1p(torch.sqrt(re * re + im * im))


class Conv(nn.Module):
    """flax ``nn.Conv`` with VALID padding and stride 1 over NCHW input:
    ``kernel`` [kH, kW, I, O] (flax's layout, permuted to OIHW at the call)
    and ``bias`` [O], in the compute dtype. Init: the kernel
    U(+-1/sqrt(kH*kW*I)), the bias U(+-1/sqrt(bias_fan_in))."""

    def __init__(self, in_channels: int, features: int, size: int, *, bias_fan_in: int,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self.bias_fan_in = dtype, bias_fan_in
        kw = dict(dtype=param_dtype, device=device)
        self.kernel = nn.Parameter(torch.empty(size, size, in_channels, features, **kw))
        self.bias = nn.Parameter(torch.empty(features, **kw))

    def init_parameters(self, gen: torch.Generator) -> None:
        kh, kw, i, _ = self.kernel.shape
        uniform_fan_in_(self.kernel, kh * kw * i, gen)
        uniform_fan_in_(self.bias, self.bias_fan_in, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), self.kernel.to(dt).permute(3, 2, 0, 1), self.bias.to(dt))


class SpectreFeatExtractor(nn.Module):
    """CNN pyramid over the image's log-magnitude spectrum: per stage a 3x3
    conv (channels x3) and a 1x1 projection to E, pooled to ``num_tokens``.
    Returns the last stage's activations (NHWC, as flax) and the per-stage
    features [B, N, E]. The pool matrices of the stages whose widths do not
    divide are made once, for ``img_size`` inputs (a copy from the host per
    call would stall the stream). The JAX module's ``reduction`` (a crop of
    the spectrum) is left out: every config and caller keeps its default, 1."""

    def __init__(self, in_channels: int, embed_dim: int, num_tokens: int, num_stages: int,
                 img_size: int, *, dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_tokens, self.num_stages, self.dtype = num_tokens, num_stages, dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        height, width = img_size, img_size // 2 + 1
        channels = in_channels
        for i in range(num_stages):
            prev, channels = channels, channels * 3
            self.add_module(f"stage_{i}", Conv(prev, channels, 3, bias_fan_in=prev * 9, **kw))
            self.add_module(f"project_{i}", Conv(channels, embed_dim, 1, bias_fan_in=channels,
                                                 **kw))
            height, width = height - 2, width - 2
            length = height * width
            self.register_buffer(f"pool_{i}", adaptive_pool_matrix(
                length, num_tokens, dtype, device) if length % num_tokens else None,
                persistent=False)

    def _pool(self, p: torch.Tensor, i: int) -> torch.Tensor:
        m = getattr(self, f"pool_{i}")
        return adaptive_avg_pool1d(p, self.num_tokens) if m is None else torch.matmul(p, m)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        h = rfft2_log_magnitude_matmul(x.to(self.dtype))  # [B, C, H, W//2+1]
        feats = []
        for i in range(self.num_stages):
            h = getattr(self, f"stage_{i}")(h)
            p = getattr(self, f"project_{i}")(h)  # [B, E, H', W']
            p = self._pool(p.reshape(p.shape[0], p.shape[1], -1), i)  # [B, E, N]
            feats.append(p.transpose(1, 2))  # [B, N, E]
        return h.permute(0, 2, 3, 1), feats


class SpectreBranchEncoderLayer(nn.Module):
    """The configured mixer and a deeper feed-forward block than
    SpectreEncoderLayer's: linear1 -> linear2 -> linear3, plain Denses."""

    def __init__(self, seq_length: int, d_model: int, nhead: int, dim_feedforward: int,
                 *, dropout: float = 0.0, method: str | None = "permut_mix",
                 mix_impl: str = "folded", mix_block: int = 0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.mix_layer = None if method in (None, "none") else make_mixer(
            method, embed_dim=d_model, seq_length=seq_length, num_heads=nhead, dropout=dropout,
            mix_impl=mix_impl, mix_block=mix_block, **kw)
        ln = dict(eps=1e-5, dtype=param_dtype, device=device)
        self.norm1 = LayerNorm(d_model, **ln)
        self.norm2 = LayerNorm(d_model, **ln)
        self.linear1 = Dense(d_model, dim_feedforward, **kw)
        self.linear2 = Dense(dim_feedforward, dim_feedforward, **kw)
        self.linear3 = Dense(dim_feedforward, d_model, **kw)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mixed = x if self.mix_layer is None else self.mix_layer(x)
        x = self.norm1(mixed) + x
        h = self.linear3(self.linear2(self.dropout(self.linear1(x), self.linear1)))
        return self.norm2(x + self.dropout(h))


class SpectreBranchEncoder(nn.Module):
    """``spectre_branch`` (the feature extractor), ``layer_<i>`` and
    ``spectre_project_<i>`` as in the flax tree; global residual."""

    def __init__(self, num_layers: int, num_patches: int, seq_length: int, d_model: int,
                 nhead: int, dim_feedforward: int, *, img_size: int, dropout: float = 0.0,
                 in_channels: int = 3, method: str | None = "permut_mix",
                 mix_impl: str = "folded", mix_block: int = 0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.num_layers = num_layers
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.spectre_branch = SpectreFeatExtractor(in_channels, d_model, num_patches,
                                                   num_layers, img_size, **kw)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", SpectreBranchEncoderLayer(
                seq_length, d_model, nhead, dim_feedforward, dropout=dropout, method=method,
                mix_impl=mix_impl, mix_block=mix_block, **kw))
            self.add_module(f"spectre_project_{i}", Dense(2 * d_model, d_model, **kw))

    def forward(self, src: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        _, feats = self.spectre_branch(img)
        out = src
        for i in range(self.num_layers):
            y = getattr(self, f"layer_{i}")(out)
            out = getattr(self, f"spectre_project_{i}")(torch.cat([y, feats[i]], dim=-1))
        return out + src


class SpectreBranch(nn.Module):
    def __init__(self, img_size: int = 32, patch_size: int = 4, in_channels: int = 3,
                 num_classes: int = 10, embed_dim: int = 768, num_encoders: int = 12,
                 num_heads: int = 12, hidden_dim: int = 3072, *, dropout: float = 0.1,
                 method: str | None = "permut_mix", mix_impl: str = "folded",
                 mix_block: int = 0, dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        num_patches = (img_size // patch_size) ** 2
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.embeddings_block = PatchEmbedding(embed_dim, patch_size, num_patches, in_channels,
                                               dropout=dropout, **kw)
        self.encoder_blocks = SpectreBranchEncoder(
            num_encoders, num_patches + 1, num_patches + 1, embed_dim, num_heads, hidden_dim,
            img_size=img_size, dropout=dropout, in_channels=in_channels, method=method,
            mix_impl=mix_impl, mix_block=mix_block, **kw)
        self.mlp_head = Dense(embed_dim, num_classes, **kw)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """x: [B, C, H, W] -> logits [B, classes] in float32 (and the CLS
        features, float32, with ``return_features``)."""
        x = self.encoder_blocks(self.embeddings_block(x), x)
        cls_token = x[:, 0, :]
        logits = self.mlp_head(cls_token).float()
        if return_features:
            return logits, cls_token.float()
        return logits
