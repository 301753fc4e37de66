"""SpectreViT, the attention-free spectral ViT (port of
spectre_tpu/models/spectre.py).

Topology (kept from the reference, residuals included):

- SpectreEncoderLayer:  x = norm1(mix(x)) + x;  x = norm2(x + linear3(linear1(x)))
- SpectreEncoder:       layer_0 .. layer_{n-1}, then the global residual + src
- SpectreViT:           SpectralPatchEmbed -> encoder -> CLS -> SpectreLinear head

``mix`` is the configured mixer (``models/mixers.py::make_mixer``: the
permutation mix in any of its impls, the FFT and DWT mixers, attention).

Dropout sits where the flax model has it: after the embedding, after
``linear1`` and after ``linear3``. It is the identity in eval mode, which
is the mode ``build_model`` returns unless asked to train.
"""

from __future__ import annotations

import torch
from torch import nn

from spectre_tpu_torch.models.layers import Dropout, LayerNorm, SpectreLinear
from spectre_tpu_torch.models.mixers import make_mixer
from spectre_tpu_torch.models.patch_embed import SpectralPatchEmbed


class SpectreEncoderLayer(nn.Module):
    def __init__(self, seq_length: int, d_model: int, nhead: int, dim_feedforward: int,
                 *, dropout: float = 0.0, method: str = "permut_mix",
                 mix_impl: str = "folded", mix_block: int = 0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.mix_layer = make_mixer(method, embed_dim=d_model, seq_length=seq_length,
                                    num_heads=nhead, dropout=dropout, mix_impl=mix_impl,
                                    mix_block=mix_block, **kw)
        ln = dict(eps=1e-5, dtype=param_dtype, device=device)
        self.norm1 = LayerNorm(d_model, **ln)
        self.norm2 = LayerNorm(d_model, **ln)
        self.linear1 = SpectreLinear(d_model, dim_feedforward, **kw)
        self.linear3 = SpectreLinear(dim_feedforward, d_model, **kw)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(self.mix_layer(x)) + x
        ff = self.dropout(self.linear3(self.dropout(self.linear1(x))))
        return self.norm2(x + ff)


class SpectreEncoder(nn.Module):
    """Layers named ``layer_<i>`` as in the flax tree; global residual."""

    def __init__(self, num_layers: int, **layer_kw):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", SpectreEncoderLayer(**layer_kw))

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        out = src
        for i in range(self.num_layers):
            out = getattr(self, f"layer_{i}")(out)
        return out + src


class SpectreViT(nn.Module):
    def __init__(self, img_size: int = 32, patch_size: int = 4, in_channels: int = 3,
                 num_classes: int = 10, embed_dim: int = 768, num_encoders: int = 12,
                 num_heads: int = 12, hidden_dim: int = 3072, *, dropout: float = 0.1,
                 method: str = "permut_mix", mix_impl: str = "folded", mix_block: int = 0,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        num_patches = (img_size // patch_size) ** 2
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.dtype = dtype
        self.embeddings_block = SpectralPatchEmbed(embed_dim, patch_size, num_patches,
                                                   in_channels, dropout=dropout, **kw)
        self.encoder_blocks = SpectreEncoder(
            num_encoders, seq_length=num_patches + 1, d_model=embed_dim, nhead=num_heads,
            dim_feedforward=hidden_dim, dropout=dropout, method=method, mix_impl=mix_impl,
            mix_block=mix_block, **kw)
        self.mlp_head = SpectreLinear(embed_dim, num_classes, **kw)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """x: [B, C, H, W] -> logits [B, classes] in float32 (and the CLS
        features, float32, with ``return_features``)."""
        x = self.encoder_blocks(self.embeddings_block(x))
        cls_token = x[:, 0, :]
        logits = self.mlp_head(cls_token).float()
        if return_features:
            return logits, cls_token.float()
        return logits
