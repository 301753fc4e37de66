"""Baseline attention ViT (port of spectre_tpu/models/vit.py).

PatchEmbedding -> post-norm transformer encoder layers -> Dense CLS head.
The encoder layer has torch's default topology (norm_first=False):

    x = norm1(x + dropout(self_attn(x)))
    x = norm2(x + dropout(linear2(dropout(gelu(linear1(x))))))

Attention is over tokens, batch-first, through the hand-written attention
kernels (``models/mixers.py::AttentionMixer``). Module and parameter names
are the flax tree's: ``embeddings_block``, ``encoder_<i>``, ``mlp_head``.
"""

from __future__ import annotations

import torch
from torch import nn

from spectre_tpu_torch.models.layers import Dense, Dropout, LayerNorm
from spectre_tpu_torch.models.mixers import AttentionMixer
from spectre_tpu_torch.models.patch_embed import PatchEmbedding
from spectre_tpu_torch.ops import gelu_exact


class TransformerEncoderLayer(nn.Module):
    """Post-norm transformer encoder layer with torch's default topology."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float, *,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.self_attn = AttentionMixer(d_model, nhead, dropout=dropout, **kw)
        ln = dict(eps=1e-5, dtype=param_dtype, device=device)
        self.norm1 = LayerNorm(d_model, **ln)
        self.norm2 = LayerNorm(d_model, **ln)
        self.linear1 = Dense(d_model, dim_feedforward, **kw)
        self.linear2 = Dense(dim_feedforward, d_model, **kw)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.dropout(self.self_attn(x)))
        h = self.dropout(gelu_exact(self.linear1(x)))
        return self.norm2(x + self.dropout(self.linear2(h)))


class ViT(nn.Module):
    def __init__(self, img_size: int = 32, patch_size: int = 4, in_channels: int = 3,
                 num_classes: int = 10, embed_dim: int = 768, num_encoders: int = 12,
                 num_heads: int = 12, hidden_dim: int = 3072, *, dropout: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        num_patches = (img_size // patch_size) ** 2
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.dtype, self.num_encoders = dtype, num_encoders
        self.embeddings_block = PatchEmbedding(embed_dim, patch_size, num_patches, in_channels,
                                               dropout=dropout, **kw)
        for i in range(num_encoders):
            self.add_module(f"encoder_{i}", TransformerEncoderLayer(
                embed_dim, num_heads, hidden_dim, dropout, **kw))
        self.mlp_head = Dense(embed_dim, num_classes, **kw)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """x: [B, C, H, W] -> logits [B, classes] in float32 (and the CLS
        features, float32, with ``return_features``)."""
        x = self.embeddings_block(x)
        for i in range(self.num_encoders):
            x = getattr(self, f"encoder_{i}")(x)
        cls_token = x[:, 0, :]
        logits = self.mlp_head(cls_token).float()
        if return_features:
            return logits, cls_token.float()
        return logits
