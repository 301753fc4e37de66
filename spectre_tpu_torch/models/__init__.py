"""Models of the port: the SpectreViT serving path and its weight bridge."""

from spectre_tpu_torch.models.jax_import import load_flax_variables, load_npz, save_npz
from spectre_tpu_torch.models.layers import (
    FoldedMixLinear,
    LayerNorm,
    MHPermutMix,
    SpectreLinear,
)
from spectre_tpu_torch.models.patch_embed import SpectralPatchEmbed
from spectre_tpu_torch.models.registry import build_model, refresh_mixes, resolve_dtype
from spectre_tpu_torch.models.spectre import SpectreEncoder, SpectreEncoderLayer, SpectreViT

__all__ = [
    "FoldedMixLinear",
    "LayerNorm",
    "MHPermutMix",
    "SpectralPatchEmbed",
    "SpectreEncoder",
    "SpectreEncoderLayer",
    "SpectreLinear",
    "SpectreViT",
    "build_model",
    "load_flax_variables",
    "load_npz",
    "refresh_mixes",
    "resolve_dtype",
    "save_npz",
]
