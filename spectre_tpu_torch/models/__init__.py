"""Models of the port: SpectreViT and its weight bridge."""

from spectre_tpu_torch.models.jax_import import (
    flax_state_dict,
    load_flax_variables,
    load_npz,
    save_npz,
)
from spectre_tpu_torch.models.layers import (
    Dropout,
    FoldedMixLinear,
    LayerNorm,
    MHPermutMix,
    SpectreLinear,
)
from spectre_tpu_torch.models.patch_embed import SpectralPatchEmbed
from spectre_tpu_torch.models.registry import build_model, refresh_mixes, resolve_dtype
from spectre_tpu_torch.models.spectre import SpectreEncoder, SpectreEncoderLayer, SpectreViT

__all__ = [
    "Dropout",
    "FoldedMixLinear",
    "LayerNorm",
    "MHPermutMix",
    "SpectralPatchEmbed",
    "SpectreEncoder",
    "SpectreEncoderLayer",
    "SpectreLinear",
    "SpectreViT",
    "build_model",
    "flax_state_dict",
    "load_flax_variables",
    "load_npz",
    "refresh_mixes",
    "resolve_dtype",
    "save_npz",
]
