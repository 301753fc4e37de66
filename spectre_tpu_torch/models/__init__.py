"""Models of the port: SpectreViT with its pluggable mixers, the baseline
ViT, the layer library and the weight bridge."""

from spectre_tpu_torch.models.jax_import import (
    flax_state_dict,
    load_flax_variables,
    load_npz,
    save_npz,
)
from spectre_tpu_torch.models.layers import (
    BinaryLinear,
    Dense,
    Dropout,
    FFTApproximator,
    FFTLayer,
    FoldedMixLinear,
    LayerNorm,
    LearnableHadamard,
    LearnedSigmoid,
    MHPermutMix,
    NormalMask,
    SignPermuteMix,
    SpectreLinear,
)
from spectre_tpu_torch.models.mixers import (
    MIXERS,
    AttentionMixer,
    DWTMixer,
    FNetMixer,
    MHFFTMixer,
    make_mixer,
)
from spectre_tpu_torch.models.patch_embed import PatchEmbedding, SpectralPatchEmbed
from spectre_tpu_torch.models.registry import build_model, refresh_mixes, resolve_dtype
from spectre_tpu_torch.models.spectre import SpectreEncoder, SpectreEncoderLayer, SpectreViT
from spectre_tpu_torch.models.vit import TransformerEncoderLayer, ViT

__all__ = [
    "MIXERS",
    "AttentionMixer",
    "BinaryLinear",
    "DWTMixer",
    "Dense",
    "Dropout",
    "FFTApproximator",
    "FFTLayer",
    "FNetMixer",
    "FoldedMixLinear",
    "LayerNorm",
    "LearnableHadamard",
    "LearnedSigmoid",
    "MHFFTMixer",
    "MHPermutMix",
    "NormalMask",
    "PatchEmbedding",
    "SignPermuteMix",
    "SpectralPatchEmbed",
    "SpectreEncoder",
    "SpectreEncoderLayer",
    "SpectreLinear",
    "SpectreViT",
    "TransformerEncoderLayer",
    "ViT",
    "build_model",
    "flax_state_dict",
    "load_flax_variables",
    "load_npz",
    "make_mixer",
    "refresh_mixes",
    "resolve_dtype",
    "save_npz",
]
