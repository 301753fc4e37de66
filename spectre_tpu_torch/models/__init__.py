"""Models of the port: SpectreViT with its pluggable mixers, SpectreBranch,
the baseline ViT, the layer library, the weight bridge from flax trees and the
importer of reference checkpoints."""

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
    TokenMajorMixLinear,
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
from spectre_tpu_torch.models.registry import (
    build_model,
    example_input,
    refresh_mixes,
    resolve_dtype,
)
from spectre_tpu_torch.models.spectre import SpectreEncoder, SpectreEncoderLayer, SpectreViT
from spectre_tpu_torch.models.spectre_branch import (
    Conv,
    SpectreBranch,
    SpectreBranchEncoder,
    SpectreBranchEncoderLayer,
    SpectreFeatExtractor,
    rfft2_log_magnitude_matmul,
)
from spectre_tpu_torch.models.torch_import import (
    import_spectre_branch,
    import_spectre_vit,
    import_vit,
    reference_state_dict,
)
from spectre_tpu_torch.models.vit import TransformerEncoderLayer, ViT

__all__ = [
    "MIXERS",
    "AttentionMixer",
    "BinaryLinear",
    "Conv",
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
    "SpectreBranch",
    "SpectreBranchEncoder",
    "SpectreBranchEncoderLayer",
    "SpectreFeatExtractor",
    "SpectralPatchEmbed",
    "SpectreEncoder",
    "SpectreEncoderLayer",
    "SpectreLinear",
    "SpectreViT",
    "TokenMajorMixLinear",
    "TransformerEncoderLayer",
    "ViT",
    "build_model",
    "example_input",
    "flax_state_dict",
    "import_spectre_branch",
    "import_spectre_vit",
    "import_vit",
    "load_flax_variables",
    "load_npz",
    "make_mixer",
    "reference_state_dict",
    "refresh_mixes",
    "resolve_dtype",
    "rfft2_log_magnitude_matmul",
    "save_npz",
]
