"""Build the configured model (port of spectre_tpu/models/registry.py)."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from spectre_tpu_torch.models.init import init_weights
from spectre_tpu_torch.models.layers import MHPermutMix
from spectre_tpu_torch.models.spectre import SpectreViT
from spectre_tpu_torch.models.spectre_branch import SpectreBranch
from spectre_tpu_torch.models.vit import ViT

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name: str) -> torch.dtype:
    """Config dtype string (``compute_dtype`` / ``param_dtype``) -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown dtype name {name!r}; expected one of {sorted(_DTYPES)}") from None


def refresh_mixes(model: torch.nn.Module) -> None:
    """Derive what every mix layer's forward needs from its current buffers
    now (the folded mix's block tables and sign weights, the structured
    mix's inverse tile table), validating the tables and sparing the first
    forward the work."""
    for m in model.modules():
        if isinstance(m, MHPermutMix):
            m.refresh(force=True)


def build_model(config: SimpleNamespace, device: torch.device | str,
                train: bool = False) -> torch.nn.Module:
    """Instantiate the configured model on ``device``, with the port's own
    init drawn from ``torch.Generator`` seeded with ``config.random_seed``.
    Eval mode unless ``train``: the serving callers never see dropout."""
    name = getattr(config, "model", "spectre_vit")
    common = dict(
        img_size=config.img_size, patch_size=config.patch_size,
        in_channels=config.in_channels, num_classes=config.num_classes,
        embed_dim=config.embed_dim, num_encoders=config.num_encoders,
        num_heads=config.num_heads, hidden_dim=config.hidden_dim,
        dropout=float(getattr(config, "dropout", 0.0)),
        dtype=resolve_dtype(getattr(config, "compute_dtype", "float32")),
        param_dtype=resolve_dtype(getattr(config, "param_dtype", "float32")),
        device=device)
    mix = dict(method=getattr(config, "method", "permut_mix"),
               mix_impl=getattr(config, "mix_impl", "gather"),
               mix_block=int(getattr(config, "mix_block", 0)))
    if name == "vit":
        model = ViT(**common)
    elif name == "spectre_vit":
        model = SpectreViT(**mix, **common)
    elif name == "spectre_branch":
        model = SpectreBranch(**mix, **common)
    else:
        raise ValueError(f"unknown model {name!r}; expected vit|spectre_vit|spectre_branch")
    gen = torch.Generator().manual_seed(int(getattr(config, "random_seed", 42)))
    init_weights(model, gen)
    model.train(train)
    refresh_mixes(model)
    return model


def example_input(config: SimpleNamespace, batch_size: int | None = None,
                  device: torch.device | str = "cuda") -> torch.Tensor:
    """A zero float32 batch of the configured input shape on ``device``
    (``config.batch_size`` images unless ``batch_size``); the model casts it
    to its compute dtype."""
    b = batch_size or config.batch_size
    return torch.zeros(b, config.in_channels, config.img_size, config.img_size,
                       device=device)
