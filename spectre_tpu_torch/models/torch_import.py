"""Import a reference PyTorch checkpoint into the port's modules (the port's
counterpart of spectre_tpu/models/torch_import.py).

The reference (Biblbrox/ViT-Spectre-Experiments) saves ``model.state_dict()``
of ``SpectreViT``, ``ViT`` or ``SpectreBranch``, for example as
``model_best.pt``. Each function here takes that mapping ({reference key:
tensor or numpy array}, such as ``torch.load(path, weights_only=True)``),
lays every tensor out as the JAX importer does, and fills the port's model
through the weight bridge (``models/jax_import.py::load_flax_variables``),
whose module and parameter names are the flax tree's:

- ``nn.Linear.weight`` [out, in]      -> ``kernel`` [in, out]
- ``nn.LayerNorm.weight/bias``        -> ``scale``/``bias``
- ``nn.Conv2d.weight`` [O, I, kH, kW] -> ``kernel`` [kH, kW, I, O]
- the conv patchify [E, C, P, P]      -> the patchify product's kernel
  [C*P*P, E]
- ``nn.MultiheadAttention.in_proj_weight`` [3E, E] -> per-head query, key
  and value kernels [E, H, D]
- SpectreLinear ``local_head.{0,1}``  -> ``kernel``, ``bias``,
  ``ln_scale``, ``ln_bias``
- MHPermutMix ``perms``/``signs``     -> the mix's ``perms``/``signs``

A missing key, a key no rule reads, and any shape mismatch raise. The one
exception is SpectreBranch: the reference's encoder layer builds a
``mix_layer`` whose call is commented out, so its dead weights
(``encoder_blocks.layers.<i>.mix_layer.*``) are dropped, as the JAX importer
drops them.

``reference_state_dict(model)`` is the inverse: the port model's weights
under the reference's keys and layouts, which the importers read back
exactly (and a reference model could load).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from spectre_tpu_torch.models.jax_import import load_flax_variables


class _Keys:
    """The reference ``state_dict`` as numpy arrays, recording which keys
    were read."""

    def __init__(self, sd: Mapping):
        self.arrays = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v) for k, v in sd.items()}
        self.read: set[str] = set()

    def __getitem__(self, key: str) -> np.ndarray:
        if key not in self.arrays:
            raise KeyError(f"reference state_dict has no {key!r}")
        self.read.add(key)
        return self.arrays[key]

    def check_all_read(self, dropped: str | None = None) -> None:
        extra = sorted(k for k in set(self.arrays) - self.read
                       if dropped is None or not _is_dropped(k, dropped))
        if extra:
            raise KeyError(f"reference state_dict keys no rule reads: {extra}")


def _is_dropped(key: str, pattern: str) -> bool:
    parts = key.split(".")
    return len(parts) > 4 and ".".join(parts[:2]) == pattern and parts[3] == "mix_layer"


def _t(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.T)


def _dense(sd: _Keys, prefix: str) -> dict:
    return {"kernel": _t(sd[f"{prefix}.weight"]), "bias": sd[f"{prefix}.bias"]}


def _layer_norm(sd: _Keys, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _spectre_linear(sd: _Keys, prefix: str) -> dict:
    """local_head = Sequential(Linear, LayerNorm, GELU)."""
    return {"kernel": _t(sd[f"{prefix}.local_head.0.weight"]),
            "bias": sd[f"{prefix}.local_head.0.bias"],
            "ln_scale": sd[f"{prefix}.local_head.1.weight"],
            "ln_bias": sd[f"{prefix}.local_head.1.bias"]}


def _conv2d(sd: _Keys, prefix: str) -> dict:
    return {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)),
            "bias": sd[f"{prefix}.bias"]}


def _patch_embedding(sd: _Keys, prefix: str) -> dict:
    w = sd[f"{prefix}.patcher.0.weight"]  # [E, C, P, P]
    return {"patcher": {"kernel": _t(w.reshape(w.shape[0], -1)),
                        "bias": sd[f"{prefix}.patcher.0.bias"]},
            "cls_token": sd[f"{prefix}.cls_token"],
            "position_embeddings": sd[f"{prefix}.position_embeddings"]}


def _mix_tables(sd: _Keys, prefix: str) -> tuple:
    """perms [H, d] (int64 in the reference) -> int32; signs [1, H, d]."""
    return (sd[f"{prefix}.perms"].astype(np.int32), sd[f"{prefix}.signs"].astype(np.float32))


def _mhsa(sd: _Keys, prefix: str, num_heads: int) -> dict:
    w, b = sd[f"{prefix}.in_proj_weight"], sd[f"{prefix}.in_proj_bias"]  # [3E, E], [3E]
    e = w.shape[1]
    dh = e // num_heads
    out = {name: {"kernel": _t(w[i * e:(i + 1) * e]).reshape(e, num_heads, dh),
                  "bias": b[i * e:(i + 1) * e].reshape(num_heads, dh)}
           for i, name in enumerate(("query", "key", "value"))}
    out["out"] = {"kernel": _t(sd[f"{prefix}.out_proj.weight"]).reshape(num_heads, dh, e),
                  "bias": sd[f"{prefix}.out_proj.bias"]}
    return out


def import_spectre_vit(model: torch.nn.Module, sd: Mapping) -> torch.nn.Module:
    """Reference SpectreViT ``state_dict`` (method ``permut_mix``) -> the
    port's SpectreViT, in place (any mix impl but ``structured``, whose
    tables the reference does not have)."""
    keys = _Keys(sd)
    params = {
        "embeddings_block": {
            "freq_weight_h": keys["embeddings_block.freq_weight_h"],
            "freq_weight_w": keys["embeddings_block.freq_weight_w"],
            "proj_kernel": _t(keys["embeddings_block.proj.weight"]),
            "proj_bias": keys["embeddings_block.proj.bias"],
            "cls_token": keys["embeddings_block.cls_token"],
            "position_embeddings": keys["embeddings_block.position_embeddings"],
        },
        "encoder_blocks": {},
        "mlp_head": _spectre_linear(keys, "mlp_head.0"),
    }
    buffers = {"encoder_blocks": {}}
    for i in range(model.encoder_blocks.num_layers):
        t = f"encoder_blocks.layers.{i}"
        params["encoder_blocks"][f"layer_{i}"] = {
            "mix_layer": {"linear": _spectre_linear(keys, f"{t}.mix_layer.linear")},
            "linear1": _spectre_linear(keys, f"{t}.linear1"),
            "linear3": _spectre_linear(keys, f"{t}.linear3"),
            "norm1": _layer_norm(keys, f"{t}.norm1"),
            "norm2": _layer_norm(keys, f"{t}.norm2"),
        }
        buffers["encoder_blocks"][f"layer_{i}"] = {
            "mix_layer": {"mix_tables": _mix_tables(keys, f"{t}.mix_layer")}}
    keys.check_all_read()
    return load_flax_variables(model, {"params": params, "buffers": buffers})


def import_vit(model: torch.nn.Module, sd: Mapping) -> torch.nn.Module:
    """Reference ViT ``state_dict`` -> the port's ViT, in place."""
    keys = _Keys(sd)
    num_heads = model.encoder_0.self_attn.mhsa.query.kernel.shape[1]
    params = {"embeddings_block": _patch_embedding(keys, "embeddings_block"),
              "mlp_head": _dense(keys, "mlp_head.0")}
    for i in range(model.num_encoders):
        t = f"encoder_blocks.layers.{i}"
        params[f"encoder_{i}"] = {
            "self_attn": {"mhsa": _mhsa(keys, f"{t}.self_attn", num_heads)},
            "linear1": _dense(keys, f"{t}.linear1"),
            "linear2": _dense(keys, f"{t}.linear2"),
            "norm1": _layer_norm(keys, f"{t}.norm1"),
            "norm2": _layer_norm(keys, f"{t}.norm2"),
        }
    keys.check_all_read()
    return load_flax_variables(model, {"params": params})


def import_spectre_branch(model: torch.nn.Module, sd: Mapping) -> torch.nn.Module:
    """Reference SpectreBranch ``state_dict`` (method ``none``) -> the port's
    SpectreBranch, in place; the dead ``mix_layer`` weights are dropped."""
    keys = _Keys(sd)
    enc = {"spectre_branch": {}}
    for i in range(model.encoder_blocks.num_layers):
        t = f"encoder_blocks.layers.{i}"
        enc[f"layer_{i}"] = {
            "linear1": _dense(keys, f"{t}.linear1"),
            "linear2": _dense(keys, f"{t}.linear2"),
            "linear3": _dense(keys, f"{t}.linear3"),
            "norm1": _layer_norm(keys, f"{t}.norm1"),
            "norm2": _layer_norm(keys, f"{t}.norm2"),
        }
        enc["spectre_branch"][f"stage_{i}"] = _conv2d(
            keys, f"encoder_blocks.spectre_branch.net.{i}.0")
        enc["spectre_branch"][f"project_{i}"] = _conv2d(
            keys, f"encoder_blocks.spectre_branch.project.{i}.0")
        enc[f"spectre_project_{i}"] = _dense(keys, f"encoder_blocks.spectre_project.{i}")
    params = {"embeddings_block": _patch_embedding(keys, "embeddings_block"),
              "encoder_blocks": enc, "mlp_head": _dense(keys, "mlp_head.0")}
    keys.check_all_read(dropped="encoder_blocks.layers")
    return load_flax_variables(model, {"params": params})


def _linear_sd(st: dict, src: str, dst: str) -> dict:
    return {f"{dst}.weight": st[f"{src}.kernel"].t(), f"{dst}.bias": st[f"{src}.bias"]}


def _norm_sd(st: dict, src: str, dst: str) -> dict:
    return {f"{dst}.weight": st[f"{src}.weight"], f"{dst}.bias": st[f"{src}.bias"]}


def _spectre_linear_sd(st: dict, src: str, dst: str) -> dict:
    return {f"{dst}.local_head.0.weight": st[f"{src}.kernel"].t(),
            f"{dst}.local_head.0.bias": st[f"{src}.bias"],
            f"{dst}.local_head.1.weight": st[f"{src}.ln_scale"],
            f"{dst}.local_head.1.bias": st[f"{src}.ln_bias"]}


def _conv_sd(st: dict, src: str, dst: str) -> dict:
    return {f"{dst}.weight": st[f"{src}.kernel"].permute(3, 2, 0, 1),
            f"{dst}.bias": st[f"{src}.bias"]}


def _patch_embedding_sd(model, st: dict) -> dict:
    p = model.embeddings_block.patch_size
    w = st["embeddings_block.patcher.kernel"]  # [C*P*P, E]
    return {"embeddings_block.patcher.0.weight": w.t().reshape(w.shape[1], -1, p, p),
            "embeddings_block.patcher.0.bias": st["embeddings_block.patcher.bias"],
            "embeddings_block.cls_token": st["embeddings_block.cls_token"],
            "embeddings_block.position_embeddings": st["embeddings_block.position_embeddings"]}


def reference_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The weights of a port SpectreViT (permutation mix, not structured),
    ViT or SpectreBranch (method ``none``) under the reference's keys and
    layouts, as contiguous tensors on the model's device (the mix tables'
    ``perms`` int64, as the reference keeps them)."""
    from spectre_tpu_torch.models.spectre import SpectreViT
    from spectre_tpu_torch.models.spectre_branch import SpectreBranch
    from spectre_tpu_torch.models.vit import ViT

    st = {k: v.detach() for k, v in model.state_dict().items()}
    sd: dict[str, torch.Tensor] = {}
    if isinstance(model, SpectreViT):
        eb = "embeddings_block"
        sd.update({f"{eb}.{k}": st[f"{eb}.{k}"] for k in (
            "freq_weight_h", "freq_weight_w", "cls_token", "position_embeddings")})
        sd[f"{eb}.proj.weight"] = st[f"{eb}.proj_kernel"].t()
        sd[f"{eb}.proj.bias"] = st[f"{eb}.proj_bias"]
        for i in range(model.encoder_blocks.num_layers):
            src, dst = f"encoder_blocks.layer_{i}", f"encoder_blocks.layers.{i}"
            for name in ("mix_layer.linear", "linear1", "linear3"):
                sd.update(_spectre_linear_sd(st, f"{src}.{name}", f"{dst}.{name}"))
            for name in ("norm1", "norm2"):
                sd.update(_norm_sd(st, f"{src}.{name}", f"{dst}.{name}"))
            sd[f"{dst}.mix_layer.perms"] = st[f"{src}.mix_layer.perms"].long()
            sd[f"{dst}.mix_layer.signs"] = st[f"{src}.mix_layer.signs"]
        sd.update(_spectre_linear_sd(st, "mlp_head", "mlp_head.0"))
    elif isinstance(model, ViT):
        sd.update(_patch_embedding_sd(model, st))
        for i in range(model.num_encoders):
            src, dst = f"encoder_{i}", f"encoder_blocks.layers.{i}"
            att, e = f"{src}.self_attn.mhsa", st[f"{src}.norm1.weight"].shape[0]
            sd[f"{dst}.self_attn.in_proj_weight"] = torch.cat(
                [st[f"{att}.{n}.kernel"].reshape(e, e).t() for n in ("query", "key", "value")])
            sd[f"{dst}.self_attn.in_proj_bias"] = torch.cat(
                [st[f"{att}.{n}.bias"].reshape(e) for n in ("query", "key", "value")])
            sd[f"{dst}.self_attn.out_proj.weight"] = st[f"{att}.out.kernel"].reshape(e, e).t()
            sd[f"{dst}.self_attn.out_proj.bias"] = st[f"{att}.out.bias"]
            for name in ("linear1", "linear2"):
                sd.update(_linear_sd(st, f"{src}.{name}", f"{dst}.{name}"))
            for name in ("norm1", "norm2"):
                sd.update(_norm_sd(st, f"{src}.{name}", f"{dst}.{name}"))
        sd.update(_linear_sd(st, "mlp_head", "mlp_head.0"))
    elif isinstance(model, SpectreBranch):
        sd.update(_patch_embedding_sd(model, st))
        enc = "encoder_blocks"
        for i in range(model.encoder_blocks.num_layers):
            src, dst = f"{enc}.layer_{i}", f"{enc}.layers.{i}"
            for name in ("linear1", "linear2", "linear3"):
                sd.update(_linear_sd(st, f"{src}.{name}", f"{dst}.{name}"))
            for name in ("norm1", "norm2"):
                sd.update(_norm_sd(st, f"{src}.{name}", f"{dst}.{name}"))
            sd.update(_conv_sd(st, f"{enc}.spectre_branch.stage_{i}",
                               f"{enc}.spectre_branch.net.{i}.0"))
            sd.update(_conv_sd(st, f"{enc}.spectre_branch.project_{i}",
                               f"{enc}.spectre_branch.project.{i}.0"))
            sd.update(_linear_sd(st, f"{enc}.spectre_project_{i}", f"{enc}.spectre_project.{i}"))
        sd.update(_linear_sd(st, "mlp_head", "mlp_head.0"))
    else:
        raise TypeError(f"no reference layout for {type(model).__name__}")
    return {k: v.contiguous() for k, v in sd.items()}
