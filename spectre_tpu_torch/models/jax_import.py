"""Weight bridge: load a flax variable tree (nested dicts of numpy arrays)
into the port's modules.

The port's module and parameter names mirror the flax tree, so a flax path
``params/encoder_blocks/layer_0/mix_layer/linear/kernel`` is the port's
``encoder_blocks.layer_0.mix_layer.linear.kernel``. Two renames apply:

- flax ``LayerNorm`` ``scale``/``bias`` -> ``nn.LayerNorm`` ``weight``/``bias``;
- ``buffers/.../mix_tables`` is a pair whose meaning depends on its owner:
  (perms int32 [H, d], signs f32 [1, H, d]) -> the ``perms`` and ``signs``
  buffers of a permutation mix, (tile_perms int32 [H, T], signs) -> the
  ``tile_perms`` and ``signs`` buffers of a structured mix
  (``impl="structured"``). Any other leaf of ``buffers`` keeps its name.

Kernels keep the flax layouts in the port ([in, out] for ``Dense``;
[E, H, D] for the attention's query/key/value and [H, D, E] for its out
projection; [kH, kW, I, O] for the convolutions of SpectreBranch's
feature extractor), so no array is transposed. Missing or extra keys and any shape mismatch raise. The mix
tables are copied, never resampled. The distillation teacher
(``distill/teacher.py``) carries the flax names too, so the variables of the
JAX package's ``DinoClassifier`` load into the port's as they are
(``backbone/block_<i>/attn/query/kernel`` [E, H, D], ``ls1_gamma``,
``decoder/kernel``, ...).

A JAX ``TrainState`` carries over as ``load_flax_variables(state.model,
{"params": jax_state.params, "buffers": jax_state.buffers})``: the port's
optimizer holds the same parameter tensors, and both optimizers start fresh.

``save_npz``/``load_npz`` store the same tree as one flat ``.npz`` (keys are
'/'-joined paths; the two mix tables get ``/0`` and ``/1``), so weights
trained by the JAX package can be served by the port without JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from spectre_tpu_torch.models.registry import refresh_mixes

_TABLES = "mix_tables"


def _walk(tree, path):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def flax_state_dict(model: torch.nn.Module, variables) -> dict[str, np.ndarray]:
    """Map a flax tree onto the port's ``state_dict`` names: {port name:
    leaf}. Any tree shaped like ``{'params': ...}`` maps, so a tree of JAX
    gradients can be held against ``named_parameters()`` by name."""
    out: dict[str, np.ndarray] = {}
    for collection in ("params", "buffers"):
        tree = variables.get(collection, {})
        for path, leaf in _walk(tree, ()):
            *mods, name = path
            prefix = ".".join(mods) + ("." if mods else "")
            owner = model.get_submodule(".".join(mods)) if mods else model
            if collection == "buffers" and name == _TABLES:
                if len(leaf) != 2:
                    raise KeyError(f"unexpected buffer {'/'.join(path)}")
                table = "tile_perms" if getattr(owner, "impl", None) == "structured" \
                    else "perms"
                out[prefix + table], out[prefix + "signs"] = leaf
                continue
            if isinstance(owner, torch.nn.LayerNorm) and name == "scale":
                name = "weight"
            out[prefix + name] = leaf
    return out


@torch.no_grad()
def load_flax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy a flax variable tree ({'params': ..., 'buffers': ...}, numpy
    leaves) into ``model`` in place and derive its mix tables. Raises on
    missing or extra keys and on shape mismatches."""
    try:
        arrays = flax_state_dict(model, variables)
    except AttributeError as e:  # get_submodule on a path the port lacks
        raise KeyError(f"flax tree does not match the model: {e}") from None
    state = model.state_dict()
    missing = sorted(set(state) - set(arrays))
    extra = sorted(set(arrays) - set(state))
    if missing or extra:
        raise KeyError(f"flax tree does not match the model: missing {missing}, "
                       f"extra {extra}")
    for name, dst in state.items():
        src = np.asarray(arrays[name])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: flax shape {src.shape} != port shape "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.tensor(src, dtype=dst.dtype))
    refresh_mixes(model)
    return model


def save_npz(path: str, variables) -> None:
    """Write a flax variable tree (numpy leaves) as one flat ``.npz``."""
    flat = {}
    for path_, leaf in _walk(variables, ()):
        key = "/".join(path_)
        if isinstance(leaf, (tuple, list)):
            for i, part in enumerate(leaf):
                flat[f"{key}/{i}"] = np.asarray(part)
        else:
            flat[key] = np.asarray(leaf)
    np.savez(path, **flat)


def load_npz(path: str) -> dict:
    """Read a ``save_npz`` file back into the nested flax tree."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *mods, leaf = key.split("/")
            if mods and mods[-1] == _TABLES:
                node = tree
                for m in mods[:-1]:
                    node = node.setdefault(m, {})
                parts = node.setdefault(_TABLES, [None, None])
                parts[int(leaf)] = z[key]
                continue
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[key]
    return tree
