"""The ``.stw`` weights container of the native runner and daemon (the port's
copy of spectre_tpu/export/weights.py, byte for byte the same format).

A self-describing little-endian container of named tensors:

    magic  "STW1"
    u32    n_tensors
    per tensor, names sorted:
        u32 name_len | name bytes (utf-8)
        u32 dtype    (0 = f32, 1 = i32)
        u32 ndim | u32 dims[ndim]
        raw data (little-endian, C order)

bool is written as i32, any other float as f32 and any other integer as
i32. The names are the JAX package's flattened flax names,
``params.<path>`` and ``buffers.<path>``: the port's ``state_dict`` names
mapped back through the renames of ``models/jax_import.py`` (a LayerNorm's
``weight`` is ``scale``; a mix's ``perms`` or ``tile_perms`` and ``signs``
are ``mix_tables.0`` and ``mix_tables.1``). So the JAX package, the port and
``native/`` read each other's files.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_MAGIC = b"STW1"
_DTYPES = {0: np.float32, 1: np.int32}
_CODES = {np.dtype(np.float32): 0, np.dtype(np.int32): 1}
_TABLES = {"perms": "mix_tables.0", "tile_perms": "mix_tables.0", "signs": "mix_tables.1"}


def stw_names(model: torch.nn.Module) -> dict[str, str]:
    """{``.stw`` name: the port's ``state_dict`` name} of every tensor of
    ``model``'s state."""
    params = {name for name, _ in model.named_parameters()}
    out = {}
    for name in model.state_dict():
        *mods, leaf = name.split(".")
        owner = model.get_submodule(".".join(mods))
        if name in params:
            if isinstance(owner, torch.nn.LayerNorm) and leaf == "weight":
                leaf = "scale"
            collection = "params"
        else:
            if leaf in _TABLES and hasattr(owner, "signs"):
                leaf = _TABLES[leaf]
            collection = "buffers"
        out[".".join([collection, *mods, leaf])] = name
    return out


def _as_stored(t: torch.Tensor) -> np.ndarray:
    arr = t.detach().cpu()
    if arr.dtype == torch.bool or not arr.is_floating_point():
        return arr.to(torch.int32).numpy()
    return arr.to(torch.float32).numpy()


def write_stw(flat: dict[str, np.ndarray], path: str) -> str:
    """Write {name: array} (f32 or i32) as ``.stw``, names sorted."""
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(flat)))
        for name in sorted(flat):
            arr = np.ascontiguousarray(flat[name])
            nb = name.encode()
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<I", _CODES[arr.dtype]))
            f.write(struct.pack("<I", arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}I", *arr.shape))
            f.write(arr.tobytes())
    return path


def save_stw(model: torch.nn.Module, path: str) -> str:
    """Write ``model``'s parameters and buffers as ``.stw`` under the JAX
    names."""
    state = model.state_dict()
    return write_stw({stw: _as_stored(state[name])
                      for stw, name in stw_names(model).items()}, path)


def load_stw(path: str) -> dict[str, np.ndarray]:
    """Read a ``.stw`` file: {name: f32 or i32 array}."""
    out = {}
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not a .stw file (bad magic)")
        (n,) = struct.unpack("<I", f.read(4))
        for _ in range(n):
            (nl,) = struct.unpack("<I", f.read(4))
            name = f.read(nl).decode()
            code, ndim = struct.unpack("<II", f.read(8))
            dims = struct.unpack(f"<{ndim}I", f.read(4 * ndim)) if ndim else ()
            dtype = np.dtype(_DTYPES[code])
            count = int(np.prod(dims)) if dims else 1
            out[name] = np.frombuffer(f.read(count * dtype.itemsize), dtype).reshape(dims)
    return out


@torch.no_grad()
def load_stw_into(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Copy a ``.stw`` file into ``model`` in place, each tensor cast to its
    destination's dtype, and derive its mix tables. Raises on a missing, extra
    or mis-shaped tensor."""
    from spectre_tpu_torch.models.registry import refresh_mixes

    flat = load_stw(path)
    names = stw_names(model)
    missing, extra = sorted(set(names) - set(flat)), sorted(set(flat) - set(names))
    if missing or extra:
        raise KeyError(f"{path} does not match the model: missing {missing}, extra {extra}")
    state = model.state_dict()
    for stw, name in names.items():
        src, dst = flat[stw], state[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{stw}: .stw shape {src.shape} != port shape {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(src.copy()).to(dst.dtype))
    refresh_mixes(model)
    return model
