"""Python-module config system (port of spectre_tpu/configs/parser.py).

A config is a plain Python file of top-level constants; ``parse_config(path)``
returns a ``SimpleNamespace``. Base configs are declared with ``_base_`` (or
``__base__``), as a string or a list of strings relative to the child's
directory, and the child always wins the merge. Configs are loaded by file
path (exec'd). The port's own config files stand beside this module; the
JAX package's files parse to the same namespaces (a test holds them equal).
"""

from __future__ import annotations

import ast
import os
from types import SimpleNamespace
from typing import Any

_BASE_KEYS = ("__base__", "_base_")


def _exec_config_file(path: str) -> dict[str, Any]:
    path = os.path.abspath(path)
    if not path.endswith(".py"):
        path += ".py"
    with open(path, "r") as f:
        src = f.read()
    namespace: dict[str, Any] = {"__file__": path, "__name__": "__config__"}
    exec(compile(src, path, "exec"), namespace)
    return namespace


def module_to_dict(namespace: dict[str, Any]) -> dict[str, Any]:
    """Keep non-underscore top-level names, plus the base-inheritance keys."""
    return {k: v for k, v in namespace.items()
            if not k.startswith("_") or k in _BASE_KEYS}


def _load_config_dict(path: str, _seen: frozenset[str] = frozenset()) -> dict[str, Any]:
    abspath = os.path.abspath(path if path.endswith(".py") else path + ".py")
    if abspath in _seen:
        raise ValueError(f"circular config inheritance at {abspath}")
    cfg = module_to_dict(_exec_config_file(abspath))

    bases: list[str] = []
    for key in _BASE_KEYS:
        declared = cfg.pop(key, None)
        if declared is None:
            continue
        if isinstance(declared, str):
            declared = [declared]
        bases.extend(declared)

    merged: dict[str, Any] = {}
    cfg_dir = os.path.dirname(abspath)
    for base in bases:
        merged.update(_load_config_dict(os.path.join(cfg_dir, base), _seen | {abspath}))
    merged.update(cfg)  # child wins
    return merged


def parse_config(config_path: str) -> SimpleNamespace:
    """Load a python config file (with base inheritance) into a namespace."""
    return SimpleNamespace(**_load_config_dict(config_path))


def config_to_dict(config: SimpleNamespace) -> dict[str, Any]:
    """The config's fields as a plain dict (a copy)."""
    return dict(vars(config))


def apply_overrides(config: SimpleNamespace, pairs: list[str]) -> SimpleNamespace:
    """Apply ``key=value`` overrides; values parse as Python literals, else
    stay strings (the JAX CLIs' ``--set`` semantics)."""
    for pair in pairs:
        key, _, raw = pair.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        setattr(config, key.strip(), value)
    return config
