"""Config system of the port: the same plain-Python config files as
``spectre_tpu/configs/``, read by path with child-wins ``_base_`` merging."""

from spectre_tpu_torch.configs.parser import apply_overrides, parse_config

__all__ = ["apply_overrides", "parse_config"]
