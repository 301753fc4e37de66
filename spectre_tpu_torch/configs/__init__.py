"""Config system of the port: plain-Python config files (the port's own
copies of the JAX package's, in this directory), read by path with
child-wins ``_base_`` merging."""

import os

from spectre_tpu_torch.configs.parser import apply_overrides, config_to_dict, parse_config

CONFIG_DIR = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(CONFIG_DIR, "spectre_vit_cifar100.py")

__all__ = ["CONFIG_DIR", "FLAGSHIP", "apply_overrides", "config_to_dict", "parse_config"]
