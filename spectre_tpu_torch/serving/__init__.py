"""Serving of the port: the SPQ2/SPQ3 client and the torch-backed server."""

from spectre_tpu_torch.serving.client import SpectreClient
from spectre_tpu_torch.serving.torch_server import TorchServer, from_config

__all__ = ["SpectreClient", "TorchServer", "from_config"]
