"""Serving of the port: the SPQ2/SPQ3 client, the torch-backed server and the
native daemon's launcher."""

from spectre_tpu_torch.serving.client import SpectreClient, start_server
from spectre_tpu_torch.serving.torch_server import TorchServer, from_config

__all__ = ["SpectreClient", "TorchServer", "from_config", "start_server"]
