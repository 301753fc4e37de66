"""Utilities of the port: the metrics writer, the experiment name, the
card's name and power limit, the debugging switches and the model summary."""

import subprocess

import torch

from spectre_tpu_torch.utils.debug import check_finite, deterministic_mode, enable_nan_checks
from spectre_tpu_torch.utils.metrics import MetricsWriter, experiment_name
from spectre_tpu_torch.utils.summary import format_summary, model_summary


def cli_device(name: str) -> torch.device:
    """The device a CLI's ``--device`` names; a CUDA device without a card
    raises (a command line runs on the card unless it asks for the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} asked, but torch.cuda.is_available() is False; "
                           "pass --device cpu to run on the CPU")
    return device


def card_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them; every
    measurement is written down beside this line."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


__all__ = ["MetricsWriter", "card_and_power_limit", "check_finite", "cli_device", "deterministic_mode",
           "enable_nan_checks", "experiment_name", "format_summary", "model_summary"]
