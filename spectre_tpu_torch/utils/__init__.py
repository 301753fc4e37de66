"""Utilities of the port: the metrics writer, the experiment name and the
card's name and power limit."""

import subprocess

from spectre_tpu_torch.utils.metrics import MetricsWriter, experiment_name


def card_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them; every
    measurement is written down beside this line."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


__all__ = ["MetricsWriter", "card_and_power_limit", "experiment_name"]
