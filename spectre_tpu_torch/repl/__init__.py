"""Entry points of the port (``python -m spectre_tpu_torch.repl.<name>``)."""
