"""Kernel 2 (B3): its forward and its backward chain kernel, over every
SpectreLinear outside the mix: the least time the traced train steps' shapes
need (``portbench/roofline.py``) over these kernels' device time."""

from portbench.roofline import share


def read(record: dict):
    return share(record, "spectre_linear")
