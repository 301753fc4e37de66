"""Kernel 2 (B3) in the distiller's step: the student's forward and backward
chain kernels over every SpectreLinear outside the mix, the least time the
traced steps' student shapes need (``portbench/roofline.py``) over these
kernels' device time. The teacher's products run on cuBLAS and are not
counted."""

from portbench.roofline import share


def read(record: dict):
    return share(record, "spectre_linear", "distill")
